"""idle_share.throughput: share of the traced window with no operation on the device, %."""
from cascade_bench import readers


def read(run):
    return readers.idle_share(run)
