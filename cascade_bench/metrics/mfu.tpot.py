"""mfu.tpot: logical FLOPs of the ticks that dispatched over their summed wall time and the bf16 peak, %."""
from cascade_bench import readers


def read(run):
    ticks = readers.dispatched(run)
    return readers.mfu(run, ticks, readers.tick_seconds(run, ticks))
