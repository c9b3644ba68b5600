"""k1_roofline.throughput: K1's least time on the lengths each tick carried over its kernels' device time, % (kernels/csrc/ragged_paged_attention.cu)."""
from cascade_bench import readers


def read(run):
    return readers.k1_roofline(run)
