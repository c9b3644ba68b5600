"""k3_roofline.throughput: K3's least time on the prompts each prefill carried over its stage kernels' device time, % (kernels/csrc/ssd.cu)."""
from cascade_bench import readers


def read(run):
    return readers.k3_roofline(run)
