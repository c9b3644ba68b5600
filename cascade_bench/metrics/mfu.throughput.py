"""mfu.throughput: logical FLOPs of every tick of the window over the window and the bf16 peak, %."""
from cascade_bench import readers


def read(run):
    return readers.mfu(run, range(len(run.ticks)), run.end - run.start)
