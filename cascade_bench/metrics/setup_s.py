"""setup_s: process start to the window's start, on the host clock."""
from cascade_bench import readers


def read(run):
    return run.setup_s
