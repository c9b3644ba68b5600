"""tpot_p90_s.chat: p90 of (last - first token) / (tokens - 1) over the requests with two tokens or more in the window, s (engine tick: serving/engine.py)."""
from cascade_bench import readers


def read(run):
    return readers.p90(readers.tpots(run))
