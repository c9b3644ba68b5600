"""tpot_p50_s: median over the requests with two tokens or more in the window of (last - first token) / (tokens - 1), s."""
import statistics

from cascade_bench import readers


def read(run):
    gaps = readers.tpots(run)
    return statistics.median(gaps) if gaps else None
