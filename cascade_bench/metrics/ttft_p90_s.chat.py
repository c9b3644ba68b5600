"""ttft_p90_s.chat: p90 over every request due in the window of due -> first token (-> the window's end without one), s (admission: serving/scheduler.py, serving/kvcache.py)."""
from cascade_bench import readers


def read(run):
    return readers.p90(readers.ttfts(run))
