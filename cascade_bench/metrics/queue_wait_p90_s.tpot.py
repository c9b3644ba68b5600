"""queue_wait_p90_s.tpot: p90 over the requests due in the window of due -> the end of the first tick after which the engine had issued it a slot, s (admission: serving/scheduler.py, serving/kvcache.py)."""
from cascade_bench import readers


def read(run):
    return readers.p90(readers.queue_waits(run))
