"""tick_period_ms.tpot: wall time of the ticks that dispatched over their count, ms (serving/engine.py)."""
from cascade_bench import readers


def read(run):
    ticks = readers.dispatched(run)
    return 1e3 * readers.tick_seconds(run, ticks) / len(ticks) if ticks else None
