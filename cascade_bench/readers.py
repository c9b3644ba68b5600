"""Arithmetic that several metric readers share (``metrics/<name>.py``
each call one of these on the run's records)."""
from __future__ import annotations

import statistics

from . import work

# K1's kernels by name in a trace: the tensor-core kernel and its plan,
# the span kernels and the combine
K1_KERNELS = ("ragged_tc_kernel", "ragged_tc_plan_kernel",
              "ragged_span_kernel", "ragged_wide_kernel",
              "ragged_combine_kernel")
# K3's stage kernels (bf16) and its f32 kernel
K3_KERNELS = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
              "ssd_scan_kernel", "ssd_fma_kernel")


def p90(values: list) -> float | None:
    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def ttfts(run) -> list:
    """Every request due in the window: due to its first token, or to the
    window's end if it has none (a refused one too)."""
    return [(run.tick_end(r.token_ticks[0]) if r.token_ticks else run.end)
            - r.due for r in run.records]


def tpots(run) -> list:
    """(last token - first token) / (tokens - 1) of every request that got
    at least two tokens in the window."""
    return [(run.tick_end(r.token_ticks[-1]) - run.tick_end(r.token_ticks[0]))
            / (len(r.token_ticks) - 1) for r in run.records
            if len(r.token_ticks) >= 2]


def queue_waits(run) -> list:
    """Due to the end of the first tick after which the request held a
    slot (the window's end if it never did)."""
    return [(run.tick_end(r.issued_tick) if r.issued_tick is not None
             else run.end) - r.due for r in run.records]


def dispatched(run) -> list:
    return [k for k, t in enumerate(run.ticks) if t[3]]


def tick_seconds(run, ticks) -> float:
    return sum(run.ticks[k][1] - run.ticks[k][0] for k in ticks)


def mfu(run, ticks, seconds: float) -> float | None:
    """Logical FLOPs of ``ticks`` over ``seconds`` and the bf16 peak, %."""
    if seconds <= 0:
        return None
    w = run.work()
    flops = sum(work.model_flops(run.config["model"], w[k]) for k in ticks)
    return 100.0 * flops / seconds / work.PEAK_BF16_FLOPS


def roofline(run, bound, names) -> float | None:
    """The least time of a kernel's calls over their device time in the
    trace, %; None without a trace or calls."""
    if run.trace is None:
        return None
    dev = run.trace.device_s(names)
    if dev <= 0:
        return None
    least = sum(bound(w) for w in run.work())
    return 100.0 * least / dev


def k1_roofline(run) -> float | None:
    m, eng = run.config["model"], run.config["engine"]
    return roofline(run, lambda w: work.k1_bound_s(m, eng, w), K1_KERNELS)


def k3_roofline(run) -> float | None:
    m = run.config["model"]
    return roofline(run, lambda w: work.k3_bound_s(m, w), K3_KERNELS)


def idle_share(run) -> float | None:
    """The share of the traced window with no device record, %; None
    without device records (a run that never reached the device)."""
    if (run.trace is None or not run.trace.kernels
            or run.trace.window_s() <= 0):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())

