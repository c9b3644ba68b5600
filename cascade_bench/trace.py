"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer metrics and the ledger's breakdown read.

Device records and the harness's span ranges (``cbench.<span>``) come from
the profiler's raw Kineto events, both on the host clock the profiler
keeps, so an idle gap on the device is named by the harness span it fell
in.  ``torch.profiler`` loses device records now and then (ROADMAP W6): a
window whose records of a kernel fall more than ``DROP_SHARE`` short of
its wrapper's launches is traced once more (``retraced``, a frozen copy of
``chip_smoke.py``'s).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

DROP_SHARE = 0.01
ATTEMPTS = 2
# each counted kernel wrapper and the one device kernel it ends every call
# with, by which the trace counts its calls
CALL_KERNELS = {"ragged_paged_attention": "ragged_combine_kernel",
                "decode_attention": "decode_combine_kernel",
                "ssd": "ssd_scan_kernel"}


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (name, start_ns, end_ns)
    spans: list = field(default_factory=list)     # (name, start_ns, end_ns)
    window: tuple = (0, 0)                        # ns

    def device_s(self, names) -> float:
        """Device seconds of the kernels whose names hold one of
        ``names``."""
        return sum(e - s for n, s, e in self.kernels
                   if any(p in n for p in names)) / 1e9

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.kernels if name in n)

    def busy_intervals(self) -> list:
        """The union of the device records within the window."""
        lo, hi = self.window
        out: list = []
        for _, s, e in sorted((k for k in self.kernels), key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the harness span it fell in."""
        by_name: dict = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = []
        edges = [self.window[0]] + [x for b in busy for x in b] + \
            [self.window[1]]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                gaps.append((s, e))
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = sorted(self.spans, key=lambda sp: sp[1])
        named = []
        for s, e in gaps[:top]:
            mid = (s + e) / 2
            where = [n for n, a, b in spans if a <= mid < b]
            named.append([where[-1] if where else "harness", (e - s) / 1e9])
        return {"device_ops": [[n[:96], t / 1e9] for n, t in ops],
                "idle_gaps": named}


def read(prof) -> Trace:
    """The device records and the harness's ranges of a finished
    profile."""
    tr = Trace()
    dev = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.name().startswith("cbench."):
            if ev.device_type() == dev:
                continue              # the profiler's copy of a range
            name = ev.name()[len("cbench."):]
            if name == "window":
                tr.window = (s, e)
            else:
                tr.spans.append((name, s, e))
        elif ev.device_type() == dev:
            tr.kernels.append((ev.name(), s, e))
    return tr


def shortfall(tr: Trace, launched: dict) -> dict:
    """Each counted wrapper's launches in the window less the calls the
    trace recorded (a record more than the launches is a launch the
    wrapper did not count)."""
    out = {}
    for wrapper, n in launched.items():
        if n and wrapper in CALL_KERNELS:
            out[wrapper] = n - tr.count(CALL_KERNELS[wrapper])
    return out


def retraced(trace_once):
    """Run ``trace_once`` (one profiled window: returns its result, the
    wrappers' launches and its ``Trace``) until no counted kernel's records
    fall more than ``DROP_SHARE`` short of its launches, at most
    ``ATTEMPTS`` times.  Returns the last (result, trace, shortfall)."""
    for attempt in range(1, ATTEMPTS + 1):
        res, launched, tr = trace_once(attempt)
        short = shortfall(tr, launched)
        if any(d < 0 for d in short.values()):
            raise AssertionError(f"the trace holds more calls than the "
                                 f"wrappers launched: {short}")
        if all(d <= DROP_SHARE * launched[k] for k, d in short.items()):
            break
    return res, tr, short
