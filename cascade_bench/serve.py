"""The serving loop: set up one ``ServeEngine`` from a configuration's
file, warm it up on the cell's own shapes, then drive it for the window
from one thread, as a ``ServeNode`` tick thread does: submit what is due,
tick, observe, and repeat.

Every latency comes from the harness's clock (``time.perf_counter``): a
request is stamped when it is due (open loop) or sent (closed loop), each
of its tokens at the end of the tick that produced it, and its admission
at the end of the first tick after which the engine had issued it a slot.
The spans ``submit``, ``tick`` and ``wait`` surround the calls into the
program and the harness's waits; they are kept in memory and, in a traced
run, marked for the profiler too.  Each pass of Python's collector in the
window is a span ``gc<generation>``.
"""
from __future__ import annotations

import contextlib
import gc
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from .traffic import Item
from .work import tick_work

clock = time.perf_counter


@dataclass
class Record:
    """One request as the harness saw it."""
    item: Item
    due: float                     # harness clock
    req: object = None             # the program's Request
    issued_tick: int | None = None
    token_ticks: list = field(default_factory=list)
    done: bool = False

    @property
    def error(self):
        return getattr(self.req, "error", None)


@dataclass
class Run:
    """What one run kept: the records that metric readers read."""
    cell: dict
    config: dict
    mix: dict
    seconds: float
    start: float = 0.0
    end: float = 0.0
    records: list = field(default_factory=list)     # in send order
    # per tick: (start, end, prompt tokens the tick prefilled, dispatched)
    ticks: list = field(default_factory=list)
    spans: list = field(default_factory=list)       # (name, start, end)
    setup_s: float = 0.0
    trace: object = None
    launches: dict = field(default_factory=dict)
    _work: list | None = None

    def tick_end(self, k: int) -> float:
        return self.ticks[k][1]

    def work(self) -> list:
        """Each tick's ``work.TickWork``, worked out once."""
        if self._work is None:
            self._work = tick_work(self)
        return self._work


class Spans:
    """The harness's spans, in memory; in a traced run each is also a
    profiler range (``cbench.<name>``) so the trace can place its gaps."""

    def __init__(self, run: Run, traced: bool):
        self.run, self.traced = run, traced

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = clock()
        if self.traced:
            with torch.profiler.record_function("cbench." + name):
                yield
        else:
            yield
        self.run.spans.append((name, t0, clock()))


def build_engine(cfg, params, engine_conf: dict, device):
    from repro_torch.serving.engine import ServeEngine

    kw = dict(n_slots=engine_conf["n_slots"], max_len=engine_conf["max_len"],
              paged=engine_conf["paged"], device=device, temperature=0.0)
    if engine_conf["paged"]:
        kw.update(token_budget=engine_conf["token_budget"],
                  block_size=engine_conf["block_size"],
                  num_blocks=engine_conf["num_blocks"])
    return ServeEngine(cfg, params, **kw)


def _request(item: Item, tag: str):
    from repro_torch.serving.scheduler import Request

    return Request(request_id=f"{tag}{item.index}",
                   session_key=f"{tag}{item.index}", prompt=item.prompt,
                   max_new_tokens=item.max_new)


def warm_up(engine, mix: dict, vocab: int) -> None:
    """The cell's own shapes: a prompt of the mix's longest length through
    every kind of tick (a paged engine's mixed tick, eager then captured;
    a dense engine's prefill at that length and its decode tick, eager
    then captured), then a second request of the shortest length."""
    import numpy as np

    rng = np.random.default_rng(0)
    for n, (s, out) in enumerate(((mix["prompt"]["max"], 6),
                                  (mix["prompt"]["min"], 6))):
        prompt = rng.integers(0, vocab, size=s).astype(np.int32)
        engine.submit(_request(Item(n, None, prompt, out), "warm"))
        engine.run_until_drained()


def drive(engine, run: Run, items: list[Item], spans: Spans,
          wall=clock) -> None:
    """The measured window: ``run.seconds`` of submitting and ticking from
    this thread.  Open loop: each item is submitted at the first point
    between ticks at or after its due time.  Closed loop: one client per
    engine slot, each sending its next item when its last one completed."""
    mix = run.mix
    open_loop = mix["loop"] == "open"
    queue = deque(items)
    inflight: list[Record] = []
    completed: list = []
    engine.on_complete = completed.append
    stats = engine.stats
    run.start = start = wall()
    end = start + run.seconds
    clients = engine.cm.n_slots if not open_loop else 0
    gc_start = [0.0]

    def on_gc(phase: str, info: dict) -> None:
        # the collector's passes, as spans of their own
        if phase == "start":
            gc_start[0] = wall()
        else:
            run.spans.append((f"gc{info['generation']}", gc_start[0],
                              wall()))
    gc.callbacks.append(on_gc)

    def send(item: Item, due: float) -> None:
        rec = Record(item, due)
        rec.req = _request(item, "r")
        engine.submit(rec.req)
        run.records.append(rec)
        inflight.append(rec)

    while True:
        now = wall()
        if now >= end:
            break
        due = []
        if open_loop:
            while queue and start + queue[0].due_s <= now:
                due.append(queue.popleft())
        else:
            while clients and queue:
                due.append(queue.popleft())
                clients -= 1
        if due:
            with spans("submit"):
                for item in due:
                    send(item, start + item.due_s if open_loop else now)
        if engine.idle():
            nxt = start + queue[0].due_s if open_loop and queue else end
            with spans("wait"):
                time.sleep(max(0.0, min(nxt, end) - wall()))
            continue
        syncs, pre = stats.host_syncs, stats.prefill_tokens
        t0 = wall()
        with spans("tick"):
            engine.tick()
        t1 = wall()
        k = len(run.ticks)
        run.ticks.append((t0, t1, stats.prefill_tokens - pre,
                          stats.host_syncs > syncs))
        for req in completed:
            req.cbench_done = True
        if completed and not open_loop:
            clients += len(completed)
        completed.clear()
        keep = []
        for rec in inflight:
            n = len(rec.req.tokens)
            if n > len(rec.token_ticks):
                rec.token_ticks.extend([k] * (n - len(rec.token_ticks)))
            if rec.issued_tick is None and rec.req.issued_s is not None:
                rec.issued_tick = k
            if getattr(rec.req, "cbench_done", False):
                rec.done = True
            else:
                keep.append(rec)
        inflight[:] = keep
    run.end = wall()
    gc.callbacks.remove(on_gc)
    engine.on_complete = None
