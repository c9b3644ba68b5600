"""The device fast path (§3.3–3.4), re-expressed for PyTorch on the card.

Port of the JAX package's ``core/fastpath.py``.  Cascade's fast path makes
the *handoff between pipeline stages* cost almost nothing beside the stage
compute.  The three rungs of the paper's latency/isolation ladder:

1. **Fused stages** (``fuse_stages``; "DLL lambda in the Cascade address
   space"): on a CUDA input the whole chain is ONE CUDA graph, captured once
   per input shape and dtype into static buffers and replayed after that,
   so a call is one graph launch (the counterpart of the JAX package's one
   jitted program).  On a CPU input the chain runs eagerly.
2. **Chained stages** (``chain_stages``; "containerized lambda +
   shared-memory IPC"): each stage is its own dispatch, run eagerly, and the
   activations stay on the device between stages; the host only sequences
   the launches.
3. **Cross-device handoff** (``handoff``; "trigger put over RDMA to the
   next-hop node"): when a stage declares another home device
   (``Stage.out_device``, the counterpart of ``out_sharding``), its output
   moves device to device, never through host memory.

The anti-pattern, ``broker_hop``, fetches the tensor to the host, marshals
it into bytes, unmarshals and uploads it again at every hop: the
Kafka/Flink/EventHub handoff the paper measures against.

**Donation.**  JAX donates a fused program's input so XLA may overwrite it.
Here the contract is: a fused group leaves the caller's input untouched
unless ``donate=True``; a donated group keeps the first input it is given
as its graph's static input buffer, so it adds no device buffer for its
input.  Every later call of that shape copies its own input into that
buffer: the tensor first donated then holds the latest call's input.  JAX
invalidates a donated buffer, so reading it raises; a torch tensor cannot
be invalidated, so here reading it gives another call's data.  Donate
only a tensor nothing reads again.  ``FastPathPipeline.build`` donates
the first group only when the caller opts in, and every later group
always (their inputs are intermediates only the pipeline holds).
Nothing here falls back: a CUDA input runs the graph or the call raises.

**Memory.**  A capture holds its static input and extra buffers, its
output buffer, and the private memory pool of one run's activations, as
long as it is cached.  A fused group caches at most ``max_graphs``
captures (the least recently used goes first, its graph and pool freed),
so inputs of many shapes cost at most that many runs' activations.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import kernels

StageFn = Callable[..., Any]

# one capture stream a device, shared by every fused group: cuBLAS keeps a
# workspace for each stream it has run on, for the life of the process
_side_streams: dict[torch.device, torch.cuda.Stream] = {}


@dataclass(frozen=True)
class Stage:
    """One DFG vertex's compute, with optional placement: ``out_device``
    is the stage's home device (None: wherever its input lives)."""

    name: str
    fn: StageFn
    out_device: torch.device | str | None = None


def _chain(stages: Sequence[Stage], x, extra):
    for st in stages:
        x = st.fn(x, *extra)
    return x


def _key(x: torch.Tensor, extra) -> tuple:
    """What one capture is good for: the input's device, shape and dtype,
    each extra tensor's, and every other extra argument's value."""
    return ((x.device, tuple(x.shape), x.dtype),) + tuple(
        ("tensor", e.device, tuple(e.shape), e.dtype)
        if isinstance(e, torch.Tensor) else ("value", e) for e in extra)


@dataclass
class _Capture:
    """One captured chain: the graph, its static inputs (the input buffer,
    then each extra argument: a buffer for a tensor, else the value) and
    output, the workspaces its kernels point into, and the kernel launches a
    replay adds to the wrappers' counts."""

    graph: Any
    inputs: list[torch.Tensor]
    out: torch.Tensor
    held: list[torch.Tensor]
    launches: dict[str, int]


class _Fused:
    """Rung 1: see ``fuse_stages``.  ``captures``, ``replays`` and
    ``evictions`` count what the CUDA path did."""

    def __init__(self, stages: Sequence[Stage], donate: bool,
                 max_graphs: int) -> None:
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.stages = tuple(stages)
        self.donate = donate
        self.max_graphs = max_graphs
        self._graphs: OrderedDict[tuple, _Capture] = OrderedDict()
        self.captures = 0
        self.replays = 0
        self.evictions = 0

    def __call__(self, x, *extra):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            return _chain(self.stages, x, extra)
        key = _key(x, extra)
        cap = self._graphs.get(key)
        if cap is None:
            if len(self._graphs) >= self.max_graphs:
                self._evict_oldest(x.device)
            return self._first_call(key, x, extra)
        self._graphs.move_to_end(key)
        for buf, new in zip(cap.inputs, (x,) + extra):
            if isinstance(new, torch.Tensor) and buf is not new:
                buf.copy_(new)
        cap.graph.replay()
        kernels.add_launches(cap.launches)
        self.replays += 1
        return cap.out.clone()

    def _evict_oldest(self, dev: torch.device) -> None:
        """Drop the least recently used capture: its graph, buffers and
        pool are freed once the card has finished its last replay."""
        torch.cuda.synchronize(dev)
        self._graphs.popitem(last=False)
        self.evictions += 1

    def _first_call(self, key: tuple, x: torch.Tensor, extra):
        """Run the chain eagerly on the capture stream (it loads the
        kernels, sizes their workspaces and readies that stream's cuBLAS
        state), then capture it over static buffers; the capture runs
        nothing.  A donated group's static input is ``x`` itself."""
        dev = x.device
        if dev not in _side_streams:
            _side_streams[dev] = torch.cuda.Stream(dev)
        side = _side_streams[dev]
        cur = torch.cuda.current_stream(dev)
        static = [x if self.donate else torch.empty_like(x)] + [
            torch.empty_like(e) if isinstance(e, torch.Tensor) else e
            for e in extra]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = _chain(self.stages, x, extra)
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"a fused chain returns one tensor, got "
                            f"{type(out).__name__}")
        result: list[torch.Tensor] = []
        graph = torch.cuda.CUDAGraph()
        held, launches = kernels.capture(
            graph, side,
            lambda: result.append(_chain(self.stages, static[0],
                                         static[1:])))
        cur.wait_stream(side)
        out.record_stream(cur)           # made on the side stream, used here
        self._graphs[key] = _Capture(graph, static, result[0], held,
                                     launches)
        self.captures += 1
        return out


def fuse_stages(stages: Sequence[Stage], *, donate: bool = True,
                max_graphs: int = 8) -> Callable[..., Any]:
    """Rung 1: the whole chain as one CUDA graph on a CUDA input, captured
    at the first call of each input shape and dtype (that call runs
    eagerly) and replayed at every later one: a call is then one copy of
    the input into the graph's static buffer (none when it is that buffer),
    one graph launch and one copy of its output.  Eager on a CPU input.
    ``donate`` and ``max_graphs`` (captures kept): see the module
    docstring."""
    return _Fused(stages, donate, max_graphs)


def chain_stages(stages: Sequence[Stage]) -> Callable[..., Any]:
    """Rung 2: each stage its own dispatch; the activations stay on the
    device between stages, and a stage that declares another home device
    moves its output there by ``handoff``."""

    def run(x, *extra):
        for st in stages:
            x = st.fn(x, *extra)
            if st.out_device is not None and x.device != _device(
                    st.out_device):
                x = handoff(x, st.out_device)
        return x

    return run


def _device(place) -> torch.device:
    """``place`` as a device with its index (``"cuda"`` is the current
    card), comparable with a tensor's ``.device``."""
    dev = torch.device(place)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def handoff(x: torch.Tensor, dst) -> torch.Tensor:
    """Rung 3: an explicit move to ``dst`` (≙ RDMA trigger put to the next
    hop), device to device; never through host memory, so a move between
    the host and a card raises (that is ``broker_hop``)."""
    dst = torch.device(dst)
    if (x.device.type == "cpu") != (dst.type == "cpu"):
        raise ValueError(f"handoff moves device to device; {x.device} -> "
                         f"{dst} would cross host memory (broker_hop)")
    return x.to(dst, non_blocking=True)


# dtypes numpy lacks cross the wire as their raw bits
_RAW_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
             torch.float8_e5m2: torch.uint8}


def broker_hop(x: torch.Tensor) -> torch.Tensor:
    """The measured anti-pattern: host round trip + serialize + copy.

    Mirrors what a Kafka/gRPC handoff does to a tensor: device→host copy, a
    marshalling copy into a byte buffer, an unmarshalling copy out of it,
    and host→device copy.  bfloat16 and fp8 cross as their raw bits, so the
    tensor comes back bit for bit.  Used by baselines and benchmarks
    only."""
    raw = _RAW_BITS.get(x.dtype)
    host = (x if raw is None else x.view(raw)).detach().cpu().numpy()
    wire = host.tobytes()                       # marshalling copy
    back = np.frombuffer(wire, dtype=host.dtype).reshape(host.shape).copy()
    out = torch.from_numpy(back)
    return (out if raw is None else out.view(x.dtype)).to(x.device)


# ---------------------------------------------------------------------------
# Collocation-aware pipeline builder: the piece the serving engine uses.
# ---------------------------------------------------------------------------

@dataclass
class FastPathPipeline:
    """Compile a DFG chain into the fastest legal execution plan.

    Adjacent stages that share a placement (the same ``out_device``, or
    both None) are fused into one group; a placement change inserts a
    device-to-device handoff.  This is the paper's scheduling rule: run
    lambdas where their data lives, and move only the (small) activation
    objects.
    """

    stages: Sequence[Stage]

    def build(self, *, donate_input: bool = False) -> Callable[..., Any]:
        """Build the plan.  Zero-copy donation discipline (§3.4, rung 1):
        every group after the first consumes an intermediate activation
        that only the pipeline references, so it is always donated.  The
        FIRST group consumes the caller's own tensor, which must not be
        taken over behind the caller's back: it is donated only when the
        caller opts in with ``donate_input=True``."""
        groups: list[list[Stage]] = []
        for st in self.stages:
            if groups and _same_place(groups[-1][-1], st):
                groups[-1].append(st)
            else:
                groups.append([st])
        compiled = [(fuse_stages(g, donate=donate_input if gi == 0
                                 else True), g[0].out_device)
                    for gi, g in enumerate(groups)]

        def run(x, *extra):
            for fn, place in compiled:
                if place is not None and x.device != _device(place):
                    x = handoff(x, place)
                x = fn(x, *extra)
            return x

        return run


def _same_place(a: Stage, b: Stage) -> bool:
    return a.out_device == b.out_device
