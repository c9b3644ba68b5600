"""The serving engine: the paged unified token-budget tick and the dense
slot tick.

Port of the JAX package's ``serving/engine.py`` for models of attention,
MoE, Mamba-2 and shared-attention layers, over token prompts or (dense
mode only) a frontend's embeddings.

**Paged mode** (pure-attention configs, the default for them): every tick
is ONE mixed step.  The scheduler admits work against a per-tick TOKEN
budget (each live decode row costs one token, waiting prefills are split
into chunks that fill the remainder, speculative draft lanes take what is
left), the host packs the admitted tokens into one fixed-shape ragged batch
of ``token_budget`` lanes, and ``models.paged_mixed_step`` runs the model —
K1, the ragged paged-attention kernel, at every layer — followed by
``models.speculative_verify`` on the gathered boundary logits.

- **One device→host sync per tick**: tokens, accept counts and scores come
  back in ONE ``.cpu()`` in ``_to_host``; ``stats.host_syncs ==
  stats.ticks`` is the invariant (an idle tick dispatches nothing and does
  not count).
- **In-place pool**: the step writes K/V into the device pool in place (the
  JAX engine donates the pool to its jitted step instead), and every tick
  publishes the pool tensors themselves to the ``DeviceStore`` key
  ``kv_key`` (``PagedCacheManager.publish``).
- **Fixed shapes**: the packed batch is always ``token_budget`` lanes and
  the block-table operand always (n_slots, max_blocks).

**Dense mode** (``paged=False``; the default for the SSM, hybrid and
embeds configs): each tick first admits waiting requests in contiguous
groups of equal prompt length, each group ONE batched ``models.prefill``
(K2 and K3) whose caches are copied into the group's slots, then decodes
every slot in ONE ``models.decode_step`` (K4 for attention, the plain SSM
step for mamba layers) masked to the live ones: an inactive slot keeps its
last token.
Every dispatch is followed by one host pull, so ``stats.host_syncs ==
stats.decode_ticks + stats.prefill_batches``.  An embeds prompt is an
(S, d) array; equal-length ones share a prefill as token prompts do.  The
decode tick feeds each slot's sampled token id back as its next input,
which an embeds model cannot take: the reference crashes there (ROADMAP
F12), so ``submit`` rejects an embeds request with ``max_new_tokens > 1``
through the completion path, and one-token requests are served exactly as
the reference serves them (prefill only).

**CUDA graphs** (``cuda_graphs``; on by default on the card): the paged
mixed tick and the dense decode tick are each captured ONCE per engine and
replayed after that, the port's counterpart of the JAX engine's tick jitted
once per engine.  Each tick kind runs its first call eagerly (it loads the
kernels and sizes their workspaces), captures at its second and replays that
capture at once (a capture runs nothing), and replays at every later call;
no warm-up runs a tick twice, since a tick writes the pool or the caches in
place.  Every input reaches the device through one staging buffer that is
never rebound: the host packs into pinned memory and uploads it with one
non-blocking copy (the staging is written again only after the tick's one
sync), and the tick writes its outputs into one static int32 buffer that
``_to_host`` pulls.  Sampling reseeds one engine generator per dispatch,
which the graph reads at each replay.  Dense prefills (one shape per prompt
length, as the JAX engine's prefill recompiles per shape) and ``forward``
stay eager.  ``cuda_graphs=False`` keeps every tick eager (the comparison
the on-card smoke test makes); a capture that fails raises.

Speculative decoding (``spec_k > 0``, paged only), prefix reuse with
same-tick sharing, deadlines and the request lifecycle follow the reference
exactly, so the greedy streams and every counter match the JAX engine's.

**Preemption, spill and adoption** (paged only) follow the reference too.
With ``preempt=True`` the tick's entry evicts at most one in-flight victim
whose virtual deadline is strictly later than the best waiting request's,
when that request cannot issue for lack of slots or blocks.  A decoding
victim's KV is spilled (``spill``: a device gather, then ONE pull through
``_to_host``, counted in ``stats.spill_syncs``) and parked in
``spill_pool`` (``core.store.SpillPool``); when it re-issues, ``adopt``
scatters it back into fresh blocks in place and it decodes on, bit for bit.
A refused or evicted park, or no pool, folds the emissions into the prompt
and the request replays.  So a spilling engine keeps ``host_syncs == ticks
+ spill_syncs``, and a pool-less preempting one ``host_syncs == ticks``.
``evacuate`` empties a crashed replica (``faults.FaultInjector``'s seams
fire at tick and submit entry) and a sibling ``adopt``s its spilled
sessions.  Spills and adoptions run at tick entry, outside any capture, on
the current stream: after the last replay, before the next.

**Mesh slices** (``mesh``, paged only; ``launch.mesh.mesh_slices``; one
device, ``launch.mesh.device_mesh``, when none is given): the params
install placed by ``launch.sharding.param_shardings`` (one local tree a
shard, ``_local_params``) and the pool by ``kv_pool_shardings``, and the
tick runs over the slice in this one process
(``models.paged_mixed_step(..., tp=)``), the counterpart of the JAX
engine's single-controller jit over its slice.  A slice whose shards share
one card is captured like any tick; one over several cards runs eagerly.
Dense engines take no mesh, as in the reference.

Entry points run on the card: ``device`` defaults to ``"cuda"`` and the
engine raises when there is none; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention.quant import (is_quantized,
                                                        resolve_kv_dtype)
from repro_torch.core.sharded import local_tree, place_tree
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.launch.sharding import param_shardings, tensor_parallel
from repro_torch.models import (decode_step, paged_mixed_step, prefill,
                                sample_with_scores, speculative_verify,
                                supports_paged, supports_speculative)
from repro_torch.models.config import ModelConfig

from .draft import DraftSource, default_draft_source
from .faults import ReplicaCrashed
from .kvcache import (CacheManager, PagedCacheManager, SpilledKV, pack,
                      to_device, unpack)
from .scheduler import Request, Scheduler, virtual_deadline


@dataclass
class EngineStats:
    ticks: int = 0                 # dispatched steps
    tokens_out: int = 0
    prefills: int = 0
    prefill_batches: int = 0       # dense: batched prefill dispatches
    prefill_chunks: int = 0        # prompt chunks packed into mixed steps
    decode_ticks: int = 0          # ticks that carried >= 1 decode row
    host_syncs: int = 0            # device→host transfers
    prompt_tokens: int = 0         # total prompt tokens seen
    prefill_tokens: int = 0        # tokens actually prefilled
    prefix_hit_tokens: int = 0     # tokens reused from cache
    prefix_hits: int = 0           # requests with a hit
    blocks_in_use: int = 0         # gauge, sampled per tick
    spec_drafted: int = 0          # draft tokens packed for verification
    spec_accepted: int = 0         # drafts the target confirmed (kept)
    spec_rolled_back: int = 0      # rejected drafts whose KV was rolled back
    deadline_exceeded: int = 0     # requests expired at this replica
    spill_syncs: int = 0           # device→host KV spills (counted in
    #                                host_syncs too: a spilling replica
    #                                keeps host_syncs == ticks + spill_syncs)
    spilled_sessions: int = 0      # live sessions spilled off this replica
    adopted_sessions: int = 0      # spilled sessions restored INTO this one
    preemptions: int = 0           # in-flight victims evicted for a waiter
    spilled_blocks: int = 0        # KV blocks pulled host-side by spills
    resumes: int = 0               # preempted requests restored via adopt()
    #                                (replays re-issue as ordinary
    #                                admissions and are not counted)
    graph_captures: int = 0        # ticks captured as a CUDA graph
    graph_replays: int = 0         # ticks that replayed a captured graph
    graph_capture_s: float = 0.0   # host time of the captures (instantiation
                                   # included; the first replay excluded)
    ttft_s: list = field(default_factory=list)     # time to first token
    tpot_s: list = field(default_factory=list)     # time per output token
    queue_wait_s: dict = field(default_factory=dict)   # slo -> [seconds]

    def spec_acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target model confirmed."""
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else float("nan"))


def _flatten(tensors, out: torch.Tensor | None = None) -> torch.Tensor:
    """Every tensor (4-byte dtypes) bit-cast to int32 and concatenated on
    the device, into ``out`` when given."""
    return torch.cat([t.reshape(-1).view(torch.int32) for t in tensors],
                     out=out)


def _layout(tensors) -> list[tuple[tuple[int, ...], type]]:
    """The (shape, numpy dtype) pairs ``_to_host`` splits ``tensors``
    into."""
    return [(tuple(t.shape),
             np.float32 if t.dtype == torch.float32 else np.int32)
            for t in tensors]


class _Staging:
    """The int32 inputs of one tick kind: named views into one host buffer
    (pinned on the card) and one device buffer of the same layout, each
    view 16-byte aligned.  The host packs into ``host``; ``upload`` is one
    non-blocking copy; the tick reads ``dev``, whose storage never moves."""

    def __init__(self, shapes: dict[str, tuple[int, ...]], device) -> None:
        offsets, n = {}, 0
        for name, shape in shapes.items():
            offsets[name] = n
            n += -(-math.prod(shape) // 4) * 4
        self._host = torch.zeros(n, dtype=torch.int32,
                                 pin_memory=device.type == "cuda")
        self._dev = torch.zeros(n, dtype=torch.int32, device=device)
        flat = self._host.numpy()
        self.host = {k: flat[o:o + math.prod(shapes[k])].reshape(shapes[k])
                     for k, o in offsets.items()}
        self.dev = {k: self._dev[o:o + math.prod(shapes[k])].view(shapes[k])
                    for k, o in offsets.items()}

    def upload(self) -> None:
        self._dev.copy_(self._host, non_blocking=True)


# one capture stream a device, shared by every engine: cuBLAS keeps a
# workspace for each stream it has run on, for the life of the process
_side_streams: dict[torch.device, torch.cuda.Stream] = {}


class _GraphTick:
    """Runs one kind of engine tick: ``step`` is a function of the engine's
    static buffers alone (inputs, params, pool or caches, outputs).

    Eager (``capture=False``): every call runs ``step``.  Captured: the first
    call runs ``step`` eagerly on a side stream (it loads the kernels, sizes
    their workspaces and readies that stream's cuBLAS state), the second
    captures it on that stream and replays the graph once, and every later
    call replays it.  ``step`` is passed at every call, and only kept inside
    the graph, so the engine and its ticks hold no reference cycle and
    deleting the engine frees the graph and its memory pool at once.

    The capture runs inside ``kernels.holding()``: the graph keeps the
    workspaces its kernels point into alive for as long as it lives.  The
    wrappers' launch counters moved at the capture although nothing ran, so
    the capture's counts are taken back and each replay adds them.  A
    ``generator`` the step draws from is registered with the graph, which
    then reads its seed and offset at each replay: the caller reseeds it
    before every call, captured or not."""

    def __init__(self, device, stats: EngineStats, *, capture: bool,
                 generator: torch.Generator | None) -> None:
        self.capture = capture
        self.stats = stats
        self.generator = generator
        self.graph: torch.cuda.CUDAGraph | None = None
        self.calls = 0
        self._held: list[torch.Tensor] = []
        self._launches: dict[str, int] = {}
        if capture:
            if device not in _side_streams:
                _side_streams[device] = torch.cuda.Stream(device)
            self.stream = _side_streams[device]

    def __call__(self, step: Callable[[], None]) -> None:
        self.calls += 1
        if self.graph is None and not self.capture:
            step()
            return
        if self.graph is None:
            cur = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(cur)
            if self.calls == 1:
                with torch.cuda.stream(self.stream):
                    step()
                cur.wait_stream(self.stream)
                return
            self._capture(step)
            cur.wait_stream(self.stream)
        self.graph.replay()
        kernels.add_launches(self._launches)
        self.stats.graph_replays += 1

    def _capture(self, step: Callable[[], None]) -> None:
        t0 = time.monotonic()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        self._held, self._launches = kernels.capture(graph, self.stream,
                                                     step)
        self.graph = graph
        self.stats.graph_captures += 1
        self.stats.graph_capture_s += time.monotonic() - t0


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 8,
                 max_len: int = 512, temperature: float = 0.0,
                 scheduler: Scheduler | None = None, replica_id: int = 0,
                 on_complete: Callable[[Request], None] | None = None,
                 seed_offset: int | None = None, paged: bool | None = None,
                 block_size: int = 16, num_blocks: int | None = None,
                 prefix_cache: bool = True, devstore=None,
                 kv_key: str | None = None,
                 kv_dtype: str | None = None,
                 token_budget: int | None = None,
                 spec_k: int = 0,
                 draft_source: DraftSource | None = None,
                 spill_pool=None,
                 preempt: bool = False,
                 mesh=None, device="cuda",
                 cuda_graphs: bool | None = None) -> None:
        self.paged = supports_paged(cfg) if paged is None else paged
        if self.paged and not supports_paged(cfg):
            raise ValueError(f"config {cfg.name} cannot use the paged cache")
        if mesh is not None and not self.paged:
            raise ValueError(
                "mesh slices shard the paged block pool; the dense cache "
                "path only runs single-device (pass paged=True or a "
                "config with supports_paged)")
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a launch.mesh.Mesh (a slice "
                                f"from mesh_slices), got {type(mesh)}")
            mesh_dev = mesh.devices.flat[0].device
            if mesh_dev.type != self.device.type:
                raise ValueError(f"the mesh slice lies on {mesh_dev}, the "
                                 f"engine runs on {self.device}")
            self.device = mesh_dev
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine runs on the card (device='cuda') "
                               "but CUDA is not available; pass device='cpu' "
                               "to run the plain-PyTorch path")
        # a slice over several distinct cards runs eagerly: its reductions
        # cross cards, and a capture of them waits for NCCL (ROADMAP P15)
        spans = mesh is not None and len(mesh.torch_devices()) > 1
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda" and not spans
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True captures CUDA graphs, but the "
                             f"engine runs on {self.device}")
        elif cuda_graphs and spans:
            raise ValueError("cuda_graphs=True: a slice over several cards "
                             "runs eagerly; capturing it waits for the NCCL "
                             "collectives of a later slice of the port "
                             "(ROADMAP P15)")
        self.cuda_graphs = bool(cuda_graphs)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        # the paged tick runs over a slice (one device when none is given):
        # the params placed by the logical-axis rules, one local tree a
        # shard; a one-device slice's one tree holds the given tensors
        if self.paged:
            slice_ = mesh if mesh is not None else device_mesh(self.device)
            for axis, n in slice_.shape.items():
                if axis != "model" and n > 1:
                    raise ValueError(f"a serving slice is (data=1, model=m); "
                                     f"mesh {slice_.shape} has {axis}={n}")
            self._tp = tensor_parallel(cfg, slice_)
            placed = place_tree(params, param_shardings(cfg, slice_))
            self._local_params = [local_tree(placed, i)
                                  for i in range(slice_.size)]
            if slice_.size > 1:
                params = placed
        self.cfg = cfg
        self.params = params
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k={spec_k} must be >= 0")
        if self.spec_k and (not self.paged or not supports_speculative(cfg)):
            raise ValueError(
                f"config {cfg.name} cannot decode speculatively: multi-token "
                f"verify rows and KV rollback need the paged path "
                f"(supports_speculative)")
        self.draft_source = (draft_source if draft_source is not None
                             else (default_draft_source() if self.spec_k
                                   else None))
        if self.paged:
            self.cm: Any = PagedCacheManager(
                cfg, n_slots, max_len, block_size=block_size,
                num_blocks=num_blocks, prefix_cache=prefix_cache,
                kv_dtype=resolve_kv_dtype(kv_dtype), devstore=devstore,
                kv_key=kv_key, device=self.device, mesh=mesh)
            self.token_budget = (token_budget if token_budget is not None
                                 else max(32, 2 * n_slots))
            if self.token_budget < n_slots:
                raise ValueError(
                    f"token_budget={self.token_budget} < n_slots={n_slots}: "
                    f"every live decode row costs one token per tick, so a "
                    f"smaller budget would starve decodes")
        else:
            if is_quantized(kv_dtype):
                raise ValueError(
                    f"kv_dtype={kv_dtype!r} quantizes paged KV blocks; the "
                    f"dense slot cache has no block pool to quantize")
            self.cm = CacheManager(cfg, n_slots, max_len, device=self.device)
            self.token_budget = None
        # preemption (opt-in, paged only): victims spill into spill_pool
        # (core.store.SpillPool) and resume through adopt(), or replay
        self.preempt = bool(preempt)
        self.spill_pool = spill_pool
        if self.preempt and not self.paged:
            raise ValueError("preemption spills paged KV blocks; the dense "
                             "path has no per-request blocks to spill")
        self.scheduler = scheduler or Scheduler(n_replicas=1)
        self.replica_id = replica_id
        self.temperature = temperature
        self.on_complete = on_complete
        self.stats = EngineStats()
        self.live: dict[int, Request] = {}         # slot → decoding request
        self.prefilling: dict[int, Request] = {}   # slot → mid-prompt request
        # fault seams (faults.FaultInjector.bind); ``crashed`` makes tick and
        # submit raise ReplicaCrashed
        self.faults = None
        self.crashed = False
        self.kv_recoverable = True
        if self.paged:
            # host-side last emitted token per slot: the tick packs on host
            self._last_host = np.zeros((n_slots,), np.int64)
            K, T, R = self.spec_k, self.token_budget, n_slots
            self._stage = _Staging(
                {"toks": (T,), "pos": (T,), "rows": (T,),
                 "sample_idx": (R, K + 1), "draft_toks": (R, K),
                 "draft_len": (R,), "bt": (R, self.cm.max_blocks)},
                self.device)
            # tokens (R, K+1), n_accept (R,), scores (R, K+1, 2)
            self._out_layout = [((R, K + 1), np.int32), ((R,), np.int32),
                                ((R, K + 1, 2), np.float32)]
        else:
            # the dense tick feeds the last tokens back on the device
            self._last_tokens = torch.zeros((n_slots,), dtype=torch.int32,
                                            device=self.device)
            self._stage = _Staging({"pos": (n_slots, 1),
                                    "active": (n_slots,)}, self.device)
            # tokens (R,), scores (R, 2)
            self._out_layout = [((n_slots,), np.int32),
                                ((n_slots, 2), np.float32)]
        self._out = torch.zeros(
            sum(math.prod(shape) for shape, _ in self._out_layout),
            dtype=torch.int32, device=self.device)
        # one fresh sampling seed per dispatch, offset by replica, set on
        # the engine's one generator
        self._seed_base = (seed_offset if seed_offset is not None
                           else replica_id) * 1_000_003
        self._dispatches = 0
        self._gen = torch.Generator(device=self.device)
        self._tick_runner = _GraphTick(
            self.device, self.stats, capture=self.cuda_graphs,
            generator=self._gen if temperature > 0 else None)

    # ------------------------------------------------------------- client
    def submit(self, req: Request) -> None:
        """Enqueue a request, or reject it up front through the completion
        path (``req.error`` set, ``on_complete`` fired, nothing enqueued)
        when it could never be served."""
        if self.crashed:
            raise ReplicaCrashed(
                f"replica {self.replica_id} is marked down")
        if self.faults is not None:
            self.faults.on_submit()          # may raise InjectedFault
        if req.expired():
            self._deadline_error(req, "admission")
            return
        req.prompt = self._norm_prompt(req.prompt)
        err = self._validate(req)
        if err is not None:
            self._reject(req, err)
            return
        self.scheduler.submit(req)

    def _validate(self, req: Request) -> str | None:
        S = len(self._norm_prompt(req.prompt))
        if S > self.cm.max_len:
            return f"prompt of {S} tokens exceeds max_len={self.cm.max_len}"
        if self.cfg.input_mode == "embeds" and req.max_new_tokens > 1:
            return (f"embeds request with max_new_tokens="
                    f"{req.max_new_tokens}: a decode step would feed the "
                    f"sampled token ids back as embeddings, which the "
                    f"reference engine crashes on (ROADMAP F12); embeds "
                    f"requests are served one token each, from the prefill")
        if not self.paged:
            return None
        S_eff = S - req.replay_offset
        if self.cm.written_max(S_eff, req.max_new_tokens) > self.cm.max_len:
            return (f"prompt of {S} tokens + {req.max_new_tokens} new "
                    f"tokens would write past max_len={self.cm.max_len}")
        cap = self.cm.num_blocks - 1
        need = self._block_cost(req)
        if need > cap:
            return (f"request needs up to {need} KV blocks but the pool "
                    f"can ever provide {cap} (raise num_blocks or lower "
                    f"max_new_tokens)")
        return None

    def _reject(self, req: Request, err: str) -> None:
        req.error = err
        self._complete(req)

    def _deadline_error(self, req: Request, stage: str) -> None:
        """Expire a request through the completion path with a structured
        reason; partial tokens are kept."""
        now = time.monotonic()
        self.stats.deadline_exceeded += 1
        req.error = {"error": "deadline_exceeded", "stage": stage,
                     "deadline_s": req.deadline_s,
                     "elapsed_s": now - req.arrived_s,
                     "request_id": req.request_id}
        self._complete(req)

    def _sweep_deadlines(self) -> None:
        """Per-tick deadline enforcement over every stage a request can be
        parked in: queued, mid-prefill, and decoding."""
        now = time.monotonic()
        for req in self.scheduler.pop_expired(self.replica_id, now):
            self._deadline_error(req, "queued")
        for slot, req in list(self.prefilling.items()):
            if req.expired(now):
                self.prefilling.pop(slot)
                self.cm.release(slot)
                self._deadline_error(req, "prefill")
        for slot, req in list(self.live.items()):
            if req.expired(now):
                self.live.pop(slot)
                self._release_slot(slot, req)
                self._deadline_error(req, "decode")

    # ------------------------------------------------------------- engine
    def _next_seed(self) -> torch.Generator:
        """The engine's generator, seeded for the next dispatch."""
        self._dispatches += 1
        return self._gen.manual_seed(self._seed_base + self._dispatches)

    # lint: sync-site(THE one per-tick device->host pull)
    def _to_host(self, flat: torch.Tensor, layout) -> list[np.ndarray]:
        """THE device→host sync point: ``flat`` (int32, from ``_flatten``)
        is pulled in ONE ``.cpu()``, then split into numpy arrays of
        ``layout``'s (shape, dtype) pairs."""
        self.stats.host_syncs += 1
        host = flat.cpu().numpy()
        out, i = [], 0
        for shape, dt in layout:
            n = math.prod(shape)
            out.append(host[i:i + n].view(dt).reshape(shape))
            i += n
        return out

    @staticmethod
    def _norm_prompt(prompt) -> np.ndarray:
        """(S,) tokens or (S, d) embeds; squeeze a legacy leading batch
        dim."""
        p = np.asarray(prompt)
        if p.ndim >= 2 and p.shape[0] == 1:
            p = p[0]
        if np.issubdtype(p.dtype, np.integer) and p.dtype != np.int32:
            p = p.astype(np.int32)
        return p

    def _block_cost(self, req: Request) -> int:
        """Worst-case block footprint of a request (reuse only shrinks it);
        replayed requests subtract ``replay_offset``."""
        S = len(self._norm_prompt(req.prompt)) - req.replay_offset
        return self.cm.block_cost(S, req.max_new_tokens)

    def idle(self) -> bool:
        return (self.scheduler.pending(self.replica_id) == 0
                and not self.live and not self.prefilling)

    def backlog(self) -> int:
        """Requests this replica currently holds: queued + mid-prefill +
        decoding (the signal a deployment's watermark bounds)."""
        return (self.scheduler.pending(self.replica_id)
                + len(self.prefilling) + len(self.live))

    def _emit_first_token(self, req: Request, slot: int, tok: int,
                          now: float, score) -> None:
        """First-token bookkeeping of a request whose prompt completed."""
        req.slot = slot
        req.tokens.append(tok)
        req.scores.append(float(score[0]))
        req.entropies.append(float(score[1]))
        if req.first_token_s is None:
            req.first_token_s = now
            self.stats.ttft_s.append(now - req.arrived_s)
        self.stats.prefills += 1
        self.stats.tokens_out += 1
        if len(req.tokens) >= req.max_new_tokens:
            self._release_slot(slot, req)              # done at first token
            self._complete(req)
        else:
            self.live[slot] = req

    def _release_slot(self, slot: int, req: Request) -> None:
        if not self.paged:
            self.cm.release(slot)
            return
        gen = (req.tokens[req.replay_offset:] if req.replay_offset
               else req.tokens)
        self.cm.finish(slot, gen)

    def _complete(self, req: Request) -> None:
        req.done_s = time.monotonic()
        if self.spill_pool is not None:
            # a preempted request reaching any terminal state must not leak
            # its parked KV
            self.spill_pool.discard(req.request_id)
        if self.on_complete is not None:
            self.on_complete(req)

    def _record_issue(self, req: Request) -> None:
        """Queue-wait bookkeeping at FIRST issue (slot granted)."""
        if req.issued_s is None:
            req.issued_s = time.monotonic()
            self.stats.queue_wait_s.setdefault(req.slo, []).append(
                req.issued_s - req.arrived_s)

    # ===================================================== dense admission
    def _admit_dense(self) -> None:
        """Admit queue heads into free slots: contiguous runs of equal
        prompt length form one group each (no padding, so ring caches and
        SSM state stay exact; contiguity keeps admission order), and each
        group is ONE batched prefill dispatch and ONE host pull."""
        for req in self.scheduler.pop_expired(self.replica_id):
            self._deadline_error(req, "queued")
        free = self.cm.n_slots - self.cm.n_active
        reqs = self.scheduler.admit(self.replica_id, free)
        if not reqs:
            return
        for req in reqs:
            self._record_issue(req)
        groups: list[tuple[tuple, list[tuple[Request, np.ndarray]]]] = []
        for req in reqs:
            p = self._norm_prompt(req.prompt)
            if groups and groups[-1][0] == p.shape:
                groups[-1][1].append((req, p))
            else:
                groups.append((p.shape, [(req, p)]))
        dev = self.device
        for shape, group in groups:
            S = shape[0]
            prompts = to_device(
                torch.from_numpy(np.stack([p for _, p in group])), dev)
            pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(
                len(group), 1)
            logits, group_caches = prefill(self.params, prompts, pos,
                                           self.cfg, max_len=self.cm.max_len)
            out = sample_with_scores(logits, self._next_seed(),
                                     self.temperature)
            host_toks, host_scores = self._to_host(_flatten(out),
                                                   _layout(out))
            self.stats.prefill_batches += 1           # one sync per group
            now = time.monotonic()
            for row, (req, p) in enumerate(group):
                slot = self.cm.acquire(req.request_id)
                assert slot is not None
                self.cm.insert_prefill(slot, group_caches, S, row)
                self.stats.prompt_tokens += S
                self.stats.prefill_tokens += S
                self._finish_admission(req, slot, int(host_toks[row]), now,
                                       host_scores[row])

    def _finish_admission(self, req: Request, slot: int, tok: int,
                          now: float, score) -> None:
        self._last_tokens[slot].fill_(tok)    # a kernel: no upload, no sync
        self._emit_first_token(req, slot, tok, now, score)

    # --------------------------------------------------- dense decode tick
    def _dense_step(self) -> None:
        """The dense tick's device work, from the static buffers alone:
        decode every slot, sample, keep an inactive slot's last token, and
        write tokens + scores into ``_out``."""
        ins = self._stage.dev
        logits, _ = decode_step(self.params, self.cm.caches,
                                self._last_tokens, ins["pos"], self.cfg)
        sampled, scores = sample_with_scores(logits, self._gen,
                                             self.temperature)
        self._last_tokens.copy_(torch.where(ins["active"] != 0, sampled,
                                            self._last_tokens))
        _flatten((self._last_tokens, scores), out=self._out)

    def _tick_dense(self) -> int:
        """Admit, then decode every slot in one dispatch masked to the live
        ones (an inactive slot keeps its last token), then one host pull."""
        self._admit_dense()
        if not self.live:
            self.stats.ticks += 1
            return 0
        t0 = time.monotonic()
        self._stage.host["pos"][:, 0] = self.cm.positions()
        self._stage.host["active"][:] = self.cm.active_mask()
        self._stage.upload()
        self._next_seed()
        self._tick_runner(self._dense_step)
        # the ONE sync of this tick: tokens + scores in one pull
        host_toks, host_scores = self._to_host(self._out, self._out_layout)
        self.cm.advance()
        dt = time.monotonic() - t0
        done = []
        n_emitted = 0
        for slot, req in list(self.live.items()):
            req.tokens.append(int(host_toks[slot]))
            req.scores.append(float(host_scores[slot, 0]))
            req.entropies.append(float(host_scores[slot, 1]))
            n_emitted += 1
            self.stats.tpot_s.append(dt)
            if len(req.tokens) >= req.max_new_tokens:
                done.append(slot)
        for slot in done:
            req = self.live.pop(slot)
            self._release_slot(slot, req)
            self._complete(req)
        self.stats.ticks += 1
        self.stats.decode_ticks += 1
        self.stats.tokens_out += n_emitted
        return n_emitted

    # ================================================== unified paged tick
    def _pack_chunk(self, slot: int, toks: np.ndarray, pos: np.ndarray,
                    rows: np.ndarray, sample_idx: np.ndarray, n: int,
                    finished: list[int]) -> int:
        """Pack the next prompt chunk of ``slot`` into lanes [n, n+take) —
        at most the budget remainder — and commit newly covered full blocks
        to the trie so same-tick later admissions can share them."""
        seq = self.cm.slots[slot]
        take = min(self.token_budget - n, len(seq.prompt) - seq.prefill_pos)
        if take <= 0:
            return n
        start = seq.prefill_pos
        toks[n:n + take] = seq.prompt[start:start + take]
        pos[n:n + take] = np.arange(start, start + take, dtype=np.int32)
        rows[n:n + take] = slot
        n += take
        self.stats.prefill_tokens += take
        self.stats.prefill_chunks += 1
        if self.cm.commit_prefill_progress(slot, start + take):
            sample_idx[slot] = n - 1       # boundary: the last prompt token
            finished.append(slot)
        return n

    def _admit_mixed(self, toks: np.ndarray, pos: np.ndarray,
                     rows: np.ndarray, sample_idx: np.ndarray, n: int,
                     finished: list[int]) -> int:
        """Admit queue heads one at a time while budget and slots remain;
        each admission immediately packs its first chunk."""
        free = self.cm.n_slots - self.cm.n_active
        while n < self.token_budget and free > 0:
            req = self.scheduler.admit_one(
                self.replica_id, free_slots=free,
                free_blocks=self.cm.available_for_admission(),
                block_cost=self._block_cost,
                max_blocks=self.cm.num_blocks - 1)
            if req is None:
                break
            if self.spill_pool is not None and req.tokens:
                # a preempted request re-issuing: restore its parked KV (it
                # decodes from the next tick; this tick packs nothing for
                # it), or fall through to replay when the pool evicted it
                parked = self.spill_pool.unpark(req.request_id)
                if parked is not None and self.adopt(req, parked):
                    self.stats.resumes += 1
                    self._record_issue(req)
                    free -= 1
                    continue
            if len(req.tokens) > req.replay_offset:
                # emissions whose KV is gone: fold them into the prompt so
                # replay-prefill reproduces the stream exactly
                req.fold_for_replay()
            err = self._validate(req)
            if err is not None:
                self._reject(req, err)
                continue
            p = self._norm_prompt(req.prompt)
            slot = self.cm.acquire(req.request_id)
            seq = (self.cm.begin(slot, p, req.max_new_tokens)
                   if slot is not None else None)
            if seq is None:
                # slot/block accounting drift: put the head back and retry
                # next tick (admitting younger arrivals would reorder FIFO)
                self.scheduler.requeue(self.replica_id, req)
                break
            if req.replay_offset:
                seq.reserve = self._block_cost(req)
            self._record_issue(req)
            free -= 1
            self.stats.prompt_tokens += len(p)
            self.stats.prefix_hit_tokens += seq.reused
            if seq.reused:
                self.stats.prefix_hits += 1
            self.prefilling[slot] = req
            n = self._pack_chunk(slot, toks, pos, rows, sample_idx, n,
                                 finished)
        return n

    def _plan_drafts(self, decode_slots: list[int], lanes_left: int
                     ) -> dict[int, list[int]]:
        """Per live slot, the draft tokens to verify this tick.  Draft lanes
        are granted LAST, from the lanes still idle after every live row's
        mandatory token and all prefill chunk work, and capped at
        max_new - generated - 1 so every emission and every draft KV write
        stays within the admission budget."""
        plans: dict[int, list[int]] = {}
        if not self.spec_k:
            return plans
        for slot in decode_slots:
            if lanes_left <= 0:
                break
            req = self.live[slot]
            room = req.max_new_tokens - len(req.tokens) - 1
            m = min(self.spec_k, room, lanes_left)
            if m <= 0:
                continue

            def history(req=req):
                return np.concatenate([self._norm_prompt(req.prompt),
                                       np.asarray(req.tokens, np.int64)])

            drafts = self.draft_source.propose(req, history, m)[:m]
            valid: list[int] = []
            for t in drafts:
                if not 0 <= int(t) < self.cfg.vocab_size:
                    break
                valid.append(int(t))
            if valid:
                plans[slot] = valid
                lanes_left -= len(valid)
        return plans

    def _mixed_step(self) -> None:
        """The paged tick's device work, from the static buffers alone: the
        model over the packed batch (K1 at every layer, pools updated in
        place) and the acceptance rule, writing tokens, n_accept and scores
        into ``_out``."""
        ins = self._stage.dev
        logits = paged_mixed_step(self._local_params, self.cm.shard_pools,
                                  ins["bt"], ins["toks"], ins["pos"],
                                  ins["rows"], ins["sample_idx"], self.cfg,
                                  tp=self._tp)
        _flatten(speculative_verify(logits, ins["draft_toks"],
                                    ins["draft_len"], self._gen,
                                    self.temperature), out=self._out)

    # ------------------------------------------------- preemption (opt-in)
    def _maybe_preempt(self) -> None:
        """Tick-entry pressure check: when the best waiting request cannot
        issue for lack of slots or blocks, evict AT MOST ONE in-flight
        victim whose virtual deadline is strictly later (EDF across the
        issue boundary; one victim a tick keeps the policy damped)."""
        waiter = self.scheduler.best_waiting(self.replica_id)
        if waiter is None:
            return
        need = self._block_cost(waiter)
        if need > self.cm.num_blocks - 1:
            return                    # unservable: the rejection path's job
        if (self.cm.n_slots - self.cm.n_active > 0
                and need <= self.cm.available_for_admission()):
            return                    # will issue normally this tick
        victim_slot, victim, v_vdl = None, None, virtual_deadline(waiter)
        in_flight = list(self.prefilling.items()) + list(self.live.items())
        for slot, req in in_flight:
            if req.session_key == waiter.session_key:
                continue              # same session: waiter can't overtake
            vdl = virtual_deadline(req)
            if vdl > v_vdl:
                victim_slot, victim, v_vdl = slot, req, vdl
        if victim is not None:
            self.preempt_slot(victim_slot, victim)

    def preempt_slot(self, slot: int, req: Request) -> None:
        """Evict one in-flight request and requeue it at the head of its
        queue.  A mid-prefill victim releases its blocks and replays (it
        emitted nothing).  A decoding victim spills through the one sync
        site and parks in the spill pool; without a pool it is not spilled
        (no sync), and when the park fails its emissions fold into the
        prompt now, so its re-issue replays the stream exactly."""
        if slot in self.prefilling:
            self.prefilling.pop(slot)
            self.cm.release(slot)
        else:
            self.live.pop(slot)
            spilled = self.spill(slot) if self.spill_pool is not None else None
            self.cm.release(slot)
            parked = (spilled is not None
                      and self.spill_pool.park(req.request_id, spilled,
                                               spilled.n_blocks))
            if not parked:
                req.fold_for_replay()   # paged prompts are tokens: can't fail
        req.slot = None
        self.stats.preemptions += 1
        self.scheduler.requeue(self.replica_id, req)

    def _tick_mixed(self) -> int:
        """ONE fixed-shape mixed step: decode rows (each with up to spec_k
        verified draft tokens) + prefill chunks packed against the token
        budget, one dispatch, one host sync."""
        if self.preempt:
            self._maybe_preempt()
        T = self.token_budget
        host = self._stage.host
        toks, pos, rows = host["toks"], host["pos"], host["rows"]
        sample_idx, draft_toks, draft_len = (
            host["sample_idx"], host["draft_toks"], host["draft_len"])
        for a, fill in ((toks, 0), (pos, -1), (rows, -1), (sample_idx, 0),
                        (draft_toks, 0), (draft_len, 0)):
            a.fill(fill)
        finished: list[int] = []
        n = 0
        decode_slots = list(self.live.keys())
        # 0. grow live rows' tables to cover the position each writes now
        self.cm.ensure_decode_blocks()
        # 1. every live decode row costs one token
        for slot in decode_slots:
            seq = self.cm.slots[slot]
            toks[n] = self._last_host[slot]
            pos[n] = seq.pos
            rows[n] = slot
            sample_idx[slot] = n                  # all entries → base lane
            n += 1
        # 2. continue partial prefills in admission order
        for slot in list(self.prefilling):
            if n >= T:
                break
            n = self._pack_chunk(slot, toks, pos, rows, sample_idx, n,
                                 finished)
        # 3. admit new requests into the remainder
        n = self._admit_mixed(toks, pos, rows, sample_idx, n, finished)
        # 4. draft tokens fill the lanes nothing else wanted
        plans = self._plan_drafts(decode_slots, T - n)
        if plans:
            self.cm.ensure_decode_blocks(
                {s: len(d) for s, d in plans.items()}, only=set(plans))
            for slot, drafts in plans.items():
                seq = self.cm.slots[slot]
                m = len(drafts)
                toks[n:n + m] = drafts
                pos[n:n + m] = np.arange(seq.pos + 1, seq.pos + 1 + m)
                rows[n:n + m] = slot
                sample_idx[slot, 1:1 + m] = np.arange(n, n + m)
                draft_toks[slot, :m] = drafts
                draft_len[slot] = m
                self.stats.spec_drafted += m
                n += m
        if n == 0:
            return 0          # idle: nothing dispatched, not a tick
        t0 = time.monotonic()
        self.cm.block_tables(out=host["bt"])
        self._stage.upload()
        self._next_seed()
        self._tick_runner(self._mixed_step)
        self.cm.publish()
        self.stats.blocks_in_use = self.cm.blocks_in_use
        # the ONE sync of this tick
        host_toks, host_acc, host_scores = self._to_host(self._out,
                                                         self._out_layout)
        dt = time.monotonic() - t0
        now = time.monotonic()
        n_emitted = 0
        # 5. decode rows advance: accepted drafts + correction/bonus token
        for slot in decode_slots:
            req = self.live[slot]
            seq = self.cm.slots[slot]
            m = int(draft_len[slot])
            a = int(host_acc[slot])
            n_emit = a + 1
            for j in range(n_emit):
                req.tokens.append(int(host_toks[slot, j]))
                req.scores.append(float(host_scores[slot, j, 0]))
                req.entropies.append(float(host_scores[slot, j, 1]))
                self.stats.tpot_s.append(dt / n_emit)
            self._last_host[slot] = int(host_toks[slot, a])
            seq.pos += n_emit
            self.stats.tokens_out += n_emit
            n_emitted += n_emit
            if m:
                self.stats.spec_accepted += a
                if a < m:
                    self.stats.spec_rolled_back += m - a
                    self.cm.rollback_writes(slot, seq.pos)
            if len(req.tokens) >= req.max_new_tokens:
                self.live.pop(slot)
                self._release_slot(slot, req)
                self._complete(req)
        # 6. chunks that completed their prompt emit their first token
        for slot in finished:
            req = self.prefilling.pop(slot)
            tok = int(host_toks[slot, 0])
            self._last_host[slot] = tok
            n_emitted += 1
            self._emit_first_token(req, slot, tok, now, host_scores[slot, 0])
        self.stats.ticks += 1
        if decode_slots:
            self.stats.decode_ticks += 1
        return n_emitted

    def tick(self) -> int:
        """One engine step.  Paged: one unified mixed dispatch (decode rows
        + prefill chunks).  Dense: admit prefills, then decode all live
        slots."""
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.replica_id} is marked down")
        if self.faults is not None:
            # fault seams fire at tick entry, before any dispatch: a crash
            # raises, a stall returns without progress, a slow tick sleeps
            if self.faults.on_tick(self) == "stall":
                return 0
        self._sweep_deadlines()
        if self.paged:
            return self._tick_mixed()
        return self._tick_dense()

    # --------------------------------------- spill (failover + preemption)
    def spill(self, slot: int) -> SpilledKV | None:
        """Spill one live slot's KV blocks to the host (failover or a
        preemption victim): the cache manager gathers them on the device,
        packed into one byte buffer, and ``_to_host`` pulls it in ONE sync,
        counted in ``spill_syncs``."""
        if not self.paged:
            return None
        seq = self.cm.slots[slot]
        if not seq.active or not seq.table:
            return None
        flat, layout = pack(self.cm.spill_device(slot))
        (raw,) = self._to_host(flat, [((flat.numel(),), np.uint8)])
        self.stats.spill_syncs += 1
        self.stats.spilled_sessions += 1
        self.stats.spilled_blocks += len(seq.table)
        return SpilledKV(request_id=seq.request_id, pos=seq.pos,
                         n_blocks=len(seq.table),
                         block_size=self.cm.block_size,
                         blocks=unpack(torch.from_numpy(raw), layout))

    def evacuate(self, *, spill_kv: bool = True
                 ) -> tuple[list[Request], list[tuple[Request, Any]]]:
        """Empty a dead replica (after ``crashed`` is set, so racing
        submits bounce): queued requests pop for plain resubmission;
        mid-prefill requests release their blocks (replay is exact); live
        requests spill their KV when ``spill_kv`` (else, or when the spill
        fails, they re-home as replays).  Every slot is released, so the
        allocator ends where a normal drain leaves it.  Returns (queued,
        [(req, spilled or None)])."""
        queued = self.scheduler.drain(self.replica_id)
        inflight: list[tuple[Request, Any]] = []
        for slot, req in list(self.prefilling.items()):
            self.prefilling.pop(slot)
            self.cm.release(slot)
            inflight.append((req, None))
        for slot, req in list(self.live.items()):
            self.live.pop(slot)
            spilled = None
            if spill_kv:
                try:
                    spilled = self.spill(slot)
                except Exception:
                    spilled = None       # unrecoverable KV: replay instead
            self.cm.release(slot)
            inflight.append((req, spilled))
        return queued, inflight

    def adopt(self, req: Request, spilled: SpilledKV | None) -> bool:
        """Restore a spilled session into this replica: fresh blocks, the
        migrated KV scattered in, decoding resumed at the spilled position,
        so the stream continues exactly where it stopped.  False (nothing
        allocated) when this replica cannot host it; the caller falls back
        to prompt replay."""
        if (not self.paged or self.crashed or spilled is None
                or not req.tokens):
            return False
        slot = self.cm.acquire(req.request_id)
        if slot is None:
            return False
        seq = self.cm.adopt(slot, self._norm_prompt(req.prompt), spilled,
                            req.max_new_tokens)
        if seq is None:
            return False                 # cm.adopt released the slot
        self._last_host[slot] = int(req.tokens[-1])
        req.slot = slot
        self.live[slot] = req
        self.stats.adopted_sessions += 1
        return True

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.idle():
                return
            self.tick()
        raise TimeoutError("engine did not drain")
