"""The serving engine: the paged unified token-budget tick and the dense
slot tick.

Port of the JAX package's ``serving/engine.py`` for token models of
attention, Mamba-2 and shared-attention layers.

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
  JAX engine donates the pool to its jitted step instead).
- **Fixed shapes**: the packed batch is always ``token_budget`` lanes and
  the block-table operand always (n_slots, max_blocks), ready for a CUDA
  graph capture of the step (a later change; eager today).

**Dense mode** (``paged=False``; the default for the SSM and hybrid
configs): each tick first admits waiting requests in contiguous groups of
equal prompt length, each group ONE batched ``models.prefill`` (K2 and K3)
whose caches are copied into the group's slots, then decodes every slot in
ONE ``models.decode_step`` (K4 for attention, the plain SSM step for mamba
layers) masked to the live ones: an inactive slot keeps its last token.
Every dispatch is followed by one host pull, so ``stats.host_syncs ==
stats.decode_ticks + stats.prefill_batches``.

Speculative decoding (``spec_k > 0``, paged only), prefix reuse with
same-tick sharing, deadlines and the request lifecycle follow the reference
exactly, so the greedy streams and every counter match the JAX engine's.

Entry points run on the card: ``device`` defaults to ``"cuda"`` and the
engine raises when there is none; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.decode_attention.quant import (is_quantized,
                                                        resolve_kv_dtype)
from repro_torch.models import (decode_step, layer_specs, paged_mixed_step,
                                prefill, sample_with_scores,
                                speculative_verify, supports_paged,
                                supports_speculative)
from repro_torch.models.config import ModelConfig

from .draft import DraftSource, default_draft_source
from .faults import ReplicaCrashed
from .kvcache import CacheManager, PagedCacheManager
from .scheduler import Request, Scheduler


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
    spill_syncs: int = 0           # spills join with the cluster slice
    spilled_sessions: int = 0
    adopted_sessions: int = 0
    preemptions: int = 0           # preemption joins with its own slice
    spilled_blocks: int = 0
    resumes: int = 0
    ttft_s: list = field(default_factory=list)     # time to first token
    tpot_s: list = field(default_factory=list)     # time per output token
    queue_wait_s: dict = field(default_factory=dict)   # slo -> [seconds]

    def spec_acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target model confirmed."""
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else float("nan"))


def _later(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with the "
                               f"{slice_} slice of the port (see ROADMAP.md)")


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
                 mesh=None, device="cuda") -> None:
        if "attn_moe" in {s.kind for s in layer_specs(cfg)}:
            raise _later(f"MoE layers (config {cfg.name})", "MoE")
        if cfg.input_mode != "tokens":
            raise _later(f"input_mode={cfg.input_mode!r} (config "
                         f"{cfg.name})", "embeds")
        self.paged = supports_paged(cfg) if paged is None else paged
        if self.paged and not supports_paged(cfg):
            raise ValueError(f"config {cfg.name} cannot use the paged cache")
        if mesh is not None:
            if not self.paged:
                raise ValueError(
                    "mesh slices shard the paged block pool; the dense cache "
                    "path only runs single-device (pass paged=True or a "
                    "config with supports_paged)")
            raise _later("mesh slices", "mesh")
        if spill_pool is not None or (preempt and self.paged):
            raise _later("preemption into a SpillPool", "preemption")
        if devstore is not None or kv_key is not None:
            raise _later("the DeviceStore bridge (devstore / kv_key)",
                         "DeviceStore")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine runs on the card (device='cuda') "
                               "but CUDA is not available; pass device='cpu' "
                               "to run the plain-PyTorch path")
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
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
                kv_dtype=resolve_kv_dtype(kv_dtype), device=self.device)
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
        if preempt:
            raise ValueError("preemption spills paged KV blocks; the dense "
                             "path has no per-request blocks to spill")
        self.scheduler = scheduler or Scheduler(n_replicas=1)
        self.replica_id = replica_id
        self.temperature = temperature
        self.on_complete = on_complete
        self.stats = EngineStats()
        self.live: dict[int, Request] = {}         # slot → decoding request
        self.prefilling: dict[int, Request] = {}   # slot → mid-prompt request
        self.crashed = False        # set when the replica is marked down
        if self.paged:
            # host-side last emitted token per slot: the tick packs on host
            self._last_host = np.zeros((n_slots,), np.int64)
        else:
            # the dense tick feeds the last tokens back on the device
            self._last_tokens = torch.zeros((n_slots,), dtype=torch.int32,
                                            device=self.device)
        # one fresh sampling seed per dispatch, offset by replica
        self._seed_base = (seed_offset if seed_offset is not None
                           else replica_id) * 1_000_003
        self._dispatches = 0

    # ------------------------------------------------------------- client
    def submit(self, req: Request) -> None:
        """Enqueue a request, or reject it up front through the completion
        path (``req.error`` set, ``on_complete`` fired, nothing enqueued)
        when it could never be served."""
        if self.crashed:
            raise ReplicaCrashed(
                f"replica {self.replica_id} is marked down")
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
    def _next_seed(self) -> int:
        self._dispatches += 1
        return self._seed_base + self._dispatches

    def _to_host(self, tensors: tuple[torch.Tensor, ...]) -> list[np.ndarray]:
        """THE device→host sync point: every tensor (4-byte dtypes) is
        bit-cast to int32, concatenated on the device and pulled in ONE
        ``.cpu()``, then split back into numpy arrays of the original
        shapes and dtypes."""
        self.stats.host_syncs += 1
        flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])
        host = flat.cpu().numpy()
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            dt = np.float32 if t.dtype == torch.float32 else np.int32
            out.append(host[i:i + n].view(dt).reshape(tuple(t.shape)))
            i += n
        return out

    @staticmethod
    def _norm_prompt(prompt) -> np.ndarray:
        """(S,) tokens; squeeze a legacy leading batch dim."""
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
            prompts = torch.from_numpy(np.stack([p for _, p in group])).to(dev)
            pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(
                len(group), 1)
            logits, group_caches = prefill(self.params, prompts, pos,
                                           self.cfg, max_len=self.cm.max_len)
            toks, scores = sample_with_scores(logits, self._next_seed(),
                                              self.temperature)
            host_toks, host_scores = self._to_host((toks, scores))
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
        self._last_tokens[slot] = tok
        self._emit_first_token(req, slot, tok, now, score)

    # --------------------------------------------------- dense decode tick
    def _tick_dense(self) -> int:
        """Admit, then decode every slot in one dispatch masked to the live
        ones (an inactive slot keeps its last token), then one host pull."""
        self._admit_dense()
        if not self.live:
            self.stats.ticks += 1
            return 0
        t0 = time.monotonic()
        dev = self.device
        positions = torch.from_numpy(self.cm.positions()[:, None]).to(dev)
        active = torch.from_numpy(self.cm.active_mask()).to(dev)
        logits, _ = decode_step(self.params, self.cm.caches,
                                self._last_tokens, positions, self.cfg)
        sampled, step_scores = sample_with_scores(logits, self._next_seed(),
                                                  self.temperature)
        new_toks = torch.where(active, sampled, self._last_tokens)
        self._last_tokens = new_toks
        # the ONE sync of this tick: tokens + scores in one pull
        host_toks, host_scores = self._to_host((new_toks, step_scores))
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
            if len(req.tokens) > req.replay_offset:
                # emissions of a replayed request: fold them into the prompt
                # so replay-prefill reproduces the stream exactly
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

    def _dispatch(self, bt, toks, pos, rows, sample_idx, draft_toks,
                  draft_len):
        """The tick's device work: upload the packed batch, run the model
        (K1 at every layer, pools updated in place) and the acceptance
        rule.  Returns device tensors (tokens, n_accept, scores)."""
        dev = self.device
        up = lambda a: torch.from_numpy(a).to(dev)
        logits = paged_mixed_step(self.params, self.cm.pools, up(bt), up(toks),
                                  up(pos), up(rows), up(sample_idx), self.cfg)
        return speculative_verify(logits, up(draft_toks), up(draft_len),
                                  self._next_seed(), self.temperature)

    def _tick_mixed(self) -> int:
        """ONE fixed-shape mixed step: decode rows (each with up to spec_k
        verified draft tokens) + prefill chunks packed against the token
        budget, one dispatch, one host sync."""
        T = self.token_budget
        K = self.spec_k
        toks = np.zeros(T, np.int32)
        pos = np.full(T, -1, np.int32)
        rows = np.full(T, -1, np.int32)
        sample_idx = np.zeros((self.cm.n_slots, K + 1), np.int32)
        draft_toks = np.zeros((self.cm.n_slots, K), np.int32)
        draft_len = np.zeros(self.cm.n_slots, np.int32)
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
        sampled, n_acc, scores = self._dispatch(
            self.cm.block_tables(), toks, pos, rows, sample_idx, draft_toks,
            draft_len)
        self.cm.publish()
        self.stats.blocks_in_use = self.cm.blocks_in_use
        # the ONE sync of this tick
        host_toks, host_acc, host_scores = self._to_host(
            (sampled, n_acc, scores))
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
        self._sweep_deadlines()
        if self.paged:
            return self._tick_mixed()
        return self._tick_dense()

    # --------------------------------------- spill (failover + preemption)
    def spill(self, slot: int) -> Any:
        raise _later("spill", "cluster")

    def evacuate(self, *, spill_kv: bool = True):
        raise _later("evacuate", "cluster")

    def adopt(self, req: Request, spilled) -> bool:
        raise _later("adopt", "cluster")

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.idle():
                return
            self.tick()
        raise TimeoutError("engine did not drain")
