"""Model configuration + layer layout (a field-for-field copy of the JAX
package's ``repro.models.config``, which the port may not import).

A model is: embedding → a stack of *segments* → final norm → LM head.
Each segment is a repeated *pattern* of layers.  The JAX package scans over
``repeat`` stacked parameter copies; the port unrolls the same order into a
flat layer list (``lm.layer_specs``): layer ``r·len(pattern) + i`` of a
segment is pattern position ``i`` of copy ``r``.

``attn_backend`` is kept so the two dataclasses stay equal, but the port
ignores it: the tensor's device picks the attention path (a CUDA tensor
launches the hand-written kernel, a CPU tensor runs its plain version).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

BlockKind = Literal["attn_mlp", "attn_moe", "mamba", "shared_attn"]


@dataclass(frozen=True)
class LayerSpec:
    kind: BlockKind = "attn_mlp"
    window: int | None = None          # None = global attention
    rope_theta: float = 10_000.0


@dataclass(frozen=True)
class Segment:
    pattern: tuple[LayerSpec, ...]
    repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeat


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 → d_model // n_heads
    # --- attention structure ---
    window: int | None = None           # sliding window (None = full attention)
    local_global_pattern: int = 0       # k>0: k local layers then 1 global
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float | None = None  # gemma3: separate theta for local layers
    post_norm: bool = False             # gemma2: post-norms around attn/mlp
    embed_scale: bool = False           # gemma: embeddings × sqrt(d_model)
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                   # routed-expert hidden (0 → d_ff)
    moe_every: int = 1                  # MoE layer every k-th layer
    first_layer_dense: bool = False     # deepseek: layer 0 is dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "einsum"            # "einsum" (GShard dispatch) | "scatter"
    moe_ep_axis: str | None = None      # mesh axis the experts shard over
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0          # shared attn block after every k layers
    # --- frontend ---
    input_mode: str = "tokens"          # tokens | embeds (audio/vlm stubs)
    # --- numerics / impl ---
    optimizer: str = "adamw"            # adamw | adafactor
    dtype: str = "bfloat16"
    attn_backend: str = "xla"           # ignored by the port (see module doc)
    # Paged KV pool storage dtype: None = model dtype; "int8"/"fp8_e4m3"
    # add per-(block, slot, kv-head) f32 scale leaves and quantize-on-write.
    kv_dtype: str | None = None         # None | float32 | bfloat16 | int8 | fp8_e4m3
    q_chunk: int = 512                  # query chunking for the xla flash path
    remat: bool = True
    comm_bf16_barrier: bool = False
    max_target_length: int = 4096       # default positions horizon (RoPE tables)
    layout_repeats: tuple | None = None  # override each segment's repeat count
    scan_unroll: bool = False
    notes: str = ""

    # ------------------------------------------------------------------ dims
    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def d_inner(self) -> int:           # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # -------------------------------------------------------------- layout
    def layout(self) -> tuple[Segment, ...]:
        """The segment/pattern decomposition of the stack."""
        segs = self._layout_base()
        if self.layout_repeats is not None:
            assert len(self.layout_repeats) == len(segs)
            segs = tuple(Segment(s.pattern, r)
                         for s, r in zip(segs, self.layout_repeats))
        return segs

    def _layout_base(self) -> tuple[Segment, ...]:
        th, thl = self.rope_theta, (self.rope_theta_local or self.rope_theta)
        glob = LayerSpec("attn_mlp", None, th)
        loc = LayerSpec("attn_mlp", self.window, thl)

        if self.family == "ssm":
            return (Segment((LayerSpec("mamba"),), self.n_layers),)

        if self.family == "hybrid":
            k = self.shared_attn_every
            assert k and self.n_layers % k == 0, "hybrid needs n_layers % shared_attn_every == 0"
            pattern = tuple([LayerSpec("mamba")] * k + [LayerSpec("shared_attn", None, th)])
            return (Segment(pattern, self.n_layers // k),)

        if self.n_experts:  # MoE families
            moe = LayerSpec("attn_moe", self.window, th)
            dense = LayerSpec("attn_mlp", self.window, th)
            segs: list[Segment] = []
            n = self.n_layers
            if self.first_layer_dense:
                segs.append(Segment((dense,), 1))
                n -= 1
            if self.moe_every == 1:
                segs.append(Segment((moe,), n))
            else:
                assert n % self.moe_every == 0
                pat = tuple([dense] * (self.moe_every - 1) + [moe])
                segs.append(Segment(pat, n // self.moe_every))
            return tuple(segs)

        # dense transformers
        if self.local_global_pattern:
            k = self.local_global_pattern
            per = k + 1
            full, rem = divmod(self.n_layers, per)
            segs = [Segment(tuple([loc] * k + [glob]), full)]
            if rem:
                segs.append(Segment((loc,), rem))
            return tuple(segs)
        if self.window is not None:
            return (Segment((loc,), self.n_layers),)
        return (Segment((glob,), self.n_layers),)

    # ---------------------------------------------------------- accounting
    def param_count(self) -> int:
        """Exact parameter count from the layout."""
        d, hd = self.d_model, self.head_dim
        n = 0
        has_shared = False
        for seg in self.layout():
            per_pattern = 0
            for spec in seg.pattern:
                if spec.kind == "mamba":
                    di, ds = self.d_inner, self.ssm_state
                    nh = self.ssm_heads
                    conv_dim = di + 2 * ds
                    per_pattern += d * (2 * di + 2 * ds + nh)       # in_proj
                    per_pattern += conv_dim * (self.conv_width + 1)  # conv w + b
                    per_pattern += 2 * nh + nh                       # A, D, dt_bias
                    per_pattern += di                                # out norm
                    per_pattern += di * d                            # out_proj
                    per_pattern += d                                 # pre-norm
                elif spec.kind == "shared_attn":
                    has_shared = True                  # ONE param set, counted below
                else:
                    per_pattern += d * (self.n_heads * hd)           # q
                    per_pattern += 2 * d * (self.n_kv_heads * hd)    # k, v
                    per_pattern += (self.n_heads * hd) * d           # o
                    per_pattern += (4 * d if self.post_norm else 2 * d)
                    if self.qk_norm:
                        per_pattern += 2 * hd
                    if spec.kind == "attn_moe":
                        e, ff = self.n_experts, self.moe_d_ff
                        per_pattern += d * e                         # router
                        per_pattern += e * 3 * d * ff                # experts
                        if self.n_shared_experts:
                            per_pattern += 3 * d * (self.n_shared_experts * ff)
                    else:
                        per_pattern += 3 * d * self.d_ff
            n += per_pattern * seg.repeat
        if has_shared:
            din = 2 * d
            n += din * (self.n_heads * hd)                   # q
            n += 2 * din * (self.n_kv_heads * hd)            # k, v
            n += (self.n_heads * hd) * d                     # o (to d)
            n += 2 * din * self.d_ff + self.d_ff * d         # gated mlp (out to d)
            n += 2 * din                                     # norms
        n += self.vocab_size * d                                     # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        n += d                                                       # final norm
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        e, ff, d = self.n_experts, self.moe_d_ff, self.d_model
        n_moe_layers = sum(
            sum(1 for s in seg.pattern if s.kind == "attn_moe") * seg.repeat
            for seg in self.layout())
        inactive = n_moe_layers * (e - self.top_k) * 3 * d * ff
        return full - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
