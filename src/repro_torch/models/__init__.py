from .config import LayerSpec, ModelConfig, Segment
from .lm import (caches_from_numpy, caches_to_numpy, decode_step, forward,
                 init_decode_caches, init_paged_pools, init_params,
                 layer_specs, paged_decode_step, paged_mixed_step,
                 paged_prefill, params_from_numpy, pools_from_numpy,
                 pools_to_numpy, prefill, spilled_from_numpy,
                 spilled_to_numpy, stacked_leaves, supports_paged,
                 supports_speculative)
from .moe import moe, moe_init
from .sampling import sample_with_scores, speculative_verify

__all__ = ["LayerSpec", "ModelConfig", "Segment", "caches_from_numpy",
           "caches_to_numpy", "decode_step", "forward", "init_decode_caches",
           "init_paged_pools", "init_params", "layer_specs", "moe", "moe_init",
           "paged_decode_step", "paged_mixed_step", "paged_prefill",
           "params_from_numpy", "pools_from_numpy", "pools_to_numpy",
           "prefill", "sample_with_scores", "speculative_verify",
           "spilled_from_numpy", "spilled_to_numpy", "stacked_leaves",
           "supports_paged", "supports_speculative"]
