from .config import LayerSpec, ModelConfig, Segment
from .lm import (forward, init_paged_pools, init_params, layer_specs,
                 paged_mixed_step, params_from_numpy, pools_from_numpy,
                 pools_to_numpy, supports_paged, supports_speculative)
from .sampling import sample_with_scores, speculative_verify

__all__ = ["LayerSpec", "ModelConfig", "Segment", "forward",
           "init_paged_pools", "init_params", "layer_specs",
           "paged_mixed_step", "params_from_numpy", "pools_from_numpy",
           "pools_to_numpy", "sample_with_scores", "speculative_verify",
           "supports_paged", "supports_speculative"]
