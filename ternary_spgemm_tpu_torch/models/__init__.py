"""Model layer of the port: exported BitNet W1.58-A8 layers, the exported
transformer and its KV-cached serving loop."""

from ternary_spgemm_tpu_torch.models.bitlinear import ternary_quantize
from ternary_spgemm_tpu_torch.models.convert import lm_from_jax_params
from ternary_spgemm_tpu_torch.models.exported import (
    ExportedBitLinear,
    autotune_exported,
)
from ternary_spgemm_tpu_torch.models.generate import (
    ExportedTransformerLM,
    autotune_serving_flags,
    generate,
    init_cache,
)
from ternary_spgemm_tpu_torch.models.serving import build_serving_lm
from ternary_spgemm_tpu_torch.models.transformer import (
    BitTransformerConfig,
    ExportedTransformerBlock,
    MergedQKV,
)

__all__ = [
    "ternary_quantize", "ExportedBitLinear", "BitTransformerConfig",
    "ExportedTransformerBlock", "MergedQKV", "ExportedTransformerLM",
    "generate", "init_cache", "lm_from_jax_params", "build_serving_lm",
    "autotune_exported", "autotune_serving_flags",
]
