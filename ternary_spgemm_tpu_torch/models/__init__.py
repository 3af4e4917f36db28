"""Model layer of the port: the QAT layers and transformer with their
``torch.optim`` steps and the mesh-sharded forms of those steps, the
ternary Mixture-of-Experts FFN, the exported BitNet W1.58-A8 layers
(differentiable through their transposed containers), the exported
transformer and its KV-cached serving loop."""

from ternary_spgemm_tpu_torch.models.bitlinear import (
    BitLinear,
    TernaryMLP,
    apply_exported,
    apply_exported_a8,
    export_layer,
    ternary_quantize,
    ternary_quantize_ste,
)
from ternary_spgemm_tpu_torch.models.convert import (
    jax_tree,
    lm_from_jax_params,
    mlp_from_flax_params,
    mlp_from_jax_params,
    qat_lm_from_jax_params,
)
from ternary_spgemm_tpu_torch.models.exported import (
    ExportedBitLinear,
    ExportedMLP,
    autotune_exported,
)
from ternary_spgemm_tpu_torch.models.generate import (
    ExportedTransformerLM,
    autotune_serving_flags,
    generate,
    init_cache,
    lm_decode_step,
    lm_prefill,
)
from ternary_spgemm_tpu_torch.models.moe import (
    BitMoE,
    BitMoEConfig,
    ExportedMoE,
    moe_param_shardings,
    moe_route,
)
from ternary_spgemm_tpu_torch.models.serving import build_serving_lm
from ternary_spgemm_tpu_torch.models.train import (
    make_sharded_lm_train_step,
    make_sharded_train_step,
    make_train_step,
    mse_loss,
    param_shardings,
)
from ternary_spgemm_tpu_torch.models.transformer import (
    BitTransformerBlock,
    BitTransformerConfig,
    BitTransformerLM,
    ExportedTransformerBlock,
    MergedQKV,
    lm_loss,
    lm_param_shardings,
    make_lm_train_step,
)

__all__ = [
    "ternary_quantize", "ternary_quantize_ste", "BitLinear", "TernaryMLP",
    "export_layer", "apply_exported", "apply_exported_a8",
    "ExportedBitLinear", "ExportedMLP", "BitTransformerConfig",
    "BitTransformerBlock", "BitTransformerLM", "lm_loss",
    "make_lm_train_step", "mse_loss", "make_train_step",
    "ExportedTransformerBlock", "MergedQKV", "ExportedTransformerLM",
    "generate", "init_cache", "lm_prefill", "lm_decode_step",
    "lm_from_jax_params", "qat_lm_from_jax_params", "mlp_from_jax_params",
    "mlp_from_flax_params", "jax_tree", "build_serving_lm",
    "autotune_exported", "autotune_serving_flags", "BitMoE", "BitMoEConfig",
    "ExportedMoE", "moe_route", "param_shardings", "lm_param_shardings",
    "moe_param_shardings", "make_sharded_train_step",
    "make_sharded_lm_train_step",
]
