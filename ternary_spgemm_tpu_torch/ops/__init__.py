"""Compute kernels: the kernel registry, the CUDA kernels and their plain
PyTorch versions. Importing this package registers the kernels; nothing is
built until a kernel first launches on a CUDA tensor."""

from ternary_spgemm_tpu_torch.ops.api import (
    BASELINE_KERNEL_NAME,
    REFERENCE_KERNELS,
    KernelSpec,
    all_kernels,
    finish,
    get_kernel,
    register_kernel,
    ternary_spgemm,
    unported,
)
from ternary_spgemm_tpu_torch.ops import xla_kernels  # noqa: F401  (registers the 13 torch-op formulations)
from ternary_spgemm_tpu_torch.ops import cuda_kernels  # noqa: F401  (registers kernels)
from ternary_spgemm_tpu_torch.ops.fused_ffn import (
    fused_bitplane_ffn,
    fused_bitplane_swiglu,
    requantize_rows,
    unfused_reference_ffn,
    unfused_reference_swiglu,
)

__all__ = [
    "BASELINE_KERNEL_NAME", "REFERENCE_KERNELS", "KernelSpec", "all_kernels",
    "finish", "get_kernel", "register_kernel", "ternary_spgemm", "unported",
    "fused_bitplane_ffn", "fused_bitplane_swiglu", "requantize_rows",
    "unfused_reference_ffn", "unfused_reference_swiglu",
]
