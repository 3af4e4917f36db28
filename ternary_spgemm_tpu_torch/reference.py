"""Dense reference operators and the correctness comparator.

Counterpart of ``ternary_spgemm_tpu/reference.py``: ``Y = X @ W + b`` in
float32 with an optional per-column PReLU, and the reference project's
absolute-tolerance comparator (``sparseUtils.h:140-156``, tolerance 1e-5).
On integer-valued test data (|x| <= 512, W in {-1, 0, +1}) every partial sum
is an integer below 2**24, so the f32 product is exact in any order — on a
GPU only with TF32 off, which :func:`dense_gemm` checks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: Absolute tolerance of the reference comparator (``sparseUtils.h:147``).
TOLERANCE = 1e-5


def prelu(y: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``y if y > 0 else alpha[n] * y`` (``GEMM_PreLU``, ``sparseUtils.h:128-133``)."""
    return torch.where(y > 0, y, alpha * y)


def dense_gemm(X, W, b) -> torch.Tensor:
    """``Y[M,N] = X[M,K] @ W[K,N] + b[N]`` in float32."""
    X = torch.as_tensor(X, dtype=torch.float32)
    W = torch.as_tensor(W, device=X.device).to(torch.float32)
    b = torch.as_tensor(b, device=X.device).to(torch.float32)
    if X.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dense_gemm needs full f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return X @ W + b[None, :]


def dense_gemm_prelu(X, W, b, alpha) -> torch.Tensor:
    """Dense reference with fused PReLU (``GEMM_PreLU``)."""
    Y = dense_gemm(X, W, b)
    return prelu(Y, torch.as_tensor(alpha, device=Y.device).to(torch.float32)[None, :])


@dataclasses.dataclass(frozen=True)
class CompareResult:
    """Outcome of a correctness comparison (first offending cell kept)."""

    ok: bool
    max_abs_err: float
    num_bad: int
    first_bad: Optional[tuple] = None   # (m, n, got, want)

    def __bool__(self) -> bool:
        return self.ok


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def compare_results(got, want, tol: float = TOLERANCE) -> CompareResult:
    """Elementwise ``|got - want| <= tol`` (``sparseUtils.h:140-156``). A
    cell where either side is not finite is bad: the JAX comparator's
    ``err > tol`` is False for NaN, so it passes a NaN output
    (``ternary_spgemm_tpu/reference.py:85``)."""
    got, want = _np(got), _np(want)
    if got.shape != want.shape:
        return CompareResult(ok=False, max_abs_err=float("inf"), num_bad=-1)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = ~(err <= tol)
    num_bad = int(bad.sum())
    first = None
    if num_bad:
        idx = tuple(int(i) for i in np.argwhere(bad)[0])
        first = (*idx, float(got[idx]), float(want[idx]))
    return CompareResult(ok=num_bad == 0,
                         max_abs_err=float(err.max()) if err.size else 0.0,
                         num_bad=num_bad, first_bad=first)
