"""Fused ternary SwiGLU FFN block — counterpart of the SwiGLU part of
``ternary_spgemm_tpu/ops/fused_ffn.py``.

The W1.58-A8 transformer FFN::

    g   = gamma_g * (sx * (xq @ Wg))        u = gamma_u * (sx * (xq @ Wu))
    h   = silu(g) * u
    hq  = round(h / ((rowmax|h| + 1e-12) / 127))        (requantize_rows)
    y   = (hq @ Wd) * (((rowmax|h| + 1e-12) / 127) * gamma_d)

:func:`fused_bitplane_swiglu` runs it as one call of the CUDA kernel in
``csrc/swiglu.cu`` (two launches: gate/up with the silu-mul epilogue and the
row absmax, then the requantizing down projection). On a CPU tensor it runs
:func:`swiglu_plain`, the same math in PyTorch with every op in the JAX
order. silu is ``g * sigmoid(g)`` as ``jax.nn.silu`` writes it, with the
sigmoid evaluated in f64 and rounded once to f32 (:func:`sigmoid_f32`), in
the kernel as in the plain version, so that the card and the CPU give the
same bits.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.ops import _build
from ternary_spgemm_tpu_torch.ops.cuda_kernels import (
    check_f32,
    check_plane,
    launches,
    matmul_plain,
    note_plain,
    stream_handle,
)

#: requantization constants shared by every path (the JAX values)
_RQ_ABSMAX = 127.0
_RQ_EPS = 1e-12

KERNEL_NAME = "fused_bitplane_swiglu"


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by an IEEE division on every device. (On CUDA, PyTorch
    divides by a Python scalar as ``x * (1 / c)``, which differs from the
    division in the last ULP — and a requantize turns that into int8
    flips.) The divisor is filled on the device: a copy from the host
    would synchronise the stream."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 sigmoid evaluated in f64 and rounded once to f32.

    ``exp`` differs in its last f32 ULP between libraries (and between the
    CPU and the card), and the per-row requantize turns such a difference
    into a whole int8 step when it lands on a .5 boundary. Rounded from
    f64, the result is the correctly rounded f32 sigmoid on every device
    (except on ~1e-7 of inputs that sit on an f32 rounding midpoint)."""
    return torch.sigmoid(x.to(torch.float64)).to(torch.float32)


def requantize_rows(h: torch.Tensor, absmax: float = _RQ_ABSMAX,
                    eps: float = _RQ_EPS):
    """Per-row symmetric int8 requantization -> (hq f32-int-valued, scale).

    ``scale = (rowmax + eps) / absmax``, ``hq = round(h / scale)`` (round
    half to even, true division) — the op order of the JAX formula, which
    the kernels and the A8 linears share."""
    rowmax = torch.amax(torch.abs(h), dim=-1, keepdim=True) + eps
    scale = true_div(rowmax, absmax)
    return torch.round(h / scale), scale


def _check_geometry(fmt_gate: TiledBitplane, fmt_up: TiledBitplane,
                    fmt_down: TiledBitplane) -> None:
    if (fmt_up.K, fmt_up.N, fmt_up.tkb, fmt_up.tile_n) != \
            (fmt_gate.K, fmt_gate.N, fmt_gate.tkb, fmt_gate.tile_n) \
            or fmt_up.plane.shape[:2] != fmt_gate.plane.shape[:2]:
        raise ValueError("gate and up projections must share (K, N, tkb, "
                         "tile_n)")
    if fmt_down.K != fmt_gate.N:
        raise ValueError(
            f"down container contracts over K={fmt_down.K}, expected the "
            f"hidden width {fmt_gate.N}")


def swiglu_hidden_plain(xq, sx, fmt_gate, fmt_up, *, gamma_gate: float = 1.0,
                        gamma_up: float = 1.0) -> torch.Tensor:
    """``h = silu(gamma_g*(sx*(xq@Wg))) * (gamma_u*(sx*(xq@Wu)))`` in f32."""
    xi = torch.trunc(xq.to(torch.float32))
    sx = sx.reshape(-1, 1).to(torch.float32)
    g = gamma_gate * (sx * matmul_plain(xi, fmt_gate))
    u = gamma_up * (sx * matmul_plain(xi, fmt_up))
    return (g * sigmoid_f32(g)) * u


def swiglu_plain(xq, sx, fmt_gate, fmt_up, fmt_down, *,
                 gamma_gate: float = 1.0, gamma_up: float = 1.0,
                 gamma_down: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel (``unfused_reference_swiglu``'s
    math, ``ops/fused_ffn.py:464-481`` of the JAX package)."""
    note_plain(KERNEL_NAME, xq)
    _check_geometry(fmt_gate, fmt_up, fmt_down)
    h = swiglu_hidden_plain(xq, sx, fmt_gate, fmt_up, gamma_gate=gamma_gate,
                            gamma_up=gamma_up)
    hq, scale = requantize_rows(h)
    return matmul_plain(hq, fmt_down) * (scale * gamma_down)


def swiglu_launch(xq, sx, fmt_gate, fmt_up, fmt_down, *,
                  gamma_gate: float = 1.0, gamma_up: float = 1.0,
                  gamma_down: float = 1.0):
    """Run the CUDA kernel -> ``(y (M, N2), h (M, N1), rmax (M,))``: the
    output, the f32 hidden state and its per-row absmax (as f32), so a
    caller can check the requantized hidden against the plain version."""
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL_NAME} runs on CUDA tensors (CPU tensors "
                         f"take the plain version); got a tensor on {dev}")
    _check_geometry(fmt_gate, fmt_up, fmt_down)
    if xq.dim() != 2:
        raise ValueError(f"xq must be 2-D (M, K), got {tuple(xq.shape)}")
    M, K = xq.shape[0], fmt_gate.K
    N1, N2 = fmt_gate.N, fmt_down.N
    check_f32(xq, (M, K), dev, f"{KERNEL_NAME}: xq")
    check_f32(sx.reshape(-1) if sx.dim() == 2 else sx, (M,), dev,
              f"{KERNEL_NAME}: sx")
    pg, pu, pd = (check_plane(f, dev) for f in (fmt_gate, fmt_up, fmt_down))
    h = torch.empty((M, N1), dtype=torch.float32, device=dev)
    rmax = torch.empty((M,), dtype=torch.int32, device=dev)
    y = torch.empty((M, N2), dtype=torch.float32, device=dev)
    if M == 0:
        return y, h, rmax.view(torch.float32)
    err = _build.load().ternary_swiglu(
        xq.data_ptr(), sx.data_ptr(), M, K,
        pg.data_ptr(), pu.data_ptr(), pg.shape[0], pg.shape[1],
        fmt_gate.tkb, fmt_gate.tile_n, N1,
        pd.data_ptr(), pd.shape[0], pd.shape[1], fmt_down.tkb,
        fmt_down.tile_n, N2,
        float(gamma_gate), float(gamma_up), float(gamma_down),
        h.data_ptr(), rmax.data_ptr(), y.data_ptr(), stream_handle(dev))
    _build.check(err, "ternary_swiglu")
    launches[KERNEL_NAME] += 1
    return y, h, rmax.view(torch.float32)


def fused_bitplane_swiglu(xq, sx, fmt_gate: TiledBitplane,
                          fmt_up: TiledBitplane, fmt_down: TiledBitplane, *,
                          gamma_gate: float = 1.0, gamma_up: float = 1.0,
                          gamma_down: float = 1.0) -> torch.Tensor:
    """Fused ternary SwiGLU FFN over int8-valued activations ``xq (M, K)``
    (f32, |xq| <= 127, e.g. from :func:`requantize_rows`) with row scales
    ``sx (M, 1)``. ``fmt_down.K == fmt_gate.N == fmt_up.N``; the three
    projections are biasless. Any M: rows are independent."""
    kw = dict(gamma_gate=gamma_gate, gamma_up=gamma_up, gamma_down=gamma_down)
    if xq.device.type == "cpu":
        return swiglu_plain(xq, sx, fmt_gate, fmt_up, fmt_down, **kw)
    return swiglu_launch(xq, sx, fmt_gate, fmt_up, fmt_down, **kw)[0]


def unfused_reference_swiglu(xq, sx, fmt_gate, fmt_up, fmt_down, *,
                             gamma_gate: float = 1.0, gamma_up: float = 1.0,
                             gamma_down: float = 1.0, kernel: str = None):
    """The fused block as three registry SpMM calls + the shared
    requantize — the unfused counterpart."""
    from ternary_spgemm_tpu_torch.ops.api import ternary_spgemm

    xq = xq.to(torch.float32)
    sx = sx.to(torch.float32)
    zg = torch.zeros((fmt_gate.N,), dtype=torch.float32, device=xq.device)
    zd = torch.zeros((fmt_down.N,), dtype=torch.float32, device=xq.device)
    g = gamma_gate * (sx * ternary_spgemm(xq, fmt_gate, zg, None, kernel=kernel))
    u = gamma_up * (sx * ternary_spgemm(xq, fmt_up, zg, None, kernel=kernel))
    h = (g * sigmoid_f32(g)) * u
    hq, scale = requantize_rows(h)
    y = ternary_spgemm(hq, fmt_down, zd, None, kernel=kernel)
    return y * (scale * gamma_down)
