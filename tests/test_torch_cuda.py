"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where no GPU is
present. On a machine with a card and without JAX, run them with the
repository's conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The x8/i8 kernels accumulate exact integers, so they must be bitwise equal
to the plain versions; so must the bf16 kernel on integer X with |x| <= 256,
where every bf16 value and f32 partial sum is exact. Off that domain the
bf16 kernel and its plain version round X to bf16 identically and differ
only in f32 summation order (rtol=1e-5, atol=1e-3). The SwiGLU kernel and its plain version both round
an f64 sigmoid to f32, which agree but for inputs on an f32 rounding
midpoint; a difference there can move a requantized hidden value by one at
an exact .5 boundary. Such flips must be rare (<= 1e-4 of the elements,
each by 1), and every row without a flip must agree within the fused-FFN
tolerance of the JAX tests (rtol=1e-5, atol=0.01).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ternary_spgemm_tpu_torch.formats import (
    TiledBitplane,
    TiledDenseTernary,
    TiledNibblePair,
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu_torch.ops import cuda_kernels
from ternary_spgemm_tpu_torch.ops.fused_ffn import (
    requantize_rows,
    swiglu_hidden_plain,
    swiglu_launch,
    swiglu_plain,
    true_div,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


ck = cuda_kernels
#: name -> (kernel, plain version, container class, weight field, |x| domain)
KERNELS = {
    "x8": (ck.cuda_tiled_bitplane_x8_kernel, ck.bitplane_x8_plain,
           TiledBitplane, "plane", 127),
    "i8": (ck.cuda_tiled_bitplane_i8_kernel, ck.bitplane_i8_plain,
           TiledBitplane, "plane", 512),
    "bf16": (ck.cuda_tiled_bitplane_bf16_kernel, ck.bitplane_bf16_plain,
             TiledBitplane, "plane", 256),
    "nibble_i8": (ck.cuda_tiled_nibblepair_i8_kernel, ck.nibblepair_i8_plain,
                  TiledNibblePair, "words", 512),
    "dense_i8": (ck.cuda_tiled_dense_i8_kernel, ck.tiled_dense_i8_plain,
                 TiledDenseTernary, "tiles", 512),
    "dense_x8": (ck.cuda_tiled_dense_x8_kernel, ck.tiled_dense_x8_plain,
                 TiledDenseTernary, "tiles", 127),
}


def _case(dev, name, M, K, N, tile_n, prelu):
    kern, plain, cls, _, vr = KERNELS[name]
    fmt = cls.from_dense(generate_ternary(K, N, 3, seed=K + N),
                         tile_n=tile_n).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=M, value_range=vr)).to(dev)
    b = torch.from_numpy(generate_bias(N)).to(dev)
    a = torch.from_numpy(generate_alpha(N)).to(dev) if prelu else None
    return kern, plain, fmt, X, b, a


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("M,K,N,tile_n", [
    (1, 100, 300, 4096), (7, 1000, 260, 128), (33, 2048, 520, 256),
    (5, 384, 4100, 4096)])
@pytest.mark.parametrize("prelu", [False, True])
def test_bitplane_kernel_bitwise(dev, name, M, K, N, tile_n, prelu):
    kern, plain, fmt, X, b, a = _case(dev, name, M, K, N, tile_n, prelu)
    if name != "bf16":                   # exercises rounding and flooring
        X = X + 0.37 * (torch.arange(K, device=dev) % 3)
    got = kern(X, fmt, b, a)
    want = plain(X, fmt, b, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N,tile_n", [(7, 1000, 260, 128),
                                          (33, 2048, 520, 256)])
@pytest.mark.parametrize("prelu", [False, True])
def test_bf16_kernel_off_integer_domain(dev, M, K, N, tile_n, prelu):
    kern, plain, fmt, X, b, a = _case(dev, "bf16", M, K, N, tile_n, prelu)
    X = 1.7 * X + 0.37 * (torch.arange(K, device=dev) % 3)
    got = kern(X, fmt, b, a)
    want = plain(X, fmt, b, a)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_wrapper_rejects_bad_inputs(dev, name):
    kern, _, cls, field, _ = KERNELS[name]
    fmt = cls.from_dense(generate_ternary(64, 64, 2, seed=0)).to(dev)
    b = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        kern(torch.zeros((2, 64), dtype=torch.float16, device=dev), fmt, b)
    with pytest.raises(ValueError, match="float32"):
        kern(torch.zeros((2, 65), device=dev), fmt, b)        # wrong K
    with pytest.raises(ValueError, match="bias"):
        kern(torch.zeros((2, 64), device=dev), fmt, b[:63])
    with pytest.raises(ValueError, match=field):
        kern(torch.zeros((2, 64), device=dev), fmt.to("cpu"), b)
    w = getattr(fmt, field)
    bad = dataclasses.replace(fmt, **{field: w[:, :, :-1].contiguous()})
    with pytest.raises(ValueError, match=field):               # wrong shape
        kern(torch.zeros((2, 64), device=dev), bad, b)


@pytest.mark.parametrize("M,K,N1,N2,tile_n", [
    (1, 128, 256, 128, 4096), (9, 384, 300, 96, 128), (70, 512, 1152, 256, 4096)])
def test_swiglu_kernel(dev, M, K, N1, N2, tile_n):
    fg = TiledBitplane.from_dense(generate_ternary(K, N1, 2, seed=1),
                                  tile_n=tile_n).to(dev)
    fu = TiledBitplane.from_dense(generate_ternary(K, N1, 2, seed=2),
                                  tile_n=tile_n).to(dev)
    fd = TiledBitplane.from_dense(generate_ternary(N1, N2, 2, seed=3)).to(dev)
    x = torch.from_numpy(generate_x(M, K, seed=4)).to(dev)
    xq, sx = requantize_rows(x)
    kw = dict(gamma_gate=0.021, gamma_up=0.034, gamma_down=1.7)
    y, h, rmax = swiglu_launch(xq, sx, fg, fu, fd, **kw)
    want = swiglu_plain(xq, sx, fg, fu, fd, **kw)
    h_plain = swiglu_hidden_plain(xq, sx, fg, fu, gamma_gate=0.021,
                                  gamma_up=0.034)
    hq_plain, _ = requantize_rows(h_plain)
    hq = torch.round(h / true_div(rmax[:, None] + 1e-12, 127.0))
    torch.cuda.synchronize()
    diff = (hq - hq_plain).abs()
    assert float(diff.max()) <= 1.0
    assert int((diff > 0).sum()) <= max(1, int(1e-4 * diff.numel()))
    clean = ~(diff > 0).any(dim=1)
    np.testing.assert_allclose(y[clean].cpu().numpy(),
                               want[clean].cpu().numpy(), rtol=1e-5, atol=0.01)
