"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where no GPU is
present. On a machine with a card and without JAX, run them with the
repository's conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The x8/i8 kernels accumulate exact integers, so they must be bitwise equal
to the plain versions. The SwiGLU kernel and its plain version both round
an f64 sigmoid to f32, which agree but for inputs on an f32 rounding
midpoint; a difference there can move a requantized hidden value by one at
an exact .5 boundary. Such flips must be rare (<= 1e-4 of the elements,
each by 1), and every row without a flip must agree within the fused-FFN
tolerance of the JAX tests (rtol=1e-5, atol=0.01).
"""

import numpy as np
import pytest
import torch

from ternary_spgemm_tpu_torch.formats import (
    TiledBitplane,
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


KERNELS = {
    "x8": (cuda_kernels.cuda_tiled_bitplane_x8_kernel,
           cuda_kernels.bitplane_x8_plain, 127),
    "i8": (cuda_kernels.cuda_tiled_bitplane_i8_kernel,
           cuda_kernels.bitplane_i8_plain, 512),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("M,K,N,tile_n", [
    (1, 100, 300, 4096), (7, 1000, 260, 128), (33, 2048, 520, 256),
    (5, 384, 4100, 4096)])
@pytest.mark.parametrize("prelu", [False, True])
def test_bitplane_kernel_bitwise(dev, name, M, K, N, tile_n, prelu):
    kern, plain, vr = KERNELS[name]
    fmt = TiledBitplane.from_dense(generate_ternary(K, N, 3, seed=K + N),
                                   tile_n=tile_n).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=M, value_range=vr)).to(dev)
    X = X + 0.37 * (torch.arange(K, device=dev) % 3)    # exercises rounding
    b = torch.from_numpy(generate_bias(N)).to(dev)
    a = torch.from_numpy(generate_alpha(N)).to(dev) if prelu else None
    got = kern(X, fmt, b, a)
    want = plain(X, fmt, b, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_wrapper_rejects_bad_inputs(dev):
    fmt = TiledBitplane.from_dense(generate_ternary(64, 64, 2, seed=0)).to(dev)
    b = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        cuda_kernels.cuda_tiled_bitplane_x8_kernel(
            torch.zeros((2, 64), dtype=torch.float16, device=dev), fmt, b)
    with pytest.raises(ValueError, match="plane"):
        cuda_kernels.cuda_tiled_bitplane_x8_kernel(
            torch.zeros((2, 64), device=dev), fmt.to("cpu"), b)


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
