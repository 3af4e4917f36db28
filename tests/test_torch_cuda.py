"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where no GPU is
present. On a machine with a card and without JAX, run them with the
repository's conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The x8/i8 kernels accumulate exact integers, so they must be bitwise equal
to the plain versions; so must the f32 and bf16 kernels (dense, stride-packed, ELL gathers) on
integer X in their domains, where every value and f32 partial sum is exact. Off those
domains the f32 and bf16 kernels and their plain versions see the same X
(rounded to bf16 identically where they round) and differ only in f32
summation order (rtol=1e-5, atol=1e-3). The SwiGLU kernel and its plain version both round
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
    BlockedEllTCSC,
    BlockPackedTernary,
    DenseTernary,
    PackedTernary2Bit,
    PackedTernary53,
    TiledBitplane,
    TiledBlockPacked,
    TiledDenseTernary,
    TiledEllDeposit,
    TiledEllTCSC,
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
#: name -> (kernel, plain version, container class, weight field, |x| domain,
#: packer arguments, whether the X rule yields integers: x8 rounds, i8
#: floors); the tile_k and tile_kq cover several chunks of the packed-row
#: core (256 int8 rows, 64 block-packed rows), a ragged last chunk and a
#: multiple of 4 or not; the ELL block_k of 31 and 7 give many K-blocks
KERNELS = {
    "x8": (ck.cuda_tiled_bitplane_x8_kernel, ck.bitplane_x8_plain,
           TiledBitplane, "plane", 127, {}, True),
    "i8": (ck.cuda_tiled_bitplane_i8_kernel, ck.bitplane_i8_plain,
           TiledBitplane, "plane", 512, {}, True),
    "bf16": (ck.cuda_tiled_bitplane_bf16_kernel, ck.bitplane_bf16_plain,
             TiledBitplane, "plane", 256, {}, False),
    "nibble_i8": (ck.cuda_tiled_nibblepair_i8_kernel, ck.nibblepair_i8_plain,
                  TiledNibblePair, "words", 512, {}, True),
    "dense_i8": (ck.cuda_tiled_dense_i8_kernel, ck.tiled_dense_i8_plain,
                 TiledDenseTernary, "tiles", 512, {}, True),
    "dense_i8_k100": (ck.cuda_tiled_dense_i8_kernel, ck.tiled_dense_i8_plain,
                      TiledDenseTernary, "tiles", 512, {"tile_k": 100}, True),
    "dense_x8": (ck.cuda_tiled_dense_x8_kernel, ck.tiled_dense_x8_plain,
                 TiledDenseTernary, "tiles", 127, {}, True),
    "dense_x8_k520": (ck.cuda_tiled_dense_x8_kernel, ck.tiled_dense_x8_plain,
                      TiledDenseTernary, "tiles", 127, {"tile_k": 520}, True),
    "plain_dense": (ck.cuda_dense_kernel, ck.dense_plain, DenseTernary,
                    "dense", 512, {}, False),
    "plain_dense_bf16": (ck.cuda_dense_bf16_kernel, ck.dense_bf16_plain,
                         DenseTernary, "dense", 256, {}, False),
    "plain_dense_i8": (ck.cuda_dense_i8_kernel, ck.dense_i8_plain,
                       DenseTernary, "dense", 512, {}, True),
    "blockpacked_i8_f4": (ck.cuda_blockpacked_i8_kernel,
                          ck.blockpacked_i8_plain, BlockPackedTernary,
                          "packed", 512, {"factor": 4}, True),
    "blockpacked_i8_f5": (ck.cuda_blockpacked_i8_kernel,
                          ck.blockpacked_i8_plain, BlockPackedTernary,
                          "packed", 512, {"factor": 5, "tile_kq": 24}, True),
    "tiled_blockpacked_i8_f4": (ck.cuda_tiled_blockpacked_i8_kernel,
                                ck.tiled_blockpacked_i8_plain,
                                TiledBlockPacked, "tiles", 512,
                                {"factor": 4, "tile_kq": 100}, True),
    "tiled_blockpacked_i8_f5": (ck.cuda_tiled_blockpacked_i8_kernel,
                                ck.tiled_blockpacked_i8_plain,
                                TiledBlockPacked, "tiles", 512,
                                {"factor": 5, "tile_kq": 13}, True),
    "packed2": (ck.cuda_packed2_kernel, ck.packed2_plain, PackedTernary2Bit,
                "packed", 512, {}, False),
    "packed53": (ck.cuda_packed53_kernel, ck.packed53_plain, PackedTernary53,
                 "packed", 512, {}, False),
    "packed2_i8": (ck.cuda_packed2_i8_kernel, ck.packed2_i8_plain,
                   PackedTernary2Bit, "packed", 512, {}, True),
    "packed53_i8": (ck.cuda_packed53_i8_kernel, ck.packed53_i8_plain,
                    PackedTernary53, "packed", 512, {}, True),
    "ell_deposit_i8": (ck.cuda_ell_deposit_i8_kernel, ck.ell_deposit_i8_plain,
                       TiledEllDeposit, "plane", 512, {}, True),
    "tiled_ell": (ck.cuda_tiled_ell_kernel, ck.tiled_ell_plain, TiledEllTCSC,
                  "plane", 512, {}, False),
    "tiled_ell_k31": (ck.cuda_tiled_ell_kernel, ck.tiled_ell_plain,
                      TiledEllTCSC, "plane", 512, {"block_k": 31}, False),
    "ell_gather": (ck.cuda_ell_gather_kernel, ck.ell_gather_plain,
                   BlockedEllTCSC, "idx_pos", 512, {}, False),
    "ell_gather_k7": (ck.cuda_ell_gather_kernel, ck.ell_gather_plain,
                      BlockedEllTCSC, "idx_pos", 512,
                      {"block_k": 7, "cap_align": 1}, False),
}

#: the kernels that sum f32 X as it is (or rounded to bf16)
FLOAT_KERNELS = ["plain_dense", "plain_dense_bf16", "packed2", "packed53",
                 "tiled_ell", "tiled_ell_k31", "ell_gather", "ell_gather_k7"]


def _build(cls, W, tile_n, kw):
    if "tile_n" in cls.__dataclass_fields__:
        kw = dict(kw, tile_n=tile_n)
    return cls.from_dense(W, **kw)


def _case(dev, name, M, K, N, tile_n, prelu):
    kern, plain, cls, _, vr, kw, _ = KERNELS[name]
    fmt = _build(cls, generate_ternary(K, N, 3, seed=K + N), tile_n,
                 kw).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=M, value_range=vr)).to(dev)
    b = torch.from_numpy(generate_bias(N)).to(dev)
    a = torch.from_numpy(generate_alpha(N)).to(dev) if prelu else None
    return kern, plain, fmt, X, b, a


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("M,K,N,tile_n", [
    (1, 100, 300, 4096), (7, 1000, 260, 128), (33, 2048, 520, 256),
    (5, 384, 4100, 4096), (3, 999, 77, 128)])
@pytest.mark.parametrize("prelu", [False, True])
def test_bitplane_kernel_bitwise(dev, name, M, K, N, tile_n, prelu):
    kern, plain, fmt, X, b, a = _case(dev, name, M, K, N, tile_n, prelu)
    if KERNELS[name][6]:   # exercises rounding and flooring
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


@pytest.mark.parametrize("name", FLOAT_KERNELS)
@pytest.mark.parametrize("M,K,N", [(7, 999, 260), (33, 2048, 520)])
@pytest.mark.parametrize("prelu", [False, True])
def test_dense_float_kernels_off_integer_domain(dev, name, M, K, N, prelu):
    """Non-integer X, uniform +-2 (the f32 kernels) or X x 1.7 past the bf16
    kernel's exact +-256, within rtol=1e-5, atol=1e-3; the kernels sum in a
    fixed order, so two launches agree bit for bit."""
    kern, plain, fmt, X, b, a = _case(dev, name, M, K, N, 4096, prelu)
    g = torch.Generator(device=dev).manual_seed(M)
    X = (4.0 * torch.rand((M, K), generator=g, device=dev) - 2.0
         if "bf16" not in name else 1.7 * X + 0.37)
    got = kern(X, fmt, b, a)
    want = plain(X, fmt, b, a)
    again = kern(X, fmt, b, a)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(got, again)


def test_blockpacked_rejects_bad_factor(dev):
    fmt = TiledBlockPacked.from_dense(generate_ternary(64, 64, 2, seed=0),
                                      factor=4, tile_kq=16).to(dev)
    bad = dataclasses.replace(fmt, factor=3)
    with pytest.raises(ValueError, match="factor"):
        ck.cuda_tiled_blockpacked_i8_kernel(torch.zeros((2, 64), device=dev),
                                            bad, torch.zeros(64, device=dev))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_wrapper_rejects_bad_inputs(dev, name):
    kern, _, cls, field, _, kw, _ = KERNELS[name]
    fmt = cls.from_dense(generate_ternary(64, 64, 2, seed=0), **kw).to(dev)
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
    bad = dataclasses.replace(fmt, **{field: w[..., :-1].contiguous()})
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


@pytest.mark.parametrize("M,K,N,tile_n,block_k", [
    (5, 300, 259, 100, 128), (33, 999, 260, 48, 31), (3, 64, 77, 7, 16)])
@pytest.mark.parametrize("prelu", [False, True])
def test_blocked_ell_tiles_not_a_multiple_of_32(dev, M, K, N, tile_n, block_k,
                                                 prelu):
    """BlockedEllTCSC with a tile_n that is not a multiple of 32: a block's
    32 columns straddle tiles of other caps, and N_pad is not a multiple of
    32 either; bitwise on integer X."""
    fmt = BlockedEllTCSC.from_dense(generate_ternary(K, N, 3, seed=K),
                                    block_k=block_k, tile_n=tile_n).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=M)).to(dev)
    b = torch.from_numpy(generate_bias(N)).to(dev)
    a = torch.from_numpy(generate_alpha(N)).to(dev) if prelu else None
    got = ck.cuda_ell_gather_kernel(X, fmt, b, a)
    want = ck.ell_gather_plain(X, fmt, b, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ell_deposit_large_caps(dev):
    """A dense column block (s = 1 for half the columns): every word holds
    up to 31 slots, the largest deposit cap; bitwise on integer X."""
    W = generate_ternary(600, 300, 3, seed=2)
    W[:, :150] = np.where(W[:, :150] == 0, 1, W[:, :150])
    fmt = TiledEllDeposit.from_dense(W, tile_n=128).to(dev)
    assert fmt.cap_p_max + fmt.cap_n_max >= 31
    X = torch.from_numpy(generate_x(9, 600, seed=1)).to(dev)
    b = torch.from_numpy(generate_bias(300)).to(dev)
    got = ck.cuda_ell_deposit_i8_kernel(X, fmt, b)
    want = ck.ell_deposit_i8_plain(X, fmt, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
