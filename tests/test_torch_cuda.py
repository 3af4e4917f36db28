"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where no GPU is
present. On a machine with a card and without JAX, run them with the
repository's conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The x8/i8 kernels accumulate exact integers, so they must be bitwise equal
to the plain versions (each on both of its branches, split at
``X8_MMA_MIN_M`` and ``I8_MMA_MIN_M``; ``-k "x8 or i8_"`` runs their
tests alone, ``-k gemv`` their decode body's split walk, ``-k ffn`` the
fused PReLU FFN's two phases on the same body and ``-k decode_rate`` the
probe of its inner step); so must the f32 and
bf16 kernels (dense, stride-packed, ELL gathers) on integer X in their
domains, where every value and f32 partial sum is exact (``-k
dense_mma`` runs the bf16 tensor-core tile of the dense f32 and bf16
kernels alone, ``-k ring`` the ring on the same tile, ``-k packed_mma``
the int8-X kernels over the packed-row containers on it and ``-k
float_mma`` the f32 stride-packed and bf16 bitplane kernels). Off those
domains the f32 and bf16 kernels and their plain versions see the same X
(rounded to bf16 identically where they round) and differ only in f32
summation order (rtol=1e-5, atol=1e-3). The SwiGLU kernel and its plain version both round
an f64 sigmoid to f32, which agree but for inputs on an f32 rounding
midpoint; a difference there can move a requantized hidden value by one at
an exact .5 boundary. Such flips must be rare (<= 1e-4 of the elements,
each by 1), and every row without a flip must agree within the fused-FFN
tolerance of the JAX tests (rtol=1e-5, atol=0.01). The SwiGLU's two
branches (split at ``SWIGLU_MMA_MIN_M``; ``-k swiglu``) must give the same
bits as each other. The captured generate loop (``models/graphs.py``; ``-k
"graph or tensor_pos or warmup"``) must give the eager loop's tokens,
greedy and sampled, and with a ring cache (``-k ring_graph``). A serving
bundle loaded with ``device="cuda"`` holds the saved tensors (``-k
bundle``); the bf16 head gives f32 logits within 0.05 of the f32 head
(``-k bf16``). The six torch-op formulations ported last run on CUDA
tensors as on CPU ones (``-k xla_formulation``); autotune measures on the
card, refuses a capturing stream and raises, naming it, a candidate that
fails other than by refusing the shape (``-k autotune_on_card``); the serving
tool serves its ``test`` preset captured (``-k serving_tool``). An exported
layer's backward runs the x8 and dense kernels on its transposed container
bitwise their plain versions (``-k backward_on_transpose``). An MoE
block's experts run those kernels on the card as on the CPU, and the
captured loop holds its decode step (``-k moe``).
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
from ternary_spgemm_tpu_torch.ops import cuda_kernels, fused_ffn
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


def _x8_case(dev, M, K, N, tile_n, tkb, prelu):
    """A TiledBitplane and an X that needs rounding and clamping: 1.3 x
    integers in +-127, and .5 added on every third column (ties that round
    half to even)."""
    fmt = TiledBitplane.from_dense(generate_ternary(K, N, 3, seed=K + N),
                                   tkb=tkb, tile_n=tile_n).to(dev)
    X = 1.3 * torch.from_numpy(generate_x(M, K, seed=M,
                                          value_range=127)).to(dev)
    X[:, ::3] = torch.round(X[:, ::3]) + 0.5
    b = torch.from_numpy(generate_bias(N)).to(dev)
    a = torch.from_numpy(generate_alpha(N)).to(dev) if prelu else None
    return fmt, X, b, a


@pytest.mark.parametrize("M", [1, 5, 64, 100, 300])
@pytest.mark.parametrize("K,N,tile_n,tkb", [
    (100, 77, 128, None), (999, 260, 96, None), (2048, 4100, 4096, None),
    (999, 260, 128, 20), (2048, 77, 96, 20), (999, 300, 100, None)])
@pytest.mark.parametrize("prelu", [False, True])
def test_x8_mma_bitwise(dev, M, K, N, tile_n, tkb, prelu):
    """The x8 kernel's tensor-core branch at any M, bitwise equal to the
    plain version on ragged geometries: K, N off every tile, tile_n not a
    multiple of its 128 columns (nor of 16: 100), tkb = 20 (not a multiple
    of its 32 byte-rows a chunk); two launches give the same Y."""
    fmt, X, b, a = _x8_case(dev, M, K, N, tile_n, tkb, prelu)
    got = ck._bitplane_x8_mma(X, fmt, b, a)
    again = ck._bitplane_x8_mma(X, fmt, b, a)
    want = ck.bitplane_x8_plain(X, fmt, b, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(again, got)


@pytest.mark.parametrize("M", [5, 33])
@pytest.mark.parametrize("K,N,tile_n,tkb", [(999, 260, 96, None),
                                            (2048, 77, 96, 20)])
@pytest.mark.parametrize("prelu", [False, True])
def test_x8_decode_branch_bitwise(dev, M, K, N, tile_n, tkb, prelu):
    """The x8 kernel's decode branch above the rows the wrapper gives it
    (its 8-row tile, and three row tiles of 16), bitwise equal to the plain
    version."""
    fmt, X, b, a = _x8_case(dev, M, K, N, tile_n, tkb, prelu)
    got = ck._bitplane_x8_lanes(X, fmt, b, a)
    want = ck.bitplane_x8_plain(X, fmt, b, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("prelu", [False, True])
def test_x8_dispatch_threshold(dev, prelu):
    """Through the registered wrapper: M = X8_MMA_MIN_M takes the decode
    branch and one more row the tensor-core branch; both bitwise equal to
    the plain version, and each call counted under the kernel's name."""
    for M, mma in ((ck.X8_MMA_MIN_M, 0), (ck.X8_MMA_MIN_M + 1, 1)):
        fmt, X, b, a = _x8_case(dev, M, 2048, 520, 256, None, prelu)
        before = dict(ck.launches)
        got = ck.cuda_tiled_bitplane_x8_kernel(X, fmt, b, a)
        want = ck.bitplane_x8_plain(X, fmt, b, a)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        name = "CudaTiledBitplane_x8"
        assert ck.launches[name] == before.get(name, 0) + 1
        assert ck.launches[ck.X8_MMA_COUNT] == \
            before.get(ck.X8_MMA_COUNT, 0) + mma


#: the i8 kernel's path shapes: the north star, the BitNet-7B
#: up-projection (three N-tiles), the large-M shape, a ragged one
I8_SHAPES = [(32, 1024, 4096, 4), (32, 4096, 11008, 2), (512, 4096, 4096, 2),
             (7, 999, 1000, 3)]


@pytest.mark.parametrize("M,K,N,s", I8_SHAPES)
@pytest.mark.parametrize("prelu", [False, True])
def test_i8_branches_bitwise(dev, M, K, N, s, prelu):
    """Both branches of the i8 kernel at any M, bitwise equal to the plain
    version on integer X at the +-512 edges and on non-integer X (floored),
    with a bias and a PReLU slope that differ per column."""
    fmt = TiledBitplane.from_dense(generate_ternary(K, N, s, seed=K + N)).to(dev)
    g = torch.Generator(device=dev).manual_seed(M + K)
    X = torch.randint(-512, 513, (M, K), generator=g, device=dev).to(
        torch.float32)
    X[:, ::7] = 512.0
    X[:, 3::7] = -512.0
    Xf = 1024.0 * torch.rand((M, K), generator=g, device=dev) - 512.0
    b = 4.0 * torch.rand((N,), generator=g, device=dev) - 2.0
    a = 0.25 * torch.rand((N,), generator=g, device=dev) if prelu else None
    for x in (X, Xf):
        want = ck.bitplane_i8_plain(x, fmt, b, a)
        for fn in (ck._bitplane_i8_lanes, ck._bitplane_i8_mma):
            got = fn(x, fmt, b, a)
            torch.cuda.synchronize()
            assert torch.equal(got, want), fn.__name__


@pytest.mark.parametrize("M", [1, 5, 64, 300])
@pytest.mark.parametrize("K,N,tile_n,tkb", [
    (100, 77, 128, None), (999, 260, 96, None), (999, 260, 128, 20),
    (999, 300, 100, None)])
def test_i8_mma_ragged(dev, M, K, N, tile_n, tkb):
    """The i8 kernel's tensor-core branch on ragged geometries (K, N off
    every tile, tile_n not a multiple of 16, tkb = 20), bitwise; X beyond
    the +-512 domain up to +-4000, where the split is still exact."""
    fmt = TiledBitplane.from_dense(generate_ternary(K, N, 3, seed=K + N),
                                   tkb=tkb, tile_n=tile_n).to(dev)
    g = torch.Generator(device=dev).manual_seed(M)
    X = 8000.0 * torch.rand((M, K), generator=g, device=dev) - 4000.0
    b = torch.from_numpy(generate_bias(N)).to(dev)
    got = ck._bitplane_i8_mma(X, fmt, b)
    want = ck.bitplane_i8_plain(X, fmt, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("K", [2048, 4096])
@pytest.mark.parametrize("prelu", [False, True])
def test_i8_dispatch_threshold(dev, K, prelu):
    """Through the registered wrapper: M = I8_MMA_MIN_M takes the decode
    branch and one more row the tensor-core branch, each counted, at any K;
    ``i8_branch`` names the branch taken."""
    split = ck.I8_MMA_MIN_M
    for M, mma in ((split, 0), (split + 1, 1)):
        assert ck.i8_branch(M, dev) == ("mma" if mma else "decode")
        kern, plain, fmt, X, b, a = _case(dev, "i8", M, K, 520, 256, prelu)
        before = dict(ck.launches)
        got = kern(X, fmt, b, a)
        want = plain(X, fmt, b, a)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        name = "CudaTiledBitplane_i8"
        assert ck.launches[name] == before.get(name, 0) + 1
        assert ck.launches[ck.I8_MMA_COUNT] == \
            before.get(ck.I8_MMA_COUNT, 0) + mma


#: the x8 and i8 decode body (csrc/gemv_core.cuh): decode branch, plain
#: version, X planes staged
GEMV = {"x8": (ck._bitplane_x8_lanes, ck.bitplane_x8_plain, 1),
        "i8": (ck._bitplane_i8_lanes, ck.bitplane_i8_plain, 2)}
#: its odd geometries (K, N, tkb, tile_n): ragged K with tkb = 20 (a walk of
#: 140 byte-rows), three tiles and N off the last; tile_n not a multiple of
#: 4 (byte loads); one K-block of 16 byte-rows in one wide tile
GEMV_GEOMS = [(999, 300, 20, 128), (200, 77, 16, 30), (100, 300, None, 4096)]


def _gemv_case(dev, rule, M, K, N, tkb, tile_n, prelu):
    """A container and an X in the rule's domain: x8 1.3 x integers in
    +-127 with .5 ties on every third column; i8 integers in +-512 with the
    edges on every seventh column."""
    fmt = TiledBitplane.from_dense(generate_ternary(K, N, 3, seed=K + N),
                                   tkb=tkb, tile_n=tile_n).to(dev)
    g = torch.Generator(device=dev).manual_seed(M + K)
    if rule == "x8":
        X = 1.3 * torch.randint(-127, 128, (M, K), generator=g,
                                device=dev).to(torch.float32)
        X[:, ::3] = torch.round(X[:, ::3]) + 0.5
    else:
        X = torch.randint(-512, 513, (M, K), generator=g,
                          device=dev).to(torch.float32)
        X[:, ::7] = 512.0
        X[:, 3::7] = -512.0
    b = 4.0 * torch.rand((N,), generator=g, device=dev) - 2.0
    a = 0.25 * torch.rand((N,), generator=g, device=dev) if prelu else None
    return fmt, X, b, a


@pytest.mark.parametrize("rule", sorted(GEMV))
@pytest.mark.parametrize("M", [1, 4, 5, 8, 16, 17, 33])
@pytest.mark.parametrize("K,N,tkb,tile_n", GEMV_GEOMS)
@pytest.mark.parametrize("prelu", [False, True])
def test_gemv_split_bitwise(dev, rule, M, K, N, tkb, tile_n, prelu):
    """The decode body bitwise equal to the plain version at odd shapes, for
    the rule's parts and for every S in 1..W whose part's X fits (M-tiles
    of 4, 8 and 16; two and three row tiles at 17 and 33)."""
    lanes, plain, planes = GEMV[rule]
    fmt, X, b, a = _gemv_case(dev, rule, M, K, N, tkb, tile_n, prelu)
    want = plain(X, fmt, b, a)
    walk = fmt.plane.shape[0] * fmt.tkb
    lo = -(-walk // fused_ffn.gemv_part_max(M, planes))
    for S in (None, *range(lo, walk + 1)):
        got = lanes(X, fmt, b, a, parts=S)
        assert torch.equal(got, want), S


@pytest.mark.parametrize("rule", sorted(GEMV))
@pytest.mark.parametrize("M", [1, 4, 16, 33])
@pytest.mark.parametrize("K,N,tile_n", [(999, 300, 128), (200, 77, 30),
                                        (4096, 4096, 4096)])
@pytest.mark.parametrize("prelu", [False, True])
def test_gemv_random_plane_bytes(dev, rule, M, K, N, tile_n, prelu):
    """Random plane bytes, pos and neg both set in places (and the tiles'
    padding not zero): both branches bitwise equal to the plain version's
    ``bits(pos) - bits(neg)``."""
    lanes, plain, _ = GEMV[rule]
    fmt, X, b, a = _gemv_case(dev, rule, M, K, N, None, tile_n, prelu)
    g = torch.Generator(device=dev).manual_seed(K)
    fmt = dataclasses.replace(fmt, plane=torch.randint(
        0, 256, tuple(fmt.plane.shape), generator=g, device=dev,
        dtype=torch.uint8))
    want = plain(X, fmt, b, a)
    mma = getattr(ck, f"_bitplane_{rule}_mma")
    for fn in (lanes, mma):
        got = fn(X, fmt, b, a)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__


def test_gemv_counters_return_to_zero(dev):
    """Split calls in a row on the same counters: each leaves them at 0
    (the last part of each tile resets its own) and gives the plain
    version's bits; a call with more tiles grows them."""
    for rule in sorted(GEMV):
        lanes, plain, _ = GEMV[rule]
        for M, N in ((4, 300), (4, 300), (16, 4100), (4, 300)):
            fmt, X, b, _ = _gemv_case(dev, rule, M, 999, N, 20, 128, False)
            want = plain(X, fmt, b)
            for S in (3, 3, 7):
                got = lanes(X, fmt, b, parts=S)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
                counters = ck._GEMV_COUNTERS[(X.device,
                                              ck.stream_handle(X.device))]
                assert int(counters.abs().sum()) == 0


def test_gemv_refuses_bad_parts(dev):
    """Parts outside 1..W, or fewer than the staged X allows, raise before
    any launch."""
    fmt, X, b, _ = _gemv_case(dev, "i8", 16, 4096, 300, None, 4096, False)
    walk = fmt.plane.shape[0] * fmt.tkb
    lo = -(-walk // fused_ffn.gemv_part_max(16, 2))
    assert lo > 1
    before = ck.launches["CudaTiledBitplane_i8"]
    for S in (0, lo - 1, walk + 1):
        with pytest.raises(ValueError, match="parts"):
            ck._bitplane_i8_lanes(X, fmt, b, parts=S)
    assert ck.launches["CudaTiledBitplane_i8"] == before


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


#: the two stages of csrc/dense_mma.cuh: name -> (kernel, plain version,
#: integer |x| range in which every value and partial sum is exact)
DENSE_MMA = {"f32": (ck.cuda_dense_kernel, ck.dense_plain, 512),
             "bf16": (ck.cuda_dense_bf16_kernel, ck.dense_bf16_plain, 256)}
_DENSE_W = {}


def _dense_mma_case(dev, K, N, prelu):
    """A seeded (K, N) DenseTernary of density 1/3 (cached), a bias and a
    PReLU slope that differ from column to column."""
    if (K, N) not in _DENSE_W:
        _DENSE_W[(K, N)] = DenseTernary.from_dense(
            generate_ternary(K, N, 3, seed=K + 7 * N), device=dev)
    rng = np.random.default_rng(N)
    b = torch.from_numpy(rng.uniform(-4, 4, N).astype(np.float32)).to(dev)
    a = (torch.from_numpy(rng.uniform(0.01, 0.5, N).astype(np.float32))
         .to(dev) if prelu else None)
    return _DENSE_W[(K, N)], b, a


@pytest.mark.parametrize("stage", sorted(DENSE_MMA))
@pytest.mark.parametrize("M", [1, 7, 15, 16, 17, 32, 33, 512])
@pytest.mark.parametrize("K,N", [(K, N) for K in (15, 999, 1024, 4096)
                                 for N in (33, 1000, 4096)])
@pytest.mark.parametrize("prelu", [False, True])
def test_dense_mma_tile(dev, stage, M, K, N, prelu):
    """The bf16 tensor-core tile of CudaDense (three pieces) and
    CudaDense_bf16 (one): bitwise equal to the plain version on integer X
    with the domain's edges (every fragment map, both tiles: M <= 32 the
    split-K one, above the 64 x 128 one; K past the last k16 step; N past
    the last n8 fragment and not a multiple of 16, so byte-staged W), and
    within rtol=1e-5, atol=1e-3 on non-integer X uniform in +-2, as
    chip_smoke.py's phase 6 holds them (the tensor cores sum in another
    order than the plain matmul)."""
    kern, plain, vr = DENSE_MMA[stage]
    fmt, b, a = _dense_mma_case(dev, K, N, prelu)
    rng = np.random.default_rng(M * K + N)
    X = rng.integers(-vr, vr + 1, size=(M, K)).astype(np.float32)
    X[0, :: max(1, K // 7)] = vr
    X[-1, 1:: max(1, K // 5)] = -vr
    X = torch.from_numpy(X).to(dev)
    got, want = kern(X, fmt, b, a), plain(X, fmt, b, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    Xf = torch.from_numpy(rng.uniform(-2, 2, (M, K)).astype(np.float32))
    Xf = Xf.to(dev)
    got, want = kern(Xf, fmt, b, a), plain(Xf, fmt, b, a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("stage", sorted(DENSE_MMA))
def test_dense_mma_error_against_f64(dev, stage):
    """At 512 x 4096 x 4096 with X = 1.7 x U(-256, 256) + 0.37 (past the
    bf16 stage's exact range; partial sums up to ~1e4, where two f32
    summation orders differ by more than atol=1e-3), each output against
    the f64 product of the same staged X: the tile's f32 sums (the tensor
    cores' within a group of k-steps, round to nearest across groups) are
    at most twice as far from it as the plain version's f32 matmul."""
    kern, plain, _ = DENSE_MMA[stage]
    M, K, N = 512, 4096, 4096
    fmt, b, _ = _dense_mma_case(dev, K, N, False)
    g = torch.Generator(device=dev).manual_seed(K)
    X = 1.7 * (512.0 * torch.rand((M, K), generator=g, device=dev) - 256.0) \
        + 0.37
    xs = X if stage == "f32" else X.to(torch.bfloat16).to(torch.float32)
    ref = xs.double() @ fmt.dense.double() + b.double()
    got, want = kern(X, fmt, b), plain(X, fmt, b)
    torch.cuda.synchronize()
    err_kernel = float((got.double() - ref).abs().max())
    err_plain = float((want.double() - ref).abs().max())
    assert err_kernel <= 2.0 * err_plain, (err_kernel, err_plain)


@pytest.mark.parametrize("stage", sorted(DENSE_MMA))
@pytest.mark.parametrize("M", [7, 33])
def test_dense_mma_non_finite(dev, stage, M):
    """inf, -inf and NaN in X give the plain version's non-finite cells
    (inf * 0 is NaN in both: the pieces after an infinite one are 0) and
    leave the other rows bitwise equal."""
    kern, plain, vr = DENSE_MMA[stage]
    K, N = 999, 1000
    fmt, b, _ = _dense_mma_case(dev, K, N, False)
    X = torch.from_numpy(generate_x(M, K, seed=M, value_range=vr)).to(dev)
    X[0, 5] = float("inf")
    X[1, 900] = float("-inf")
    X[2, 17] = float("nan")
    X[3, 3] = float("inf")
    X[3, 4] = float("-inf")
    got, want = kern(X, fmt, b), plain(X, fmt, b)
    torch.cuda.synchronize()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want))
    assert bool(torch.isnan(want[2]).all())
    fin = torch.isfinite(want)
    assert torch.equal(got[fin], want[fin])
    assert torch.equal(got[4:], want[4:])


@pytest.mark.parametrize("stage", sorted(DENSE_MMA))
@pytest.mark.parametrize("M,K,N", [(32, 1024, 4096), (512, 1024, 1000)])
def test_dense_mma_deterministic(dev, stage, M, K, N):
    """20 back-to-back launches on non-integer X give the same bits: every
    sum of the tile (the fragments, the chunks, the split-K's warps) has a
    fixed order."""
    kern = DENSE_MMA[stage][0]
    fmt, b, a = _dense_mma_case(dev, K, N, True)
    g = torch.Generator(device=dev).manual_seed(M)
    X = 4.0 * torch.rand((M, K), generator=g, device=dev) - 2.0
    first = kern(X, fmt, b, a)
    again = [kern(X, fmt, b, a) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, first) for y in again)


#: the int8-X kernels on csrc/dense_mma.cuh's tile over the slab layout:
#: name -> (kernel, plain version, container class, packer arguments,
#: |x| domain); the tiled containers with tile_n = 256, so that gn > 1
PACKED_MMA = {
    "tiled_dense_i8": (ck.cuda_tiled_dense_i8_kernel,
                       ck.tiled_dense_i8_plain, TiledDenseTernary,
                       {"tile_n": 256}, 512),
    "tiled_dense_x8": (ck.cuda_tiled_dense_x8_kernel,
                       ck.tiled_dense_x8_plain, TiledDenseTernary,
                       {"tile_n": 256}, 127),
    "dense_i8": (ck.cuda_dense_i8_kernel, ck.dense_i8_plain, DenseTernary,
                 {}, 512),
    "blockpacked_i8_f4": (ck.cuda_blockpacked_i8_kernel,
                          ck.blockpacked_i8_plain, BlockPackedTernary,
                          {"factor": 4}, 512),
    "blockpacked_i8_f5": (ck.cuda_blockpacked_i8_kernel,
                          ck.blockpacked_i8_plain, BlockPackedTernary,
                          {"factor": 5}, 512),
    "tiled_blockpacked_i8_f4": (ck.cuda_tiled_blockpacked_i8_kernel,
                                ck.tiled_blockpacked_i8_plain,
                                TiledBlockPacked,
                                {"factor": 4, "tile_n": 256}, 512),
    "tiled_blockpacked_i8_f5": (ck.cuda_tiled_blockpacked_i8_kernel,
                                ck.tiled_blockpacked_i8_plain,
                                TiledBlockPacked,
                                {"factor": 5, "tile_n": 256}, 512),
    "packed2_i8": (ck.cuda_packed2_i8_kernel, ck.packed2_i8_plain,
                   PackedTernary2Bit, {}, 512),
    "packed53_i8": (ck.cuda_packed53_i8_kernel, ck.packed53_i8_plain,
                    PackedTernary53, {}, 512),
    "nibble_i8": (ck.cuda_tiled_nibblepair_i8_kernel, ck.nibblepair_i8_plain,
                  TiledNibblePair, {"tile_n": 256}, 512),
}
_PACKED_W = {}


def _packed_mma_case(dev, name, M, K, N, prelu):
    """The kernel, its plain version, the container of a seeded (K, N)
    ternary W of density 1/3 (cached), integer X with the domain's edges,
    non-integer X (x8: past its clamp), a bias and a PReLU slope that
    differ from column to column."""
    kern, plain, cls, kw, vr = PACKED_MMA[name]
    key = (name, K, N)
    if key not in _PACKED_W:
        _PACKED_W[key] = cls.from_dense(
            generate_ternary(K, N, 3, seed=K + 7 * N), **kw).to(dev)
    rng = np.random.default_rng(M * K + N)
    X = rng.integers(-vr, vr + 1, size=(M, K)).astype(np.float32)
    X[0, :: max(1, K // 7)] = vr
    X[-1, 1:: max(1, K // 5)] = -vr
    hi = 1.3 * vr if vr == 127 else vr - 0.01
    Xf = rng.uniform(-hi, hi, (M, K)).astype(np.float32)
    b = torch.from_numpy(rng.uniform(-4, 4, N).astype(np.float32)).to(dev)
    a = (torch.from_numpy(rng.uniform(0.01, 0.5, N).astype(np.float32))
         .to(dev) if prelu else None)
    return (kern, plain, _PACKED_W[key], torch.from_numpy(X).to(dev),
            torch.from_numpy(Xf).to(dev), b, a)


@pytest.mark.parametrize("name", sorted(PACKED_MMA))
@pytest.mark.parametrize("M", [1, 7, 16, 17, 32, 33, 512])
@pytest.mark.parametrize("K,N", [(100, 1000), (999, 1000), (1024, 4096),
                                 (4096, 520)])
@pytest.mark.parametrize("prelu", [False, True])
def test_packed_mma_tile(dev, name, M, K, N, prelu):
    """The int8-X kernels on the bf16 tensor-core tile, bitwise equal to the
    plain version on integer X with the domain's edges and on non-integer X
    (the rules round or floor it to integers), in every geometry (the
    split-K ones, 16 x 32 up to M = 16 and 32 x 32 up to 32, the 64 x 128
    one above), on the ragged edges: TiledDense
    at K = 100 (tile_k = 128, under the Narrow tile's 256-row chunk), the
    stride-packed fields at K = 999 (tkq = 250 and 200, not multiples of
    16), BlockPacked at N = 1000 (byte-staged W), several slabs (gn > 1),
    the nibbles' tkb = 16 under the 32-row chunk at K = 100 and K = 999 in
    one block of 1024 rows."""
    kern, plain, fmt, X, Xf, b, a = _packed_mma_case(dev, name, M, K, N,
                                                     prelu)
    for x in (X, Xf):
        got, want = kern(x, fmt, b, a), plain(x, fmt, b, a)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["tiled_dense_i8", "tiled_dense_x8",
                                  "packed53_i8"])
@pytest.mark.parametrize("M", [7, 33])
def test_packed_mma_non_finite(dev, name, M):
    """inf, -inf and NaN in X give the plain version's cells: x8 clamps
    the infinities (NaN stays NaN, as torch.clamp keeps it); i8 keeps them,
    and inf * 0 is NaN in both (the second piece of an infinite one is
    0); the other rows stay bitwise equal."""
    kern, plain, fmt, X, _, b, _ = _packed_mma_case(dev, name, M, 999, 1000,
                                                    False)
    X = X.clone()
    X[0, 5] = float("inf")
    X[1, 900] = float("-inf")
    X[2, 17] = float("nan")
    X[3, 3] = float("inf")
    X[3, 4] = float("-inf")
    got, want = kern(X, fmt, b), plain(X, fmt, b)
    torch.cuda.synchronize()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want))
    assert bool(torch.isnan(want[2]).all())
    fin = torch.isfinite(want)
    assert torch.equal(got[fin], want[fin])
    assert torch.equal(got[4:], want[4:])


@pytest.mark.parametrize("M", [1, 7, 17, 33])
@pytest.mark.parametrize("prelu", [False, True])
def test_nibble_mma_byte_staged_and_deterministic(dev, M, prelu):
    """CudaTiledNibblePair_i8 at N = 130 (4 * N bytes a word row, not a
    multiple of 16: the words staged byte by byte, each column masked) over
    two slabs of 128 columns and K = 999 with tkb = 32 (four K-blocks, the
    last one ragged): bitwise equal to the plain version on integer X
    with the +-512 edges and on non-integer X, and the same bits over 20
    back-to-back launches."""
    K, N = 999, 130
    fmt = TiledNibblePair.from_dense(generate_ternary(K, N, 3, seed=M),
                                     tkb=32, tile_n=128).to(dev)
    assert fmt.words.shape[:2] == (4, 2)
    rng = np.random.default_rng(M)
    X = rng.integers(-512, 513, size=(M, K)).astype(np.float32)
    X[:, ::7], X[:, 3::7] = 512.0, -512.0
    Xf = rng.uniform(-511.99, 511.99, (M, K)).astype(np.float32)
    b = torch.from_numpy(rng.uniform(-4, 4, N).astype(np.float32)).to(dev)
    a = (torch.from_numpy(rng.uniform(0.01, 0.5, N).astype(np.float32))
         .to(dev) if prelu else None)
    kern, plain = ck.cuda_tiled_nibblepair_i8_kernel, ck.nibblepair_i8_plain
    for x in (torch.from_numpy(X).to(dev), torch.from_numpy(Xf).to(dev)):
        first = kern(x, fmt, b, a)
        again = [kern(x, fmt, b, a) for _ in range(20)]
        want = plain(x, fmt, b, a)
        torch.cuda.synchronize()
        assert torch.equal(first, want)
        assert all(torch.equal(y, first) for y in again)


#: the float-X kernels over the code and bit-plane layouts of
#: csrc/dense_mma.cuh's tile: name -> (kernel, plain version, container
#: class, packer arguments, integer |x| range in which every value and
#: partial sum is exact, the X rule's stage); the bit planes with tile_n
#: 128 and 256, so that gn > 1
FLOAT_MMA = {
    "packed2": (ck.cuda_packed2_kernel, ck.packed2_plain, PackedTernary2Bit,
                {}, 512, "f32"),
    "packed53": (ck.cuda_packed53_kernel, ck.packed53_plain, PackedTernary53,
                 {}, 512, "f32"),
    "bitplane_bf16": (ck.cuda_tiled_bitplane_bf16_kernel,
                      ck.bitplane_bf16_plain, TiledBitplane,
                      {"tile_n": 256}, 256, "bf16"),
    "bitplane_bf16_t128": (ck.cuda_tiled_bitplane_bf16_kernel,
                           ck.bitplane_bf16_plain, TiledBitplane,
                           {"tile_n": 128}, 256, "bf16"),
}
_FLOAT_W = {}


def _float_mma_case(dev, name, M, K, N, prelu):
    """The kernel, its plain version, the container of a seeded (K, N)
    ternary W of density 1/3 (cached), integer X with the exact range's
    edges, non-integer X uniform in +-2, a bias and a PReLU slope that
    differ from column to column."""
    kern, plain, cls, kw, vr, _ = FLOAT_MMA[name]
    key = (name, K, N)
    if key not in _FLOAT_W:
        _FLOAT_W[key] = cls.from_dense(
            generate_ternary(K, N, 3, seed=K + 7 * N), **kw).to(dev)
    rng = np.random.default_rng(M * K + N)
    X = rng.integers(-vr, vr + 1, size=(M, K)).astype(np.float32)
    X[0, :: max(1, K // 7)] = vr
    X[-1, 1:: max(1, K // 5)] = -vr
    Xf = rng.uniform(-2, 2, (M, K)).astype(np.float32)
    b = torch.from_numpy(rng.uniform(-4, 4, N).astype(np.float32)).to(dev)
    a = (torch.from_numpy(rng.uniform(0.01, 0.5, N).astype(np.float32))
         .to(dev) if prelu else None)
    return (kern, plain, _FLOAT_W[key], torch.from_numpy(X).to(dev),
            torch.from_numpy(Xf).to(dev), b, a)


@pytest.mark.parametrize("name", sorted(FLOAT_MMA))
@pytest.mark.parametrize("M", [1, 7, 16, 17, 32, 33, 512])
@pytest.mark.parametrize("K,N", [(100, 1000), (999, 1000), (1024, 4096),
                                 (4096, 520)])
@pytest.mark.parametrize("prelu", [False, True])
def test_float_mma_tile(dev, name, M, K, N, prelu):
    """The f32 stride-packed kernels (three bf16 pieces) and the bf16
    bitplane kernel (one) on the bf16 tensor-core tile, in every geometry
    (16 x 32 up to M = 16, 32 x 32 up to 32, 64 x 128 above), on the ragged
    edges (the stride-packed fields' tkq = 25, 250, 256 and 1024 at factor
    4, 20, 200, 205 and 820 at factor 5; the bit planes' tkb = 16 at K =
    100, under the 32-byte-row chunk; N = 1000 and 520, byte-staged W,
    several slabs):
    bitwise equal to the plain version on integer X with the exact range's
    edges (+-512 for f32, +-256 for bf16), within rtol=1e-5, atol=1e-3 on
    non-integer X (the tensor cores sum in another order than the plain
    matmul), and the same bits from a second launch."""
    kern, plain, fmt, X, Xf, b, a = _float_mma_case(dev, name, M, K, N,
                                                    prelu)
    got, want = kern(X, fmt, b, a), plain(X, fmt, b, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got, want, again = kern(Xf, fmt, b, a), plain(Xf, fmt, b, a), \
        kern(Xf, fmt, b, a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert torch.equal(got, again)


@pytest.mark.parametrize("name", sorted(FLOAT_MMA))
@pytest.mark.parametrize("M", [7, 33])
def test_float_mma_non_finite(dev, name, M):
    """inf, -inf and NaN in X give the plain version's non-finite cells
    (inf * 0 is NaN in both: the pieces after an infinite one are 0) and
    leave the other rows bitwise equal."""
    kern, plain, fmt, X, _, b, _ = _float_mma_case(dev, name, M, 999, 1000,
                                                   False)
    X = X.clone()
    X[0, 5] = float("inf")
    X[1, 900] = float("-inf")
    X[2, 17] = float("nan")
    X[3, 3] = float("inf")
    X[3, 4] = float("-inf")
    got, want = kern(X, fmt, b), plain(X, fmt, b)
    torch.cuda.synchronize()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want))
    assert bool(torch.isnan(want[2]).all())
    fin = torch.isfinite(want)
    assert torch.equal(got[fin], want[fin])
    assert torch.equal(got[4:], want[4:])


@pytest.mark.parametrize("name", sorted(FLOAT_MMA))
@pytest.mark.parametrize("M,K,N", [(32, 1024, 4096), (512, 1024, 1000)])
def test_float_mma_deterministic(dev, name, M, K, N):
    """20 back-to-back launches on non-integer X give the same bits: every
    sum of the tile (the groups of k-steps, the chunks, the split-K's
    warps) has a fixed order."""
    kern, _, fmt, _, Xf, b, a = _float_mma_case(dev, name, M, K, N, True)
    first = kern(Xf, fmt, b, a)
    again = [kern(Xf, fmt, b, a) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, first) for y in again)


@pytest.mark.parametrize("name", sorted(FLOAT_MMA))
def test_float_mma_error_against_f64(dev, name):
    """At 512 x 4096 x 4096 with X = 1.7 x U(-256, 256) + 0.37 (past the
    exact ranges; partial sums up to ~1e4, where two f32 summation orders
    differ by more than atol=1e-3), each output against the f64 product of
    the same staged X: the tile's f32 sums (the tensor cores' within a
    group of at most four k-steps, round to nearest across groups) are at
    most twice as far from it as the plain version's f32 matmul."""
    kern, plain, _, _, _, stage = FLOAT_MMA[name]
    M, K, N = 512, 4096, 4096
    _, _, fmt, _, _, b, _ = _float_mma_case(dev, name, 1, K, N, False)
    g = torch.Generator(device=dev).manual_seed(K)
    X = 1.7 * (512.0 * torch.rand((M, K), generator=g, device=dev) - 256.0) \
        + 0.37
    xs = X if stage == "f32" else X.to(torch.bfloat16).to(torch.float32)
    ref = xs.double() @ fmt.to_dense().double() + b.double()
    got, want = kern(X, fmt, b), plain(X, fmt, b)
    torch.cuda.synchronize()
    err_kernel = float((got.double() - ref).abs().max())
    err_plain = float((want.double() - ref).abs().max())
    assert err_kernel <= 2.0 * err_plain, (err_kernel, err_plain)


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


def _swiglu_case(dev, M, K, N1, N2, tile_n, s=2):
    fg, fu = (TiledBitplane.from_dense(generate_ternary(K, N1, s, seed=sd),
                                       tile_n=tile_n).to(dev)
              for sd in (1, 2))
    fd = TiledBitplane.from_dense(generate_ternary(N1, N2, s, seed=3)).to(dev)
    x = torch.from_numpy(generate_x(M, K, seed=4)).to(dev)
    xq, sx = requantize_rows(x)
    return xq, sx, fg, fu, fd


@pytest.mark.parametrize("M,K,N1,N2,tile_n", [
    (fused_ffn.SWIGLU_MMA_MIN_M + 1, 4096, 11008, 4096, 4096),
    (128, 4096, 11008, 4096, 4096), (200, 4096, 11008, 4096, 4096),
    (512, 4096, 11008, 4096, 4096),
    (fused_ffn.SWIGLU_MMA_MIN_M + 1, 200, 300, 96, 128),
    (130, 200, 300, 96, 128)])
def test_swiglu_branches_bitwise(dev, M, K, N1, N2, tile_n):
    """The SwiGLU's decode and tensor-core branches give the same y, h and
    rmax bit for bit (exact integer sums, the same epilogue expressions),
    at BitNet-7B width and at odd widths (gn1 = 3, N2 = 96); the wrapper
    takes the tensor-core branch there, counted."""
    xq, sx, fg, fu, fd = _swiglu_case(dev, M, K, N1, N2, tile_n)
    kw = dict(gamma_gate=0.021, gamma_up=0.034, gamma_down=1.7)
    lanes = fused_ffn._swiglu_lanes(xq, sx, fg, fu, fd, **kw)
    before = ck.launches[fused_ffn.SWIGLU_MMA_COUNT]
    mma = swiglu_launch(xq, sx, fg, fu, fd, **kw)
    torch.cuda.synchronize()
    assert ck.launches[fused_ffn.SWIGLU_MMA_COUNT] == before + 1
    for got, want, what in zip(mma, lanes, ("y", "h", "rmax")):
        assert torch.equal(got, want), what


@pytest.mark.parametrize("M", [1, 2, 3, 4])
@pytest.mark.parametrize("K,N1,N2,tile_n", [(4096, 11008, 4096, 4096),
                                            (200, 300, 96, 128)])
def test_swiglu_decode_split_bitwise(dev, M, K, N1, N2, tile_n):
    """The SwiGLU's decode branch as a split walk (its rule's parts, and
    other parts: unsplit, two, a walk's worth) gives y, h and rmax bit for
    bit equal to the tensor-core branch at the same M, and the same bits
    over two launches; at BitNet-7B width (S = 3 and 4 on an H100) and at
    odd widths (gn1 = 3, N2 = 96, walks of one and two chunks)."""
    xq, sx, fg, fu, fd = _swiglu_case(dev, M, K, N1, N2, tile_n)
    kw = dict(gamma_gate=0.021, gamma_up=0.034, gamma_down=1.7)
    want = fused_ffn._swiglu_mma(xq, sx, fg, fu, fd, **kw)
    walks = [fused_ffn.split_walk(f.plane.shape[0], f.tkb) for f in (fg, fd)]
    before = ck.launches[fused_ffn.KERNEL_NAME]
    runs = [fused_ffn.swiglu_launch(xq, sx, fg, fu, fd, **kw)
            for _ in range(2)]
    for parts in ((1, 1), (min(2, walks[0]), min(2, walks[1])),
                  tuple(walks)):
        runs.append(fused_ffn._swiglu_lanes(xq, sx, fg, fu, fd, parts=parts,
                                            **kw))
    torch.cuda.synchronize()
    assert ck.launches[fused_ffn.KERNEL_NAME] == before + 5
    for got in runs:
        for g, w, what in zip(got, want, ("y", "h", "rmax")):
            assert torch.equal(g, w), what


def test_swiglu_decode_refuses_bad_parts(dev):
    """Parts outside 1..the walk's chunks raise before any launch."""
    xq, sx, fg, fu, fd = _swiglu_case(dev, 4, 200, 300, 96, 128)
    walk = fused_ffn.split_walk(fd.plane.shape[0], fd.tkb)
    for parts in ((0, 1), (1, walk + 1)):
        with pytest.raises(ValueError, match="parts"):
            fused_ffn._swiglu_lanes(xq, sx, fg, fu, fd, parts=parts)


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


#: the three ELL layouts of csrc/ell_core.cuh: name -> (kernel, plain
#: version, packer, whether the X rule floors); tile_n 128 gives a tile of
#: its own to the dense column below
ELL_LAYOUTS = {
    "deposit": (ck.cuda_ell_deposit_i8_kernel, ck.ell_deposit_i8_plain,
                lambda W: TiledEllDeposit.from_dense(W, tile_n=128), True),
    "tiled": (ck.cuda_tiled_ell_kernel, ck.tiled_ell_plain,
              lambda W: TiledEllTCSC.from_dense(W, tile_n=128), False),
    "blocked": (ck.cuda_ell_gather_kernel, ck.ell_gather_plain,
                BlockedEllTCSC.from_dense, False),
}


def _ell_weights(K, N, s):
    """A ternary W with, among sparse columns, one dense column (its tile's
    cap reaches the block, the early exit's worst case for its warps), a
    run of empty columns and a column empty in its first half (sections
    with no nonzeros in some columns)."""
    W = generate_ternary(K, N, s, seed=K + N + s)
    W[:, 5] = np.where(np.arange(K) % 3 == 0, -1, 1)
    W[:, 40:45] = 0
    W[:K // 2, 70] = 0
    return W


@pytest.mark.parametrize("layout", sorted(ELL_LAYOUTS))
@pytest.mark.parametrize("M", [1, 4, 5, 17, 32, 33, 512])
@pytest.mark.parametrize("K,N,s", [(999, 300, 16), (1000, 4100, 3)])
def test_ell_walk_bitwise(dev, layout, M, K, N, s):
    """The ELL kernels' early-exit walk over the three layouts, bitwise
    equal to the plain versions on integer X at the +-512 edges (PReLU off
    and on, a bias and slope that differ per column); on non-integer X the
    deposit floors (bitwise), the f32 gathers agree within rtol=1e-5,
    atol=1e-3. K is off every block (248, 127, 128) and a multiple of 4 or
    not (the 4- and 16-byte X copies); N is off 32."""
    kern, plain, pack, floors = ELL_LAYOUTS[layout]
    fmt = pack(_ell_weights(K, N, s)).to(dev)
    g = torch.Generator(device=dev).manual_seed(M + K)
    X = torch.randint(-512, 513, (M, K), generator=g, device=dev).to(
        torch.float32)
    X[:, ::7] = 512.0
    X[:, 3::7] = -512.0
    Xf = (1024.0 * torch.rand((M, K), generator=g, device=dev) - 512.0
          if floors else 4.0 * torch.rand((M, K), generator=g, device=dev)
          - 2.0)
    b = 4.0 * torch.rand((N,), generator=g, device=dev) - 2.0
    a = 0.25 * torch.rand((N,), generator=g, device=dev)
    for alpha in (None, a):
        got = kern(X, fmt, b, alpha)
        want = plain(X, fmt, b, alpha)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        got = kern(Xf, fmt, b, alpha)
        want = plain(Xf, fmt, b, alpha)
        torch.cuda.synchronize()
        if floors:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("layout", sorted(ELL_LAYOUTS))
def test_ell_x_off_16_bytes(dev, layout):
    """X whose rows are not on 16-byte boundaries (a contiguous view 4
    bytes into its buffer, K a multiple of 4) takes the 4-byte copies;
    bitwise equal to the plain version."""
    kern, plain, pack, _ = ELL_LAYOUTS[layout]
    M, K, N = 9, 1000, 300
    fmt = pack(_ell_weights(K, N, 4)).to(dev)
    buf = torch.from_numpy(generate_x(1, M * K + 1, seed=3)).to(dev)
    X = buf.view(-1)[1:].view(M, K)
    assert X.is_contiguous() and X.data_ptr() % 16 != 0
    b = torch.from_numpy(generate_bias(N)).to(dev)
    got = kern(X, fmt, b)
    want = plain(X, fmt, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N1,N2,tile_n", [
    (1, 100, 256, 128, 4096), (8, 128, 1152, 128, 4096),
    (33, 96, 384, 96, 4096), (128, 384, 300, 256, 128),
    (32, 1024, 4096, 1024, 4096)])
@pytest.mark.parametrize("prelu2", [False, True])
def test_prelu_ffn_kernel(dev, M, K, N1, N2, tile_n, prelu2):
    """The fused PReLU FFN: the hidden state, its requantized values and
    the output bitwise equal to the plain version's (the phase-2 epilogue
    rounds its multiplies and adds as the plain version does)."""
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        ffn_hidden_plain, ffn_launch, ffn_plain)

    f1 = TiledBitplane.from_dense(generate_ternary(K, N1, 4, seed=0),
                                  tile_n=tile_n).to(dev)
    f2 = TiledBitplane.from_dense(generate_ternary(N1, N2, 4, seed=1)).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=2)).to(dev)
    b1 = torch.from_numpy(generate_bias(N1)).to(dev)
    a1 = torch.from_numpy(generate_alpha(N1)).to(dev)
    b2 = torch.from_numpy(generate_bias(N2)).to(dev)
    a2 = torch.from_numpy(generate_alpha(N2)).to(dev) if prelu2 else None
    kw = dict(gamma1=0.037, gamma2=1.9)
    y, h, rmax = ffn_launch(X, f1, b1, a1, f2, b2, a2, **kw)
    h_plain = ffn_hidden_plain(X, f1, b1, a1, gamma1=0.037)
    want = ffn_plain(X, f1, b1, a1, f2, b2, a2, **kw)
    hq = torch.round(h / true_div(rmax[:, None] + 1e-12, 127.0))
    hq_plain, _ = requantize_rows(h_plain)
    torch.cuda.synchronize()
    assert torch.equal(h, h_plain)
    assert torch.equal(hq, hq_plain)
    assert torch.equal(y, want)


#: (M, K, N1, N2, tile_n1): ragged hidden widths, tile_n1 30 (byte loads
#: in phase 1) and N1 not a multiple of 128; the ffn_bench block
FFN_SPLIT_GEOMS = [(1, 200, 300, 96, 30), (4, 999, 260, 77, 4096),
                   (16, 200, 300, 96, 30), (33, 999, 260, 77, 4096),
                   (32, 1024, 4096, 1024, 4096)]


def _ffn_case(dev, M, K, N1, N2, tile_n1, seed=0):
    f1 = TiledBitplane.from_dense(generate_ternary(K, N1, 3, seed=seed + K),
                                  tile_n=tile_n1).to(dev)
    f2 = TiledBitplane.from_dense(generate_ternary(N1, N2, 3,
                                                   seed=seed + N1)).to(dev)
    g = torch.Generator(device=dev).manual_seed(M + K)
    X = torch.randint(-512, 513, (M, K), generator=g,
                      device=dev).to(torch.float32)
    X[:, ::7] = 512.0
    X[:, 3::7] = -512.0
    b1, b2 = (4.0 * torch.rand((n,), generator=g, device=dev) - 2.0
              for n in (N1, N2))
    a1, a2 = (0.25 * torch.rand((n,), generator=g, device=dev)
              for n in (N1, N2))
    return X, f1, b1, a1, f2, b2, a2


@pytest.mark.parametrize("M,K,N1,N2,tile_n1", FFN_SPLIT_GEOMS)
@pytest.mark.parametrize("prelu2", [False, True])
def test_prelu_ffn_split_bitwise(dev, M, K, N1, N2, tile_n1, prelu2):
    """Both phases on the decode body at forced parts (S1, S2) in {1, 2, 4,
    8}^2 (those the walks and the staged X allow) and at the rule's: h, the
    requantized h, rmax and y bitwise the plain version's; one launch
    counted a call."""
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        FFN_KERNEL_NAME, ffn_hidden_plain, ffn_launch, ffn_plain)

    X, f1, b1, a1, f2, b2, a2 = _ffn_case(dev, M, K, N1, N2, tile_n1)
    a2 = a2 if prelu2 else None
    kw = dict(gamma1=0.037, gamma2=1.9)
    want = ffn_plain(X, f1, b1, a1, f2, b2, a2, **kw)
    h_plain = ffn_hidden_plain(X, f1, b1, a1, gamma1=0.037)
    hq_plain, _ = requantize_rows(h_plain)
    rmax_plain = h_plain.abs().amax(1)
    ok = []
    for (f, planes) in ((f1, 2), (f2, 1)):
        walk = f.plane.shape[0] * f.tkb
        lo = -(-walk // fused_ffn.gemv_part_max(M, planes))
        ok.append([S for S in (1, 2, 4, 8) if lo <= S <= walk])
    before = ck.launches[FFN_KERNEL_NAME]
    runs = [None, *((s1, s2) for s1 in ok[0] for s2 in ok[1])]
    for parts in runs:
        y, h, rmax = ffn_launch(X, f1, b1, a1, f2, b2, a2, **kw, parts=parts)
        hq = torch.round(h / true_div(rmax[:, None] + 1e-12, 127.0))
        torch.cuda.synchronize()
        assert torch.equal(h, h_plain), parts
        assert torch.equal(rmax, rmax_plain), parts
        assert torch.equal(hq, hq_plain), parts
        assert torch.equal(y, want), parts
    assert ck.launches[FFN_KERNEL_NAME] == before + len(runs)


def test_prelu_ffn_counters_and_bad_parts(dev):
    """Split FFN calls in a row leave the decode body's counters at 0 (phase
    1's folding blocks reset them before phase 2), between x8 / i8 calls
    on the same stream; parts the walk or the staged X refuse raise before
    any launch."""
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        FFN_KERNEL_NAME, ffn_launch, ffn_plain)

    X, f1, b1, a1, f2, b2, a2 = _ffn_case(dev, 16, 999, 260, 77, 4096)
    fmt, Xi, bi, _ = _gemv_case(dev, "i8", 4, 999, 300, 20, 128, False)
    want = ffn_plain(X, f1, b1, a1, f2, b2, a2)
    want_i = ck.bitplane_i8_plain(Xi, fmt, bi)
    for parts in ((3, 5), (8, 8), (3, 5)):
        y = ffn_launch(X, f1, b1, a1, f2, b2, a2, parts=parts)[0]
        yi = ck._bitplane_i8_lanes(Xi, fmt, bi, parts=7)
        torch.cuda.synchronize()
        assert torch.equal(y, want) and torch.equal(yi, want_i)
        counters = ck._GEMV_COUNTERS[(X.device, ck.stream_handle(X.device))]
        assert int(counters.abs().sum()) == 0
    walk2 = f2.plane.shape[0] * f2.tkb
    before = ck.launches[FFN_KERNEL_NAME]
    for parts in ((0, 1), (1, walk2 + 1)):
        with pytest.raises(ValueError, match="parts"):
            ffn_launch(X, f1, b1, a1, f2, b2, a2, parts=parts)
    assert ck.launches[FFN_KERNEL_NAME] == before


def test_prelu_ffn_contract_on_card(dev):
    from ternary_spgemm_tpu_torch.ops.fused_ffn import fused_bitplane_ffn

    f1 = TiledBitplane.from_dense(generate_ternary(128, 256, 4, seed=0)).to(dev)
    f2 = TiledBitplane.from_dense(generate_ternary(256, 128, 4, seed=1),
                                  tile_n=64).to(dev)
    b1, b2 = torch.zeros(256, device=dev), torch.zeros(128, device=dev)
    with pytest.raises(ValueError, match="OUTPUT"):
        fused_bitplane_ffn(torch.zeros((4, 128), device=dev), f1, b1, None,
                           f2, b2)
    f2 = TiledBitplane.from_dense(generate_ternary(256, 128, 4, seed=1)).to(dev)
    with pytest.raises(ValueError, match="serving-M"):
        fused_bitplane_ffn(torch.zeros((129, 128), device=dev), f1, b1, None,
                           f2, b2)


@pytest.mark.parametrize("layout,tk,tn,gk,gn", [
    ("tiled4d", 256, 4096, 3, 2), ("tiled4d", 16, 256, 5, 7),
    ("rowmajor", 256, 4096, 2, 3), ("rowmajor", 5, 8192, 3, 1),
    ("rowmajor", 8, 12288, 2, 2)])
def test_stream_kernel(dev, layout, tk, tn, gk, gn):
    """The streaming probe's checksum bitwise equal to the plain version's,
    for both layouts (the buckets depend on the bytes alone), with tiles
    cut into several blocks' runs (runs that start inside a tile row at
    12288-byte rows)."""
    from ternary_spgemm_tpu_torch.tools import membench

    arr = membench.make_array(gk, gn, tk, tn, layout, dev, seed=gk + tn)
    x = torch.arange(1024, dtype=torch.int32, device=dev).reshape(8, 128)
    got = membench.stream_checksum(arr, tk, tn, layout, x)
    want = membench.stream_plain(arr, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    narrow = torch.zeros((4, 2048), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="4096"):
        membench.stream_checksum(narrow, 4, 2048, "rowmajor", x)


@pytest.mark.parametrize("tkb,tns,reps,blocks", [
    (128, 512, 4, 1), (128, 512, 3, 132), (16, 96, 5, 3), (20, 130, 300, 2)])
def test_decode_rate_kernel(dev, tkb, tns, reps, blocks):
    """The decode-rate probe bitwise equal to its plain version, on random
    X in [-127, 127] (which checks the row map and the hi / lo split) and
    on the all-ones X the tool uses; tkb not a multiple of the 8 warps, tns
    not of 4 or of the 128-column tiles, and more than 256 repetitions
    (the perturbation wraps)."""
    from ternary_spgemm_tpu_torch.tools import decode_roofline as dr

    plane, ones = dr.probe_inputs(tkb, tns, dev, seed=tkb + reps)
    g = torch.Generator(device=dev).manual_seed(reps)
    x = torch.randint(-127, 128, ones.shape, generator=g, device=dev,
                      dtype=torch.int32)
    for xx in (x, ones):
        got = dr.decode_rate(plane, xx, reps, blocks)
        want = dr.decode_rate_plain(plane, xx, reps)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["full", "staticcap", "nogather", "noslots"])
@pytest.mark.parametrize("M,K,N,s,tile_n", [
    (5, 600, 300, 4, 128), (33, 1000, 520, 16, 256),
    (32, 2048, 4096, 16, 4096), (32, 16384, 4096, 16, 4096),
    (32, 4096, 16384, 16, 4096)])
def test_deposit_variant_kernel(dev, mode, M, K, N, s, tile_n):
    """Every rung of the deposit ladder bitwise equal to its plain version,
    up to the deposit study's two large configs; full and staticcap equal
    to the registered kernel too."""
    from ternary_spgemm_tpu_torch.tools import deposit_study as ds

    fmt = TiledEllDeposit.from_dense(generate_ternary(K, N, s, seed=K),
                                     tile_n=tile_n).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=M)).to(dev)
    b = torch.from_numpy(generate_bias(N)).to(dev)
    got = ds.deposit_variant(X, fmt, b, mode=mode)
    want = ds.deposit_variant_plain(X, fmt, b, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if mode in ("full", "staticcap"):
        assert torch.equal(got, ck.cuda_ell_deposit_i8_kernel(X, fmt, b))


@pytest.mark.parametrize("entries", [0, 1, 4096, 4097, 65536])
def test_scalar_deposit_kernel(dev, entries):
    """The ragged probe's tile bitwise equal to its plain version, within
    one staged chunk of entries and across several."""
    from ternary_spgemm_tpu_torch.tools import ragged_probe as rp

    ents = torch.from_numpy(rp.scalar_entries(entries)).to(dev)
    got = rp.scalar_deposit_launch(ents)
    want = rp.scalar_deposit_plain(ents)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("ranks,mc,K,NL", [
    (1, 8, 64, 128), (2, 8, 64, 128), (3, 16, 100, 70), (4, 8, 64, 128),
    (8, 8, 64, 128), (2, 72, 1000, 130), (8, 64, 4096, 192),
    (2, 24, 999, 33), (2, 256, 4096, 512)])
def test_ring_kernel(dev, ranks, mc, K, NL):
    """The ring's one cooperative launch bitwise equal to the plain schedule
    on integer X (K not a multiple of the tile's k16 steps or its chunk, NL
    not of its 32 or 128 columns nor of 16, so byte-staged W, mc not of its
    32- or 64-row tile; mc = 256 at K = 4096, where the Wide tile's dynamic
    shared memory and the cooperative launch's occupancy meet), within
    rtol=1e-5, atol=1e-3 on non-integer X, and the same Y on back-to-back
    launches (stale flags or slots would show)."""
    from ternary_spgemm_tpu_torch.parallel import (
        ring_allgather_spgemm_plain, ring_launch)

    M, N = ranks * mc, ranks * NL
    fmt = DenseTernary.from_dense(generate_ternary(K, N, 3, seed=K),
                                  device=dev)
    b = torch.from_numpy(np.linspace(-2, 2, N).astype(np.float32)).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=ranks)).to(dev)
    got, blocks = ring_launch(X, fmt, b, ranks=ranks)
    want = ring_allgather_spgemm_plain(X, fmt, b, ranks=ranks)
    torch.cuda.synchronize()
    assert blocks >= 1
    assert torch.equal(got, want)
    for _ in range(5):
        assert torch.equal(ring_launch(X, fmt, b, ranks=ranks)[0], got)
    Xf = 4.0 * torch.rand((M, K), device=dev) - 2.0
    got = ring_launch(Xf, fmt, b, ranks=ranks)[0]
    want = ring_allgather_spgemm_plain(Xf, fmt, b, ranks=ranks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def test_cuda_graph_timer(dev):
    """A multi-op callable timed from a replayed CUDA graph: a positive
    device time, and no more than the eager events around the same ops,
    whose host gaps land between the events."""
    from ternary_spgemm_tpu_torch.bench import timing

    x = torch.randn((256, 256), device=dev)

    def ops(a):
        for _ in range(20):
            a = a * 1.0001 + 0.5
        return a

    g = timing.time_cuda_graph(ops, x, min_seconds=0.05)
    e = timing.time_cuda_events(ops, x, min_seconds=0.05)
    assert 0 < g.seconds <= e.seconds * 1.05


_SERVE = {}


def _serve(dev):
    """A small serving export (A8 linears, merged QKV, fused SwiGLU) on the
    card, built once; two layers at d = 256."""
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerConfig, build_serving_lm)

    if "lm" not in _SERVE:
        cfg = BitTransformerConfig(vocab=64, d_model=256, n_heads=4,
                                   d_ff=512, n_layers=2)
        _SERVE["lm"] = build_serving_lm(cfg, s=2, seed=1, device=dev)
    return _SERVE["lm"]


def _prompt(dev, seed, B=3, T0=10):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(0, 64, (B, T0), generator=g, device=dev)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
def test_tensor_pos_decode_bitwise_on_card(dev, cache_dtype):
    """A decode step at a 0-d position tensor on the card: the logits and
    every cache array of the step at the same int position."""
    from ternary_spgemm_tpu_torch.models import init_cache

    lm = _serve(dev)
    p = _prompt(dev, 0)
    caches = init_cache(lm.cfg, 3, 13, cache_dtype, device=dev)
    with torch.no_grad():
        logits, caches = lm.prefill(p, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)
        a_c = [{k: v.clone() for k, v in c.items()} for c in caches]
        b_c = [{k: v.clone() for k, v in c.items()} for c in caches]
        for t in range(10, 13):
            a, a_c = lm.decode_step(tok, a_c, t)
            b, b_c = lm.decode_step(
                tok, b_c, torch.tensor(t, device=dev))
            assert torch.equal(a, b)
            for ca, cb in zip(a_c, b_c):
                for k in ca:
                    assert torch.equal(ca[k], cb[k]), (t, k)
            tok = torch.argmax(a, dim=-1)


@pytest.mark.parametrize("prefill", [True, False])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
def test_graph_greedy_equals_eager(dev, prefill, cache_dtype):
    """Greedy tokens of the captured loop (``models/graphs.py``) equal the
    eager loop's, and its decode capture launched what one eager decode
    step launches: two x8 on the decode body and one SwiGLU a layer."""
    from ternary_spgemm_tpu_torch.models import generate

    lm = _serve(dev)
    p = _prompt(dev, 1)
    kw = dict(prefill=prefill, cache_dtype=cache_dtype)
    want = generate(lm, p, 12, graph=False, **kw)
    lm._captured.clear()
    got = generate(lm, p, 12, **kw)
    assert torch.equal(got, want)
    (loop,) = lm._captured.values()
    L = lm.cfg.n_layers
    assert loop.launches["step"] == {"CudaTiledBitplane_x8": 2 * L,
                                     "fused_bitplane_swiglu": L}
    if prefill:
        assert loop.launches["prefill"]["CudaTiledBitplane_x8"] == 2 * L


@pytest.mark.parametrize("prefill", [True, False])
def test_graph_sampling_equals_eager(dev, prefill):
    """One seed, the same sampled tokens from the captured and the eager
    loop (the same noise drawn in the same order); another seed others."""
    from ternary_spgemm_tpu_torch.models import generate

    lm = _serve(dev)
    p = _prompt(dev, 2)
    kw = dict(prefill=prefill, cache_dtype=torch.int8, temperature=0.8,
              top_k=20, top_p=0.95)

    def seeded(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    want = generate(lm, p, 12, graph=False, generator=seeded(5), **kw)
    got = generate(lm, p, 12, graph=True, generator=seeded(5), **kw)
    assert torch.equal(got, want)
    other = generate(lm, p, 12, graph=True, generator=seeded(6), **kw)
    assert not torch.equal(other, got)


def test_graph_reused_across_calls(dev):
    """A second generate of one shape replays the first call's graphs, and
    a new prompt of that shape gets the eager loop's tokens for it."""
    from ternary_spgemm_tpu_torch.models import generate

    lm = _serve(dev)
    lm._captured.clear()
    p1, p2 = _prompt(dev, 3), _prompt(dev, 4)
    a = generate(lm, p1, 8, max_t=24, cache_dtype=torch.int8)
    (loop,) = lm._captured.values()
    graphs = dict(loop.graphs)
    b = generate(lm, p2, 8, max_t=24, cache_dtype=torch.int8)
    c = generate(lm, p1, 5, max_t=24, cache_dtype=torch.int8)
    assert len(lm._captured) == 1 and loop.graphs == graphs
    assert torch.equal(a, generate(lm, p1, 8, max_t=24, graph=False,
                                   cache_dtype=torch.int8))
    assert torch.equal(b, generate(lm, p2, 8, max_t=24, graph=False,
                                   cache_dtype=torch.int8))
    assert torch.equal(c, a[:, :15])


def test_capture_without_warmup_raises(dev):
    """Capturing a split decode-body launch on a stream that has never run
    one raises: its counters would be allocated inside the graph."""
    fmt = TiledBitplane.from_dense(generate_ternary(256, 384, 2, seed=0)
                                   ).to(dev)
    X = torch.from_numpy(generate_x(4, 256, seed=0)).to(dev).round()
    b = torch.zeros(384, device=dev)
    stream = torch.cuda.Stream(dev)
    # streams come from a pool: forget any counters an earlier test left
    ck._GEMV_COUNTERS.pop((X.device, stream.cuda_stream), None)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="warm-up"):
        with torch.cuda.graph(graph, stream=stream):
            ck._bitplane_x8_lanes(X, fmt, b, parts=2)


def test_bundle_loads_on_card_byte_identical(dev, tmp_path):
    """A serving bundle saved from the card and loaded with ``device=
    "cuda"``: every tensor on the card and equal to the saved model's (the
    derived wq / wk / wv dropped again), and the loaded model's captured
    greedy tokens the original's."""
    from ternary_spgemm_tpu_torch.checkpoint import (
        load_lm_bundle, save_lm_bundle)
    from ternary_spgemm_tpu_torch.models import generate

    lm = _serve(dev)
    path = str(tmp_path / "serve.npz")
    save_lm_bundle(path, lm)
    back = load_lm_bundle(path, device="cuda")
    a, b = back.state_dict(), lm.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].is_cuda and torch.equal(a[k], b[k]), k
    p = _prompt(dev, 7)
    want = generate(lm, p, 8, cache_dtype=torch.int8)
    assert torch.equal(generate(back, p, 8, cache_dtype=torch.int8), want)


@pytest.mark.parametrize("prefill,T0", [(True, 5), (False, 9)])
def test_ring_graph_equals_eager(dev, prefill, T0):
    """A window-5 model's ring (5 slots) past its window: the captured
    loop's tokens are the eager loop's, and the full cache's."""
    from ternary_spgemm_tpu_torch.models import (
        ExportedTransformerLM, generate)

    base = _serve(dev)
    lm = ExportedTransformerLM(dataclasses.replace(base.cfg, window=5),
                               base.blocks, base.embed, base.norm_out)
    p = _prompt(dev, 8, T0=T0)
    kw = dict(prefill=prefill, cache_dtype=torch.int8)
    want = generate(lm, p, 12, graph=False, **kw)
    assert torch.equal(generate(lm, p, 12, graph=False, ring=True, **kw),
                       want)
    assert torch.equal(generate(lm, p, 12, ring=True, **kw), want)
    (loop,) = [v for v in lm._captured.values() if "pos_tab" in v.caches[0]]
    assert loop.caches[0]["k"].shape[2] == 5


def test_bf16_head_on_card(dev):
    """The bf16 head on the card: f32 logits, within 0.05 of the f32 head
    on the same hidden states and within the CPU's bf16 head's f32
    summation order; captured greedy tokens the eager loop's."""
    from ternary_spgemm_tpu_torch.models import (
        ExportedTransformerLM, generate)

    base = _serve(dev)
    lm = ExportedTransformerLM(base.cfg, base.blocks, base.embed,
                               base.norm_out, head_dtype=torch.bfloat16)
    assert lm.embed.dtype == torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    x = torch.randn((3, 4, base.cfg.d_model), generator=g, device=dev)
    y = lm._head(x)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, base._head(x), rtol=0.05, atol=0.05)
    # the CPU's route: both bf16 operands upcast, products exact in f32
    cpu = x.cpu().to(torch.bfloat16).float() @ lm.embed.cpu().float().t()
    torch.testing.assert_close(y.cpu(), cpu, rtol=1e-5, atol=1e-5)
    p = _prompt(dev, 9)
    want = generate(lm, p, 8, graph=False, cache_dtype=torch.int8)
    assert torch.equal(generate(lm, p, 8, cache_dtype=torch.int8), want)


#: the six torch-op formulations of the last XLA kernels, with their
#: containers' packer arguments (K = 512: the blocked ones' default block)
XLA_FORMULATIONS = {"BaseTCSR": {}, "BlockedTCSC": {},
                    "InterleavedTCSC": {}, "InterleavedBlockedTCSC":
                    {"group": 6}, "EllTCSC": {}, "PackedCSC": {}}


@pytest.mark.parametrize("name", sorted(XLA_FORMULATIONS))
def test_xla_formulation_on_card(dev, name):
    """Each formulation on CUDA tensors (containers packed on the card)
    against its CPU result: bitwise on integer X (the sums are exact),
    within rtol=1e-5, atol=1e-4 on non-integer X (``index_add_`` adds in
    atomic order on the card); the containers' bytes equal the CPU
    packer's."""
    from ternary_spgemm_tpu_torch.ops import all_kernels

    spec = all_kernels()[name]
    kw = XLA_FORMULATIONS[name]
    W = generate_ternary(512, 300, 3, seed=8)
    cpu = spec.format_cls.from_dense(W, **kw)
    gpu = spec.format_cls.from_dense(torch.from_numpy(W).to(dev), **kw)
    for f in cpu.ARRAY_FIELDS:
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    b, a = torch.from_numpy(generate_bias(300)), \
        torch.from_numpy(generate_alpha(300))
    rng = np.random.default_rng(2)
    for X in (generate_x(9, 512, seed=3),
              rng.uniform(-2, 2, (9, 512)).astype(np.float32)):
        X = torch.from_numpy(X)
        for al in (None, a):
            want = spec.fn(X, cpu, b, al)
            got = spec.fn(X.to(dev), gpu, b.to(dev),
                          None if al is None else al.to(dev))
            assert got.is_cuda
            if bool((X == X.round()).all()):
                assert torch.equal(got.cpu(), want)
            else:
                torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                           atol=1e-4)


def test_autotune_on_card(dev, tmp_path):
    """``autotune`` on CUDA tensors returns a registered candidate, keys
    the file by ``cuda``, warns of no failed candidate, and refuses to
    measure while a stream is capturing."""
    import importlib
    import json
    import warnings

    from ternary_spgemm_tpu_torch.ops import ternary_spgemm

    at = importlib.import_module("ternary_spgemm_tpu_torch.ops.autotune")
    at._CACHE.clear()
    W = generate_ternary(1024, 4096, 4, seed=0)
    fmt = TiledBitplane.from_dense(torch.from_numpy(W).to(dev))
    X = torch.from_numpy(generate_x(32, 1024, seed=1)).to(dev)
    b = torch.from_numpy(generate_bias(4096)).to(dev)
    cache = str(tmp_path / "tune.json")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        name = at.autotune(X, fmt, b, cache_path=cache)
    assert name in {s.name for s in at.candidates_for(fmt, 512.0, True)}
    assert list(json.load(open(cache))) == [
        "cuda|TiledBitplane|32|1024|4096|512.0|True|False"]
    y = ternary_spgemm(X, fmt, b, kernel="auto")
    assert torch.equal(y, cuda_kernels.bitplane_i8_plain(X, fmt, b))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capturing"):
        with torch.cuda.graph(graph, stream=side):
            at.autotune(X, fmt, b)
    at._CACHE.clear()


@pytest.mark.parametrize("err", [RuntimeError, ValueError])
def test_autotune_on_card_raises_a_failed_kernel(dev, monkeypatch, err):
    """On CUDA tensors a candidate that fails to build or launch stops
    autotune with the kernel's name; only one that refuses the shape (its
    precondition's ValueError) is skipped, with a warning."""
    import importlib

    from ternary_spgemm_tpu_torch.ops import api

    at = importlib.import_module("ternary_spgemm_tpu_torch.ops.autotune")
    at._CACHE.clear()
    spec = api.get_kernel("CudaTiledBitplane_i8")

    def broken(*a, **k):
        raise err("no launch")

    monkeypatch.setitem(api._KERNEL_REGISTRY, spec.name,
                        dataclasses.replace(spec, fn=broken))
    W = generate_ternary(256, 512, 4, seed=0)
    fmt = TiledBitplane.from_dense(torch.from_numpy(W).to(dev))
    X = torch.from_numpy(np.clip(generate_x(8, 256, seed=1), -127,
                                 127)).to(dev)
    b = torch.from_numpy(generate_bias(512)).to(dev)
    if err is RuntimeError:
        with pytest.raises(RuntimeError, match="candidate "
                           "CudaTiledBitplane_i8 failed on the card"):
            at.autotune(X, fmt, b, min_seconds=0.001)
    else:
        with pytest.warns(UserWarning, match="CudaTiledBitplane_i8 failed"):
            name = at.autotune(X, fmt, b, min_seconds=0.001)
        assert name != spec.name
    at._CACHE.clear()


def test_serving_tool_test_preset_on_card(dev, capsys):
    """The serving tool at its ``test`` preset on the card: captured
    prefill and decode, the kernels counted, no plain version on a CUDA
    tensor."""
    import json

    from ternary_spgemm_tpu_torch.tools import serving_bench as sb

    for fast in ("both", "none"):
        assert sb.main(["--preset", "test", "--repeats", "1", "--fast-paths",
                        fast, "--batch", "2"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["prefill"]["seconds"] > 0 and not rec["plain_on_cuda"]
        assert rec["launches"].get("CudaTiledBitplane_x8", 0) > 0
        assert (rec["launches"].get(fused_ffn.KERNEL_NAME, 0) > 0) == \
            (fast == "both")
        assert rec["peak_memory_bytes"] > 0


def _backward_spgemms(monkeypatch):
    """Record the SpMMs an exported layer's backward runs on its transposed
    container: ``(X, fmt_t, kernel, Y)`` each."""
    from ternary_spgemm_tpu_torch.models import exported

    seen = []
    spgemm = exported.ternary_spgemm

    def record(X, fmt, bias, alpha=None, *, kernel=None):
        Y = spgemm(X, fmt, bias, alpha, kernel=kernel)
        seen.append((X, fmt, kernel, Y))
        return Y

    monkeypatch.setattr(exported, "ternary_spgemm", record)
    return seen


@pytest.mark.parametrize("M", [4, 2048])
def test_x8_backward_on_transpose_bitwise(dev, M, monkeypatch):
    """Row 1's backward at bitnet3b's gate (3200 -> 8640): the A8 layer's
    cotangent requantized and run through the x8 kernel on ``fmt_t``
    (8640 -> 3200; the decode body at 4 rows, the tensor cores at 2048),
    bitwise its plain version; the x grad bitwise the same layer's on the
    CPU."""
    import copy

    from ternary_spgemm_tpu_torch.models import ExportedBitLinear

    K, N = 3200, 8640
    g = torch.Generator(device=dev).manual_seed(M)
    lin = ExportedBitLinear.from_dense(
        generate_ternary(K, N, 2, seed=20), TiledBitplane, gamma=0.03,
        bias=generate_bias(N), a8=True, device=dev)
    x = torch.randn((M, K), generator=g, device=dev).requires_grad_()
    v = torch.randn((M, N), generator=g, device=dev)
    y = lin(x)
    seen = _backward_spgemms(monkeypatch)
    y.backward(v)
    assert len(seen) == 1
    X, fmt, kernel, Y = seen[0]
    assert kernel == "CudaTiledBitplane_x8" and fmt.shape == (N, K)
    assert torch.equal(Y, ck.bitplane_x8_plain(X, fmt, lin.zero_bias_t))
    cpu = copy.deepcopy(lin).to("cpu")
    xc = x.detach().cpu().requires_grad_()
    cpu(xc).backward(v.cpu())
    assert torch.equal(x.grad.cpu(), xc.grad)


def test_dense_backward_on_transpose_bitwise(dev, monkeypatch):
    """Row 9's backward: a DenseTernary layer with PReLU (slope 0.25) and an
    integer cotangent, so that every value the dense kernel sums on
    ``fmt_t`` is a multiple of 0.25 and every partial sum exact: the
    kernel's product bitwise its plain version at 32 rows."""
    from ternary_spgemm_tpu_torch.models import ExportedBitLinear

    K, N, M = 1024, 4096, 32
    g = torch.Generator(device=dev).manual_seed(9)
    lin = ExportedBitLinear.from_dense(
        generate_ternary(K, N, 2, seed=21), DenseTernary,
        alpha=torch.full((N,), 0.25), device=dev)
    x = torch.randn((M, K), generator=g, device=dev).requires_grad_()
    v = torch.randint(-50, 51, (M, N), generator=g, device=dev).float()
    y = lin(x)
    seen = _backward_spgemms(monkeypatch)
    y.backward(v)
    assert len(seen) == 1
    X, fmt, kernel, Y = seen[0]
    assert kernel == "CudaDense" and fmt.shape == (N, K)
    assert torch.equal(Y, ck.dense_plain(X, fmt, lin.zero_bias_t))
    assert torch.equal(x.grad, Y)    # gamma = 1


_MOE = {}


def _moe_lm(dev, format_cls=TiledBitplane, a8=True):
    """A small MoE model (2 layers at d = 256, 4 experts top 2, capacity
    factor 2: C = S) exported on the card, built once a format."""
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerConfig, BitTransformerLM, ExportedTransformerLM,
        jax_tree)

    key = (format_cls.__name__, a8)
    if key not in _MOE:
        cfg = BitTransformerConfig(vocab=64, d_model=256, n_heads=4,
                                   d_ff=512, n_layers=2, moe_experts=4,
                                   moe_top_k=2, moe_capacity_factor=2.0)
        qat = BitTransformerLM(cfg, generator=torch.Generator(
            device=dev).manual_seed(21), device=dev)
        _MOE[key] = ExportedTransformerLM.from_params(
            cfg, jax_tree(qat, numpy=False), format_cls, a8=a8,
            fused_qkv=a8, with_transpose=False, device=dev)
    return _MOE[key]


@pytest.mark.parametrize("fmt", ["a8_bitplane", "dense"])
def test_moe_block_on_card_matches_cpu(dev, fmt):
    """An MoE block exported on the card against the same block on the CPU
    (plain versions): the A8 experts over TiledBitplane (the x8 kernel, 3
    launches an expert) bitwise, the exact experts over DenseTernary (the
    dense kernel, which sums f32 X in another order) within rtol=1e-5,
    atol=1e-5; the whole block within the CPU tests' 2e-3."""
    import copy

    lm = (_moe_lm(dev) if fmt == "a8_bitplane"
          else _moe_lm(dev, DenseTernary, a8=False))
    blk = lm.blocks[0]
    cpu = copy.deepcopy(blk).to("cpu")
    g = torch.Generator(device=dev).manual_seed(4)
    for rows in (4, 96):
        h = torch.randn((1, rows, 256), generator=g, device=dev)
        ck.reset_counts()
        with torch.no_grad():
            got = blk.moe(h)
        torch.cuda.synchronize()
        name = ("CudaTiledBitplane_x8" if fmt == "a8_bitplane"
                else "CudaDense")
        assert ck.launches[name] == 3 * 4 and not ck.plain_on_cuda
        want = cpu.moe(h.cpu())
        if fmt == "a8_bitplane":
            assert torch.equal(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        with torch.no_grad():
            torch.testing.assert_close(blk(h).cpu(), cpu(h.cpu()),
                                       rtol=2e-3, atol=2e-3)


def test_moe_graph_generate_equals_eager(dev):
    """The captured generate loop holds an MoE decode step: the eager
    loop's greedy tokens, and the step's capture launched one eager
    step's x8 calls, 2 + 3 x 4 a layer (the merged QKV, wo and the
    experts), all on the decode body."""
    from ternary_spgemm_tpu_torch.models import generate

    lm = _moe_lm(dev)
    p = _prompt(dev, 7)
    want = generate(lm, p, 10, graph=False, cache_dtype=torch.int8)
    lm._captured.clear()
    got = generate(lm, p, 10, cache_dtype=torch.int8)
    assert torch.equal(got, want)
    (loop,) = lm._captured.values()
    assert loop.launches["step"] == {
        "CudaTiledBitplane_x8": (2 + 3 * 4) * lm.cfg.n_layers}
    lm._captured.clear()
