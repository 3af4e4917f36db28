"""Port parity: the plain versions of the CUDA SpMM kernels against the JAX
Pallas kernels (run in interpret mode on the CPU, as the JAX tests run
them), and the torch-ops BaseTCSC and DenseMXU* against the JAX XLA ones. On
the integer domains both compute exact sums, so equality is exact; the f32
and bf16 kernels off their integer domains see the same X (bf16-rounded
identically where they round) and differ only in f32 summation order
(rtol=1e-5, atol=1e-3)."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu import reference as jref
from ternary_spgemm_tpu.ops import get_kernel as jget
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch import reference as tref
from ternary_spgemm_tpu_torch.models.exported import (
    ExportedBitLinear,
    _default_a8_kernel,
)
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.ops import all_kernels, get_kernel, ternary_spgemm
from ternary_spgemm_tpu_torch.ops import xla_kernels

K, N = 300, 260

#: container key -> (container class, packer arguments); tile_n = 128 so
#: that gn = 3, a tile_k of 128 (under the 256-row chunk of the CUDA
#: kernels' Narrow tile), block-packed tile_kq of 16 and 32 and ELL block_k
#: of 31 and 32 so that nb > 1 and K is not a multiple of the block (nor of
#: 4, 5 or the deposit's 248-row superblock)
CONTAINERS = {
    "TiledBitplane": ("TiledBitplane", {"tile_n": 128}),
    "TiledNibblePair": ("TiledNibblePair", {"tile_n": 128}),
    "TiledDenseTernary": ("TiledDenseTernary", {"tile_n": 128}),
    "TiledDenseTernary128": ("TiledDenseTernary",
                             {"tile_k": 128, "tile_n": 128}),
    "DenseTernary": ("DenseTernary", {}),
    "BlockPacked4": ("BlockPackedTernary", {"factor": 4, "tile_kq": 16}),
    "BlockPacked5": ("BlockPackedTernary", {"factor": 5, "tile_kq": 32}),
    "TiledBlockPacked4": ("TiledBlockPacked",
                          {"factor": 4, "tile_kq": 16, "tile_n": 128}),
    "TiledBlockPacked5": ("TiledBlockPacked",
                          {"factor": 5, "tile_kq": 32, "tile_n": 128}),
    "Packed2Bit": ("PackedTernary2Bit", {}),
    "Packed53": ("PackedTernary53", {}),
    "TiledEll": ("TiledEllTCSC", {"block_k": 31, "tile_n": 128}),
    "BlockedEll": ("BlockedEllTCSC", {"block_k": 32, "tile_n": 128}),
    "EllDeposit": ("TiledEllDeposit", {"tile_n": 128}),
}

#: kind -> (port kernel, JAX kernel, container key, integer |x| domain)
KINDS = {
    "x8": ("CudaTiledBitplane_x8", "PallasTiledBitplane_x8", "TiledBitplane",
           127),
    "i8": ("CudaTiledBitplane_i8", "PallasTiledBitplane_i8", "TiledBitplane",
           512),
    "bf16": ("CudaTiledBitplane_bf16", "PallasTiledBitplane_bf16",
             "TiledBitplane", 256),
    "nibble_i8": ("CudaTiledNibblePair_i8", "PallasTiledNibblePair_i8",
                  "TiledNibblePair", 512),
    "tiled_dense_i8": ("CudaTiledDense_i8", "PallasTiledDense_i8",
                       "TiledDenseTernary", 512),
    "dense_x8": ("CudaTiledDense_x8", "PallasTiledDense_x8",
                 "TiledDenseTernary", 127),
    "tiled_dense_i8_tk128": ("CudaTiledDense_i8", "PallasTiledDense_i8",
                             "TiledDenseTernary128", 512),
    "dense_x8_tk128": ("CudaTiledDense_x8", "PallasTiledDense_x8",
                       "TiledDenseTernary128", 127),
    "dense": ("CudaDense", "PallasDense", "DenseTernary", 512),
    "dense_bf16": ("CudaDense_bf16", "PallasDense_bf16", "DenseTernary", 256),
    "dense_i8": ("CudaDense_i8", "PallasDense_i8", "DenseTernary", 512),
    "blockpacked_i8_f4": ("CudaBlockPacked_i8", "PallasBlockPacked_i8",
                          "BlockPacked4", 512),
    "blockpacked_i8_f5": ("CudaBlockPacked_i8", "PallasBlockPacked_i8",
                          "BlockPacked5", 512),
    "tiled_blockpacked_i8_f4": ("CudaTiledBlockPacked_i8",
                                "PallasTiledBlockPacked_i8",
                                "TiledBlockPacked4", 512),
    "tiled_blockpacked_i8_f5": ("CudaTiledBlockPacked_i8",
                                "PallasTiledBlockPacked_i8",
                                "TiledBlockPacked5", 512),
    "packed2": ("CudaPacked2Bit", "PallasPacked2Bit", "Packed2Bit", 512),
    "packed53": ("CudaPacked53", "PallasPacked53", "Packed53", 512),
    "packed2_i8": ("CudaPacked2Bit_i8", "PallasPacked2Bit_i8", "Packed2Bit",
                   512),
    "packed53_i8": ("CudaPacked53_i8", "PallasPacked53_i8", "Packed53", 512),
    "ell_deposit_i8": ("CudaEllDeposit_i8", "PallasEllDeposit_i8",
                       "EllDeposit", 512),
    "tiled_ell": ("CudaTiledEllGather", "PallasTiledEllGather", "TiledEll",
                  512),
    "ell_gather": ("CudaEllGather", "PallasEllGather", "BlockedEll", 512),
}


@pytest.fixture(scope="module")
def dense_w():
    return jf.generate_ternary(K, N, 3, seed=11)


@pytest.fixture(scope="module")
def containers(dense_w):
    """container key -> (JAX container, port container) (:data:`CONTAINERS`)."""
    return {key: (getattr(jf, c).from_dense(dense_w, **kw),
                  getattr(tf, c).from_dense(dense_w, **kw))
            for key, (c, kw) in CONTAINERS.items()}


@pytest.fixture(scope="module")
def weights(dense_w, containers):
    return (dense_w, *containers["TiledBitplane"])


def _both(jname, tkern, jfmt, tfmt, X, b, a):
    want = np.asarray(jget(jname)(
        jnp.asarray(X), jfmt, jnp.asarray(b),
        None if a is None else jnp.asarray(a)))
    got = tkern(torch.from_numpy(X), tfmt, torch.from_numpy(b),
                None if a is None else torch.from_numpy(a)).numpy()
    return got, want


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("prelu", [False, True])
def test_plain_equals_pallas(containers, kind, M, prelu):
    tname, jname, cls, vr = KINDS[kind]
    jfmt, tfmt = containers[cls]
    assert tfmt.meta().get("tile_n", N) in (128, N) and N > 2 * 128
    X = jf.generate_x(M, K, seed=M, value_range=vr)
    if vr == 127:
        X = X * 1.3                      # rounds and clamps past +-127
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    got, want = _both(jname, get_kernel(tname), jfmt, tfmt, X, b, a)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("prelu", [False, True])
def test_bf16_off_integer_domain(containers, M, prelu):
    jfmt, tfmt = containers["TiledBitplane"]
    X = np.random.default_rng(M).uniform(-700.0, 700.0,
                                         size=(M, K)).astype(np.float32)
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    got, want = _both("PallasTiledBitplane_bf16",
                      ck.cuda_tiled_bitplane_bf16_kernel, jfmt, tfmt, X, b, a)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # X is rounded to bf16, not floored or clamped
    Xb = np.asarray(jnp.asarray(X, jnp.bfloat16).astype(jnp.float32))
    W = containers["TiledBitplane"][1].to_dense().numpy()
    ref = (jref.dense_gemm_prelu(Xb, W, b, a) if prelu
           else jref.dense_gemm(Xb, W, b))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-3)


#: the kernels that take any float X: kind -> (port kernel, JAX kernel,
#: container key)
FLOAT_KINDS = {
    "dense": ("CudaDense", "PallasDense", "DenseTernary"),
    "dense_bf16": ("CudaDense_bf16", "PallasDense_bf16", "DenseTernary"),
    "DenseMXU": ("DenseMXU", "DenseMXU", "DenseTernary"),
    "DenseMXU_bf16": ("DenseMXU_bf16", "DenseMXU_bf16", "DenseTernary"),
    "packed2": ("CudaPacked2Bit", "PallasPacked2Bit", "Packed2Bit"),
    "packed53": ("CudaPacked53", "PallasPacked53", "Packed53"),
    "tiled_ell": ("CudaTiledEllGather", "PallasTiledEllGather", "TiledEll"),
    "ell_gather": ("CudaEllGather", "PallasEllGather", "BlockedEll"),
    "PackedMXU_2bit": ("PackedMXU_2bit", "PackedMXU_2bit", "Packed2Bit"),
    "PackedMXU_base3": ("PackedMXU_base3", "PackedMXU_base3", "Packed53"),
    "BlockedEllTCSC": ("BlockedEllTCSC", "BlockedEllTCSC", "BlockedEll"),
}


@pytest.mark.parametrize("kind", sorted(FLOAT_KINDS))
@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("prelu", [False, True])
def test_float_kernels_off_integer_domain(containers, kind, M, prelu):
    """f32 and bf16 kernels on non-integer X (uniform +-2 for f32; +-700
    for bf16, past its exact +-256): the same values, rounded to bf16 alike
    where the kernel rounds, summed in another order."""
    tname, jname, cls = FLOAT_KINDS[kind]
    jfmt, tfmt = containers[cls]
    hi = 700.0 if "bf16" in kind else 2.0
    X = np.random.default_rng(M).uniform(-hi, hi,
                                         size=(M, K)).astype(np.float32)
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    got, want = _both(jname, get_kernel(tname), jfmt, tfmt, X, b, a)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    if "bf16" in kind:
        X = np.asarray(jnp.asarray(X, jnp.bfloat16).astype(jnp.float32))
    W = tfmt.to_dense().numpy()
    ref = (jref.dense_gemm_prelu(X, W, b, a) if prelu
           else jref.dense_gemm(X, W, b))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("name", ["DenseMXU", "DenseMXU_x8"])
@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("prelu", [False, True])
def test_dense_mxu_equals_jax(containers, name, M, prelu):
    """The exact XLA formulations on integer X: DenseMXU on +-512,
    DenseMXU_x8 on X x 1.3, which it rounds and clamps past +-127 — equal to
    JAX's int32 dot bit for bit."""
    jfmt, tfmt = containers["DenseTernary"]
    X = jf.generate_x(M, K, seed=M + 3)
    if name == "DenseMXU_x8":
        X = X * 1.3
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    got, want = _both(name, get_kernel(name), jfmt, tfmt, X, b, a)
    np.testing.assert_array_equal(got, want)
    ck.reset_counts()
    get_kernel(name)(torch.from_numpy(X), tfmt, torch.from_numpy(b))
    assert not ck.launches and not ck.plain_on_cuda   # torch ops, no plain


@pytest.mark.parametrize("kind", [k for k in sorted(KINDS)
                                  if KINDS[k][3] == 512 and "i8" in k])
def test_i8_kernels_floor_non_integer_x(containers, kind):
    """Every i8 kernel floors non-integer X, as the TPU's int8 split does."""
    tname, jname, cls, _ = KINDS[kind]
    jfmt, tfmt = containers[cls]
    X = np.random.default_rng(1).uniform(-511.9, 511.9,
                                         size=(5, K)).astype(np.float32)
    b = jf.generate_bias(N)
    got, want = _both(jname, get_kernel(tname), jfmt, tfmt, X, b, None)
    np.testing.assert_array_equal(got, want)
    W = tfmt.to_dense().numpy().astype(np.float32)
    np.testing.assert_array_equal(got, np.floor(X) @ W + b)


@pytest.mark.parametrize("chunked", [False, True], ids=["direct", "chunked"])
@pytest.mark.parametrize("prelu", [False, True])
def test_base_tcsc_equals_jax(monkeypatch, dense_w, chunked, prelu):
    from ternary_spgemm_tpu.ops import xla_kernels as jxla

    X = jf.generate_x(9, K, seed=5)
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    jfmt, tfmt = jf.TCSC.from_dense(dense_w), tf.TCSC.from_dense(dense_w)
    if chunked:
        # every M takes the chunked path, in chunks of 2 rows (a ragged last
        # chunk) and slot sections of 8
        for mod in (jxla, xla_kernels):
            monkeypatch.setattr(mod, "_GATHER_CHUNK_FLOATS", 1)
            monkeypatch.setattr(mod, "_CHUNK_BUDGET_FLOATS", 2 * N * 8)
        monkeypatch.setattr(xla_kernels, "_SEC", 8)
        assert tfmt.prepare(9).ell_pos is not None
    else:
        assert tfmt.prepare(9).ell_pos is None
    got, want = _both("BaseTCSC", get_kernel("BaseTCSC"), jfmt, tfmt, X, b, a)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(
        (jref.dense_gemm_prelu(X, dense_w, b, a) if prelu
         else jref.dense_gemm(X, dense_w, b))))


def test_a8_linear_over_tiled_dense(dense_w):
    """The A8 ExportedBitLinear over TiledDenseTernary picks the int8-native
    kernel in both packages and gives the same output."""
    from ternary_spgemm_tpu.models.exported import ExportedBitLinear as JLin
    from ternary_spgemm_tpu.models.exported import (
        _default_a8_kernel as j_default_a8)

    x = np.random.default_rng(3).standard_normal((6, K)).astype(np.float32)
    b = np.linspace(-1, 1, N).astype(np.float32)
    jl = JLin.from_dense(dense_w, jf.TiledDenseTernary, gamma=0.37, bias=b,
                         a8=True, with_transpose=False)
    tl = ExportedBitLinear.from_dense(dense_w, tf.TiledDenseTernary,
                                      gamma=0.37, bias=b, a8=True)
    assert j_default_a8(jl.fmt) == "PallasTiledDense_x8"
    assert _default_a8_kernel(tl.fmt) == "CudaTiledDense_x8"
    ck.reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_i8_floors_non_integer_x(weights):
    W, jfmt, tfmt = weights
    rng = np.random.default_rng(0)
    X = rng.uniform(-511.9, 511.9, size=(5, K)).astype(np.float32)
    b = np.zeros(N, np.float32)
    want = np.asarray(jget("PallasTiledBitplane_i8")(jnp.asarray(X), jfmt,
                                                     jnp.asarray(b)))
    got = ck.cuda_tiled_bitplane_i8_kernel(torch.from_numpy(X), tfmt,
                                           torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.floor(X) @ W.astype(np.float32))


def test_i8_matches_dense_reference(weights):
    W, _, tfmt = weights
    X = jf.generate_x(32, K, seed=4)
    b, a = jf.generate_bias(N), jf.generate_alpha(N)
    got = get_kernel("CudaTiledBitplane_i8")(torch.from_numpy(X), tfmt,
                                             torch.from_numpy(b),
                                             torch.from_numpy(a))
    assert tref.compare_results(got, tref.dense_gemm_prelu(X, W, b, a))
    assert tref.compare_results(got, np.asarray(jref.dense_gemm_prelu(X, W, b, a)))


@pytest.mark.parametrize("cls,default,a8", [
    ("TiledBitplane", "CudaTiledBitplane_i8", "CudaTiledBitplane_x8"),
    ("TiledNibblePair", "CudaTiledNibblePair_i8", "CudaTiledNibblePair_i8"),
    ("TiledDenseTernary", "CudaTiledDense_i8", "CudaTiledDense_x8"),
    ("BlockPacked4", "CudaBlockPacked_i8", "CudaBlockPacked_i8"),
    ("TiledBlockPacked5", "CudaTiledBlockPacked_i8",
     "CudaTiledBlockPacked_i8"),
    ("EllDeposit", "CudaEllDeposit_i8", "CudaEllDeposit_i8")])
def test_default_dispatch_per_container(containers, cls, default, a8):
    """Default dispatch takes the widest integer domain (the bf16 kernel's
    +-256 does not displace i8's +-512); the A8 default is int8-native."""
    tfmt = containers[cls][1]
    X = torch.from_numpy(jf.generate_x(3, K, seed=1))
    b = torch.zeros(N)
    with pytest.warns(UserWarning, match="ROUNDED"):
        y = ternary_spgemm(X, tfmt, b)
    assert torch.equal(y, get_kernel(default)(X, tfmt, b))
    assert _default_a8_kernel(tfmt) == a8


def test_default_dispatch_and_a8_kernel(weights):
    _, _, tfmt = weights
    X = torch.from_numpy(jf.generate_x(3, K, seed=1))
    b = torch.zeros(N)
    with pytest.warns(UserWarning, match="ROUNDED"):
        y = ternary_spgemm(X, tfmt, b)
    assert torch.equal(y, ck.bitplane_i8_plain(X, tfmt, b))
    assert _default_a8_kernel(tfmt) == "CudaTiledBitplane_x8"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ternary_spgemm(X, tfmt, b, kernel="CudaTiledBitplane_x8")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_runs_only_on_cpu(containers, kind):
    tname, _, cls, _ = KINDS[kind]
    tfmt = containers[cls][1]
    kern = get_kernel(tname)
    ck.reset_counts()
    kern(torch.zeros(2, K), tfmt, torch.zeros(N))
    assert not ck.launches and not ck.plain_on_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern(torch.zeros(2, K, device="meta"), tfmt, torch.zeros(N))


def test_dense_ternary_dispatch(containers):
    """Default dispatch over DenseTernary has two exact kernels of
    unrestricted domain, CudaDense and DenseMXU; the hand-written kernel
    wins, without a warning (JAX's picks Pallas on a TPU). The A8 default is
    the int8-native DenseMXU_x8 in both packages."""
    from ternary_spgemm_tpu.models.exported import (
        _default_a8_kernel as j_default_a8)

    jfmt, tfmt = containers["DenseTernary"]
    X = torch.from_numpy(np.random.default_rng(2).uniform(
        -3.0, 3.0, size=(4, K)).astype(np.float32))
    b = torch.from_numpy(jf.generate_bias(N))
    ck.reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y = ternary_spgemm(X, tfmt, b)
    assert torch.equal(y, ck.dense_plain(X, tfmt, b))
    assert torch.equal(y, get_kernel("CudaDense")(X, tfmt, b))
    assert _default_a8_kernel(tfmt) == "DenseMXU_x8" == j_default_a8(jfmt)


@pytest.mark.parametrize("cls", ["BlockPacked4", "TiledBlockPacked4"])
def test_block_packed_have_no_int8_native_kernel(containers, cls):
    """Neither package has an int8-native (_x8) kernel over the block-packed
    containers: the A8 default falls to their i8 kernel in both."""
    from ternary_spgemm_tpu.models.exported import (
        _default_a8_kernel as j_default_a8)
    from ternary_spgemm_tpu.ops import all_kernels as jall

    jfmt, tfmt = containers[cls]
    for reg, fmt, a8 in ((jall(), jfmt, j_default_a8),
                         (all_kernels(), tfmt, _default_a8_kernel)):
        over = [s for s in reg.values() if isinstance(fmt, s.format_cls)]
        assert [s.x_absmax for s in over] == [512]
        assert a8(fmt) == over[0].name


#: the torch-op formulations of JAX's XLA kernels over the new containers
TORCH_OPS = {"PackedMXU_2bit": "Packed2Bit", "PackedMXU_base3": "Packed53",
             "BlockedEllTCSC": "BlockedEll"}


@pytest.mark.parametrize("name", sorted(TORCH_OPS))
@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("prelu", [False, True])
def test_torch_ops_equal_jax(containers, name, M, prelu):
    """The decode-then-dot and masked-gather formulations equal JAX's XLA
    ones bit for bit on integer X, and are torch ops (no launch, no plain
    version)."""
    jfmt, tfmt = containers[TORCH_OPS[name]]
    X = jf.generate_x(M, K, seed=M + 5)
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    ck.reset_counts()
    got, want = _both(name, get_kernel(name), jfmt, tfmt, X, b, a)
    np.testing.assert_array_equal(got, want)
    assert not ck.launches and not ck.plain_on_cuda
    W = tfmt.to_dense().numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jref.dense_gemm_prelu(X, W, b, a) if prelu
        else jref.dense_gemm(X, W, b)))


def _both_kinds(fmt):
    """The exact, unrestricted-domain kernels over ``fmt``: (hand-written,
    torch ops)."""
    cands = [s for s in all_kernels().values()
             if isinstance(fmt, s.format_cls) and not s.approximate
             and s.x_absmax is None]
    return ([s.name for s in cands if s.source],
            [s.name for s in cands if not s.source])


def test_containers_with_both_kinds(containers):
    both = sorted(k for k, (_, t) in containers.items()
                  if all(_both_kinds(t)))
    assert both == ["BlockedEll", "DenseTernary", "Packed2Bit", "Packed53"]


@pytest.mark.parametrize("cls,want", [
    ("DenseTernary", "CudaDense"), ("Packed2Bit", "CudaPacked2Bit"),
    ("Packed53", "CudaPacked53"), ("BlockedEll", "CudaEllGather")])
def test_dispatch_prefers_hand_written_kernel(monkeypatch, containers, cls,
                                              want):
    """Where a container has both a hand-written kernel and a torch-op
    formulation, default dispatch takes the hand-written one, whatever the
    names' order (``BlockedEllTCSC`` < ``CudaEllGather``)."""
    from ternary_spgemm_tpu_torch.ops import api

    tfmt = containers[cls][1]
    hand, ops = _both_kinds(tfmt)
    assert hand == [want] and ops
    for name in hand + ops:
        spec = api.get_kernel(name)
        monkeypatch.setitem(api._KERNEL_REGISTRY, name, dataclasses.replace(
            spec, fn=lambda X, f, b, a=None, _n=name: _n))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ternary_spgemm(torch.zeros(2, K), tfmt, torch.zeros(N)) == want


@pytest.mark.parametrize("cls,want", [
    ("Packed2Bit", "CudaPacked2Bit_i8"), ("Packed53", "CudaPacked53_i8"),
    ("EllDeposit", "CudaEllDeposit_i8"), ("TiledEll", None),
    ("BlockedEll", None)])
def test_a8_default_kernel_matches_jax(containers, cls, want):
    """Both packages resolve the A8 kernel of the new containers alike: the
    _i8 kernel where the container has one, else None (fully-exact f32
    kernels, default dispatch)."""
    from ternary_spgemm_tpu.models.exported import (
        _default_a8_kernel as j_default_a8)
    from ternary_spgemm_tpu_torch.ops import REFERENCE_KERNELS

    jfmt, tfmt = containers[cls]
    assert _default_a8_kernel(tfmt) == want
    j = j_default_a8(jfmt)
    assert (j is None) if want is None else (REFERENCE_KERNELS[j] == want)


@pytest.mark.parametrize("cls", sorted(CONTAINERS))
def test_a8_default_kernel_orders_like_dispatch(monkeypatch, containers, cls):
    """The A8 default takes the int8-native domain first and, within a
    domain, the order of default dispatch (``api.dispatch_rank``): a
    hand-written kernel before a torch op, whatever the names. Decoy torch
    ops whose names sort first are registered in both domains; the
    hand-written kernels over every container must still win theirs."""
    from ternary_spgemm_tpu_torch.ops import api

    tfmt = containers[cls][1]
    for absmax in (127, 512):
        name = f"AAA_decoy_{absmax}"
        monkeypatch.setitem(api._KERNEL_REGISTRY, name, api.KernelSpec(
            name=name, fn=lambda X, f, b, a=None: None,
            format_cls=type(tfmt), x_absmax=absmax))
    cands = [s for s in all_kernels().values()
             if isinstance(tfmt, s.format_cls) and not s.approximate
             and s.x_absmax is not None]
    domain = 127 if any(s.x_absmax == 127 for s in cands) else 512
    mine = [s for s in cands if s.x_absmax == domain]
    hand = sorted(s.name for s in mine if s.source)
    want = hand[0] if hand else f"AAA_decoy_{domain}"
    assert _default_a8_kernel(tfmt) == want
    assert want == min(mine, key=api.dispatch_rank).name


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_compare_results_counts_non_finite_cells(bad):
    """A cell that is not finite, on either side, fails the comparison; a
    NaN output must not pass a ``-correctness`` gate."""
    want = np.zeros((2, 3), np.float32)
    got = want.copy()
    got[1, 2] = bad
    res = tref.compare_results(got, want)
    assert not res and res.num_bad == 1 and res.first_bad[:2] == (1, 2)
    assert not tref.compare_results(want, got)
    assert not tref.compare_results(got, got)      # inf - inf is NaN too
    assert tref.compare_results(want, want + 1e-6)


@pytest.mark.xfail(strict=True, reason=(
    "reference fault, ternary_spgemm_tpu/reference.py:85: err > tol is "
    "False for NaN, so the JAX comparator passes a NaN output; the port "
    "counts it as bad (ROADMAP queue C)"))
def test_compare_results_nan_parity_with_jax():
    got = np.array([[1.0, np.nan]], np.float32)
    want = np.ones((1, 2), np.float32)
    assert bool(jref.compare_results(got, want)) == \
        bool(tref.compare_results(got, want))


@pytest.mark.parametrize("name", sorted(tf.all_formats()))
def test_kernels_for_format_matches_jax(name):
    """``ops.kernels_for_format``: the kernels registered for exactly one
    container, under the JAX registry's names, are the JAX
    ``kernels_for_format``'s (``ternary_spgemm_tpu/ops/api.py:95``)."""
    from ternary_spgemm_tpu.ops import kernels_for_format as jkernels
    from ternary_spgemm_tpu_torch.ops import api, kernels_for_format

    got = kernels_for_format(tf.all_formats()[name])
    assert all(s.format_cls is tf.all_formats()[name] for s in got.values())
    assert {api.jax_name(n) for n in got} == \
        set(jkernels(jf.all_formats()[name]))
