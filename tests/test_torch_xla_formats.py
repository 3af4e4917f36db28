"""Port parity: the six containers of the last XLA formulations (TCSR,
BlockedTCSC, InterleavedTCSC, InterleavedBlockedTCSC, EllTCSC, PackedCSC)
and their torch-op kernels (BaseTCSR, BlockedTCSC, InterleavedTCSC,
InterleavedBlockedTCSC, EllTCSC, PackedCSC) against the JAX package's.

* Containers: every array field byte for byte, with its shape and dtype,
  and every static field, at several shapes: ragged K and N, N not a
  multiple of the ELL tile, groups 1, 4 and 6, blocks of 32-512 rows, an
  all-zero column and a matrix with no nonzero; a K that is not a
  multiple of the block is refused by both packages alike.
* Kernels: the same numpy inputs through the JAX function and the port's,
  PReLU on and off, against each other and against
  ``reference.dense_gemm``: within abs 1e-5 on integer X (the sums are
  exact, so both are bitwise the reference), and within rtol=1e-5,
  atol=1e-4 on non-integer X uniform in +-2 (f32 sums in torch's order;
  the stream formulations add in JAX's order on the CPU, the ELL gather's
  slot sum does not).
"""

import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu import reference as jref
from ternary_spgemm_tpu.ops import all_kernels as jax_kernels
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch import reference as tref
from ternary_spgemm_tpu_torch.ops import all_kernels, unported

#: container -> the (K, N, packer arguments) it is checked at
CASES = {
    "TCSR": [(100, 300, {}), (37, 91, {}), (512, 7, {})],
    "BlockedTCSC": [(1024, 300, {}), (96, 70, {"block_size": 32}),
                    (64, 5, {"block_size": 64}), (512, 129, {})],
    "InterleavedTCSC": [(100, 300, {}), (37, 91, {"group": 1}),
                        (200, 50, {"group": 6})],
    "InterleavedBlockedTCSC": [(1024, 130, {}),
                               (96, 70, {"block_size": 32, "group": 6}),
                               (128, 33, {"block_size": 64, "group": 4})],
    "EllTCSC": [(100, 300, {}), (37, 91, {"tile_n": 32, "cap_align": 1}),
                (999, 1000, {}), (64, 130, {"cap_align": 16})],
    "PackedCSC": [(100, 300, {}), (37, 91, {}), (3, 4, {}), (512, 129, {})],
}
#: kernel -> its container
KERNELS = {"BaseTCSR": "TCSR", "BlockedTCSC": "BlockedTCSC",
           "InterleavedTCSC": "InterleavedTCSC",
           "InterleavedBlockedTCSC": "InterleavedBlockedTCSC",
           "EllTCSC": "EllTCSC", "PackedCSC": "PackedCSC"}
#: the kernels' shapes: K a multiple of 4 blocks of 128 rows, N ragged
K, N = 512, 300
BLOCKED = {"block_size": 128}
NONINT_TOL = dict(rtol=1e-5, atol=1e-4)


def _matrix(K, N, s, seed, zero_col=True):
    W = jf.generate_ternary(K, N, s, seed=seed)
    if zero_col:
        W[:, N // 2] = 0                  # an all-zero column
    return W


def _both(cls, W, kw):
    return (getattr(jf, cls).from_dense(W, **kw),
            getattr(tf, cls).from_dense(W, **kw))


def _assert_same_bytes(j, t):
    assert t.meta() == {k: v for k, v in j.__dict__.items()
                        if k in t.meta()}
    assert set(t.meta()) | set(t.ARRAY_FIELDS) == set(j.__dict__)
    for field in t.ARRAY_FIELDS:
        a, want = getattr(t, field), np.asarray(getattr(j, field))
        assert a.dtype == getattr(torch, str(want.dtype)), field
        assert tuple(a.shape) == want.shape, field
        assert a.numpy().tobytes() == want.tobytes(), field


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("cls,K,N,kw", [
    (c, K, N, kw) for c, cases in CASES.items() for K, N, kw in cases])
def test_container_bytes_identical(cls, K, N, kw, s):
    W = _matrix(K, N, s, seed=K + N + s)
    j, t = _both(cls, W, kw)
    _assert_same_bytes(j, t)
    np.testing.assert_array_equal(t.to_dense().numpy(), W)
    assert t.size_bytes() == j.size_bytes()
    assert t.nnz == j.nnz == int(np.count_nonzero(W))


@pytest.mark.parametrize("cls", sorted(CASES))
def test_empty_matrix_identical(cls):
    W = np.zeros((128, 40), np.int8)
    kw = {"block_size": 64} if "Blocked" in cls else {}
    j, t = _both(cls, W, kw)
    _assert_same_bytes(j, t)
    assert t.nnz == 0 and not t.to_dense().any()


@pytest.mark.parametrize("cls", ["BlockedTCSC", "InterleavedBlockedTCSC"])
def test_k_not_a_multiple_of_the_block_is_refused_alike(cls):
    W = _matrix(300, 40, 3, seed=0)
    for pkg in (jf, tf):
        with pytest.raises(ValueError, match="divisible by block_size"):
            getattr(pkg, cls).from_dense(W, block_size=128)


def test_containers_from_torch_on_their_device():
    W = _matrix(256, 64, 2, seed=3)
    Wt = torch.from_numpy(W).to(torch.float32)
    for cls in CASES:
        kw = {"block_size": 128} if "Blocked" in cls else {}
        a = getattr(tf, cls).from_dense(W, **kw)
        b = getattr(tf, cls).from_dense(Wt, device="cpu", **kw)
        for f in a.ARRAY_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (cls, f)
        assert a.device == torch.device("cpu")


def test_interleave_streams_matches_jax():
    from ternary_spgemm_tpu.formats.blocked import _interleave_streams as jis
    from ternary_spgemm_tpu_torch.formats.blocked import (
        _interleave_streams as tis)

    rng = np.random.default_rng(0)
    for P, Q, g in [(0, 0, 1), (9, 3, 4), (4, 8, 4), (13, 13, 6), (5, 0, 1)]:
        pos = np.sort(rng.choice(100, P, replace=False)).astype(np.int32)
        neg = np.sort(rng.choice(100, Q, replace=False)).astype(np.int32)
        ji, js, jp = jis(pos, neg, g)
        ti, ts, tp = tis(torch.from_numpy(pos), torch.from_numpy(neg), g)
        assert tp == jp
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(ts.numpy(), js)


def test_base3_codec_matches_jax_on_every_byte():
    """``pack_signs_base3`` / ``unpack_signs_base3`` on every stream of
    five signs (all 243 bytes) and on ragged lengths."""
    digits = np.array(np.meshgrid(*[[-1, 0, 1]] * 5, indexing="ij"),
                      np.int8).reshape(5, -1).T.reshape(-1)
    for n in (len(digits), 0, 1, 7, 243 * 5 - 3):
        signs = digits[:n]
        want = jf.pack_signs_base3(signs)
        got = tf.pack_signs_base3(torch.from_numpy(signs))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tf.unpack_signs_base3(got, n).numpy(),
            jf.unpack_signs_base3(want, n))
    assert sorted(set(tf.pack_signs_base3(
        torch.from_numpy(digits)).tolist())) == list(range(243))


def test_nothing_is_unported():
    assert unported() == []
    assert set(KERNELS) <= set(all_kernels())
    for name, cls in KERNELS.items():
        spec = all_kernels()[name]
        assert spec.format_cls.__name__ == cls \
            == jax_kernels()[name].format_cls.__name__
        assert not spec.source and spec.plain is None   # torch ops


@pytest.fixture(scope="module")
def inputs():
    W = _matrix(K, N, 3, seed=11)
    rng = np.random.default_rng(5)
    xs = {"integer": jf.generate_x(9, K, seed=2),
          "non-integer": rng.uniform(-2, 2, (9, K)).astype(np.float32)}
    fmts = {}
    for name, cls in KERNELS.items():
        kw = dict(BLOCKED) if "Blocked" in cls else {}
        if cls == "InterleavedBlockedTCSC":
            kw["group"] = 6
        fmts[name] = _both(cls, W, kw)
    return W, xs, fmts, jf.generate_bias(N), jf.generate_alpha(N)


@pytest.mark.parametrize("prelu", [False, True])
@pytest.mark.parametrize("x_kind", ["integer", "non-integer"])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_equals_jax_and_reference(inputs, name, x_kind, prelu):
    W, xs, fmts, b, a = inputs
    X = xs[x_kind]
    al = a if prelu else None
    jfmt, tfmt = fmts[name]
    yj = np.asarray(jax_kernels()[name](X, jfmt, b, al))
    yt = all_kernels()[name](torch.from_numpy(X), tfmt, torch.from_numpy(b),
                             None if al is None else torch.from_numpy(al))
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (9, N)
    want = (jref.dense_gemm_prelu(X, W, b, a) if prelu
            else jref.dense_gemm(X, W, b))
    if x_kind == "integer":
        assert tref.compare_results(yt, want)
        assert tref.compare_results(yt, yj)
        np.testing.assert_array_equal(yt.numpy(), yj)
    else:
        np.testing.assert_allclose(yt.numpy(), yj, **NONINT_TOL)
        np.testing.assert_allclose(yt.numpy(), np.asarray(want), **NONINT_TOL)


def test_ell_kernel_walks_m_in_chunks(monkeypatch, inputs):
    """Above the gather budget the ELL kernel walks M in chunks and gives
    the unchunked result bitwise."""
    from ternary_spgemm_tpu_torch.ops import xla_kernels

    W, xs, fmts, b, _ = inputs
    X = torch.from_numpy(xs["non-integer"])
    f = fmts["EllTCSC"][1]
    whole = all_kernels()["EllTCSC"](X, f, torch.from_numpy(b))
    cap = max(f.idx_pos.shape[0], f.idx_neg.shape[0])
    monkeypatch.setattr(xla_kernels, "_CHUNK_BUDGET_FLOATS",
                        2 * cap * f.idx_pos.shape[1])
    assert torch.equal(all_kernels()["EllTCSC"](X, f, torch.from_numpy(b)),
                       whole)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_default_dispatch_takes_the_formulation(inputs, name):
    """Each of the six containers has one fully exact kernel, which default
    dispatch takes (as JAX's does off the TPU)."""
    from ternary_spgemm_tpu_torch.ops import ternary_spgemm

    W, xs, fmts, b, _ = inputs
    X = torch.from_numpy(xs["integer"])
    got = ternary_spgemm(X, fmts[name][1], torch.from_numpy(b))
    assert torch.equal(got, all_kernels()[name](X, fmts[name][1],
                                                torch.from_numpy(b)))
