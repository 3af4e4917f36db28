"""Port parity: generators and the containers (TiledBitplane,
TiledNibblePair, TiledDenseTernary, TiledBlockPacked, BlockPackedTernary,
PackedTernary2Bit, PackedTernary53, DenseTernary, TCSC, TiledEllTCSC,
BlockedEllTCSC, TiledEllDeposit).

The same numpy seeds go through the JAX package and the PyTorch port. The
container bytes are the contract between the two: every array must be
identical (``wsum`` as int32, the containers' documented dtype; the JAX
packers sum it in numpy's default integer).
"""

import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.formats import (
    format_from_buffers,
    register_format_buffers,
)


@pytest.mark.parametrize("K,N,s,uniform", [
    (37, 91, 3, False), (128, 300, 2, False), (16, 64, 4, True)])
def test_generate_ternary_identical(K, N, s, uniform):
    np.testing.assert_array_equal(
        tf.generate_ternary(K, N, s, seed=5, uniform=uniform),
        jf.generate_ternary(K, N, s, seed=5, uniform=uniform))


def test_generate_x_bias_alpha_identical():
    np.testing.assert_array_equal(tf.generate_x(7, 33, seed=3),
                                  jf.generate_x(7, 33, seed=3))
    np.testing.assert_array_equal(tf.generate_x(4, 9, seed=1, value_range=127),
                                  jf.generate_x(4, 9, seed=1, value_range=127))
    np.testing.assert_array_equal(tf.generate_bias(12), jf.generate_bias(12))
    np.testing.assert_array_equal(tf.generate_alpha(12), jf.generate_alpha(12))


def test_rowmap_identical():
    for tkb in (16, 32, 128):
        for a, b in zip(tf.bitplane_rowmap(tkb), jf.bitplane_rowmap(tkb)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("K,N,kw", [
    (100, 300, {}),                      # odd shape, one block, one tile
    (2500, 260, {}),                     # nb > 1
    (300, 700, {"tile_n": 128}),         # gn > 1
    (384, 256, {"tkb": 16}),             # explicit small blocks
    (1000, 5000, {}),                    # default tile_n = 4096 -> gn = 2
])
def test_bitplane_bytes_identical(K, N, kw):
    W = jf.generate_ternary(K, N, 3, seed=K + N)
    j = jf.TiledBitplane.from_dense(W, **kw)
    t = tf.TiledBitplane.from_dense(W, **kw)
    assert (t.K, t.N, t.tkb, t.tile_n) == (j.K, j.N, j.tkb, j.tile_n)
    assert t.plane.dtype == torch.uint8 and t.wsum.dtype == torch.int32
    assert tuple(t.plane.shape) == j.plane.shape
    assert tuple(t.wsum.shape) == j.wsum.shape
    np.testing.assert_array_equal(t.plane.numpy(), np.asarray(j.plane))
    np.testing.assert_array_equal(t.wsum.numpy(),
                                  np.asarray(j.wsum).astype(np.int32))
    np.testing.assert_array_equal(t.to_dense().numpy(), W)
    assert t.size_bytes() == t.plane.numel() + 4 * t.wsum.numel()


def test_bitplane_from_torch_and_roundtrip():
    W = jf.generate_ternary(200, 150, 2, seed=9)
    a = tf.TiledBitplane.from_dense(W)
    b = tf.TiledBitplane.from_dense(torch.from_numpy(W).to(torch.float32))
    assert torch.equal(a.plane, b.plane) and torch.equal(a.wsum, b.wsum)
    assert torch.equal(a.to("cpu").to_dense(), torch.from_numpy(W))
    with pytest.raises(ValueError, match="only contain"):
        tf.TiledBitplane.from_dense(np.full((4, 4), 2, np.int8))


def test_container_as_module_buffers():
    fmt = tf.TiledBitplane.from_dense(jf.generate_ternary(64, 96, 2, seed=2))
    mod = torch.nn.Module()
    register_format_buffers(mod, fmt)
    names = {n for n, _ in mod.named_buffers()}
    assert names == {"fmt_plane", "fmt_wsum"}
    back = format_from_buffers(mod)
    assert back.meta() == fmt.meta() and torch.equal(back.plane, fmt.plane)


#: container -> the shapes and packer arguments it is checked at
CASES = {
    "TiledNibblePair": [(100, 300, {}), (2500, 260, {}),
                        (300, 700, {"tile_n": 128}), (384, 256, {"tkb": 16}),
                        (1000, 5000, {})],
    "TiledDenseTernary": [(100, 300, {}), (700, 260, {"tile_k": 64}),
                          (300, 700, {"tile_n": 128}), (1000, 5000, {})],
    "TCSC": [(100, 300, {}), (2500, 260, {}), (37, 91, {})],
    "DenseTernary": [(100, 300, {}), (37, 91, {})],
    # ragged K (not a multiple of the block factor * tile_kq), any tile_kq
    "BlockPackedTernary": [(300, 260, {"factor": 4, "tile_kq": 16}),
                           (300, 260, {"factor": 5, "tile_kq": 32}),
                           (301, 259, {"factor": 5, "tile_kq": 13}),
                           (1000, 130, {}), (1000, 130, {"factor": 5})],
    "TiledBlockPacked": [(300, 260, {"factor": 4, "tile_kq": 16,
                                     "tile_n": 128}),
                         (301, 259, {"factor": 5, "tile_kq": 24,
                                     "tile_n": 128}),
                         (1000, 5000, {}), (2500, 300, {"factor": 5})],
    # ragged K (not a multiple of 4 or 5) and N
    "PackedTernary2Bit": [(300, 260, {}), (301, 259, {}), (37, 91, {})],
    "PackedTernary53": [(300, 260, {}), (301, 259, {}), (999, 100, {})],
    # nb > 1 (block_k 31 or the default 127), gn > 1, ragged K and N
    "TiledEllTCSC": [(300, 260, {"block_k": 31, "tile_n": 128}),
                     (999, 1000, {}), (301, 259, {"block_k": 127}),
                     (64, 130, {"block_k": 1, "tile_n": 128})],
    # tile_n not a multiple of 32 (100), cap_align 1 and 16
    "BlockedEllTCSC": [(300, 260, {"block_k": 32, "tile_n": 128}),
                       (301, 259, {"tile_n": 100}), (999, 77, {}),
                       (300, 260, {"block_k": 31, "tile_n": 64,
                                   "cap_align": 1}),
                       (129, 300, {"cap_align": 16})],
    # nsb > 1 (K past 248), gn > 1, ragged K and N
    "TiledEllDeposit": [(300, 260, {"tile_n": 128}), (999, 1000, {}),
                        (248, 384, {"tile_n": 128}), (37, 91, {})],
}


@pytest.mark.parametrize("cls,K,N,kw", [
    (c, K, N, kw) for c, cases in CASES.items() for K, N, kw in cases])
def test_container_bytes_identical(cls, K, N, kw):
    W = jf.generate_ternary(K, N, 3, seed=K + N)
    j = getattr(jf, cls).from_dense(W, **kw)
    t = getattr(tf, cls).from_dense(W, **kw)
    assert t.meta() == {k: v for k, v in j.__dict__.items()
                        if k in t.meta()}
    for field in t.ARRAY_FIELDS:
        a, want = getattr(t, field), getattr(j, field)
        if want is None:                  # TCSC's lazy gather tables
            assert a is None
            continue
        want = np.asarray(want)
        assert a.dtype == (torch.int32 if field == "wsum"
                           else getattr(torch, str(want.dtype))), field
        np.testing.assert_array_equal(a.numpy(), want.astype(a.numpy().dtype))
    np.testing.assert_array_equal(t.to_dense().numpy(), W)
    assert t.size_bytes() == j.size_bytes()
    assert t.nnz == j.nnz == int(np.count_nonzero(W))


@pytest.mark.parametrize("K,N,s", [(300, 260, 3), (64, 512, 1), (129, 7, 2)])
def test_tcsc_ell_tables_identical(K, N, s):
    W = jf.generate_ternary(K, N, s, seed=K)
    j = jf.TCSC.from_dense(W).with_ell_tables()
    t = tf.TCSC.from_dense(W).with_ell_tables()
    np.testing.assert_array_equal(t.ell_pos.numpy(), j.ell_pos)
    np.testing.assert_array_equal(t.ell_neg.numpy(), j.ell_neg)


def test_tcsc_prepare_builds_tables_once(monkeypatch):
    from ternary_spgemm_tpu_torch.ops import xla_kernels

    fmt = tf.TCSC.from_dense(jf.generate_ternary(64, 96, 2, seed=4))
    assert fmt.prepare(4) is fmt and fmt.ell_pos is None
    monkeypatch.setattr(xla_kernels, "_GATHER_CHUNK_FLOATS", 4 * fmt.nnz - 1)
    prepared = fmt.prepare(4)
    assert prepared.ell_pos is not None and prepared is fmt.prepare(4)
    assert prepared.to("cpu").ell_neg is not None
    assert fmt.to("cpu").ell_pos is None       # None stays None when moved
    mod = torch.nn.Module()
    register_format_buffers(mod, fmt)
    assert format_from_buffers(mod).ell_pos is None


@pytest.mark.parametrize("cls", ["TiledBitplane", "TiledNibblePair",
                                 "TiledDenseTernary", "TiledBlockPacked",
                                 "BlockPackedTernary", "PackedTernary2Bit",
                                 "PackedTernary53", "DenseTernary"])
def test_default_nnz_counts_the_dense_matrix(cls):
    W = jf.generate_ternary(150, 70, 2, seed=6)
    assert getattr(tf, cls).from_dense(W).nnz == int(np.count_nonzero(W))


@pytest.mark.parametrize("factor", [4, 5])
def test_codecs_match_jax_on_every_byte(factor):
    """The port's decode of every byte 0..255 is the JAX containers' (both
    packages also decode bytes the packers never emit alike)."""
    from ternary_spgemm_tpu_torch.formats.packed import decode_fields

    p = np.arange(256, dtype=np.uint8).reshape(256, 1)
    j = jf.BlockPackedTernary(packed=p, K=factor * 256, N=1, factor=factor,
                              tile_kq=256)
    want = j.to_dense().reshape(factor, 256)
    got = torch.stack(decode_fields(torch.from_numpy(p[:, 0]), factor))
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_from_torch_and_bad_factor():
    W = jf.generate_ternary(90, 40, 2, seed=3)
    for cls in (tf.BlockPackedTernary, tf.TiledBlockPacked):
        a = cls.from_dense(W, factor=5, tile_kq=8)
        b = cls.from_dense(torch.from_numpy(W).to(torch.float32), factor=5,
                           tile_kq=8)
        assert torch.equal(a.arrays()[cls.ARRAY_FIELDS[0]],
                           b.arrays()[cls.ARRAY_FIELDS[0]])
        assert torch.equal(a.to("cpu").to_dense(), torch.from_numpy(W))
        with pytest.raises(ValueError, match="factor"):
            cls.from_dense(W, factor=3)
    d = tf.DenseTernary.from_dense(torch.from_numpy(W).t())
    assert d.dense.is_contiguous() and d.shape == (40, 90)


@pytest.mark.parametrize("cls", ["PackedTernary2Bit", "PackedTernary53",
                                 "TiledEllTCSC", "BlockedEllTCSC",
                                 "TiledEllDeposit"])
def test_new_containers_from_torch_and_roundtrip(cls):
    """The packers take a float torch tensor as they take numpy, and the
    stride-packed containers keep their factor as a class constant."""
    W = jf.generate_ternary(260, 140, 2, seed=8)
    a = getattr(tf, cls).from_dense(W)
    b = getattr(tf, cls).from_dense(torch.from_numpy(W).to(torch.float32))
    for field in a.ARRAY_FIELDS:
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    assert a.meta() == b.meta()
    assert torch.equal(b.to("cpu").to_dense(), torch.from_numpy(W))
    if cls.startswith("Packed"):
        assert a.FACTOR == getattr(jf, cls).FACTOR and "FACTOR" not in a.meta()


@pytest.mark.parametrize("cls,kw,says", [
    ("TiledEllTCSC", {"block_k": 128}, "block_k"),
    ("TiledEllTCSC", {"tile_n": 200}, "multiple of 128"),
    ("BlockedEllTCSC", {"block_k": 129}, "block_k"),
    ("BlockedEllTCSC", {"block_k": 0}, "block_k"),
    ("TiledEllDeposit", {"tile_n": 100}, "multiple of 128"),
])
def test_ell_packers_reject_bad_arguments(cls, kw, says):
    W = jf.generate_ternary(300, 400, 2, seed=1)
    with pytest.raises(ValueError, match=says):
        getattr(jf, cls).from_dense(W, **kw)
    with pytest.raises(ValueError, match=says):
        getattr(tf, cls).from_dense(W, **kw)
