"""The port's sharded SpMM schemes (``ternary_spgemm_tpu_torch.parallel``)
against the JAX package's, on the CPU.

The JAX side runs here on conftest's 8-device CPU mesh, as
``tests/test_parallel.py`` runs it; the port's runs in one gloo group of 4
processes over localhost (``tests/torch_mp_worker.py``, suite
``parallel``), which holds every case and writes its results. Each test
below checks one case of that run: against the dense reference at
``compare_results``'s 1e-5 and against JAX's global output, and the error
cases for JAX's exception and text. The spec and ``localize`` tests need no
group. The port's ring runs over 4 ranks where JAX's test takes 8.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_mp_worker as mpw
from ternary_spgemm_tpu import reference
from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu.parallel import (
    column_leaf_specs as jcolumn_specs,
    column_sharded_spgemm as jcolumn,
    localize as jlocalize,
    make_mesh as jmesh,
    overlapped_gather_spgemm as jring,
    row_leaf_specs as jrow_specs,
    row_sharded_spgemm as jrow,
)
from ternary_spgemm_tpu_torch import formats as pf
from ternary_spgemm_tpu_torch.parallel import (
    SHARDABLE_FORMATS,
    column_leaf_specs,
    localize,
    row_leaf_specs,
    spec_tree,
)

M, K, N, S = 16, 128, 512, 4
SHARDABLE = [c.__name__ for c in SHARDABLE_FORMATS]


@pytest.fixture(scope="module")
def problem():
    W = jf.generate_ternary(K, N, S, seed=11)
    X = jf.generate_x(M, K, seed=12)
    b, alpha = jf.generate_bias(N), jf.generate_alpha(N)
    want = np.asarray(reference.dense_gemm(X, W, b))
    want_p = np.asarray(reference.dense_gemm_prelu(X, W, b, alpha))
    return W, X, b, alpha, want, want_p


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return mpw.spawn("parallel", 4, tmp_path_factory.mktemp("parallel"))


def _jax_error(fn):
    with pytest.raises((ValueError, TypeError)) as e:
        fn()
    return type(e.value).__name__, str(e.value)


@pytest.fixture(scope="module")
def jax_errors(problem):
    W, X, b, *_ = problem
    m2, m4 = jmesh({"model": 2}), jmesh({"model": 4})
    return {
        "err/global_packed_row": lambda: jrow(
            X, jf.PackedTernary53.from_dense(W), b, mesh=m4, axis="model"),
        "err/tiled_column": lambda: jcolumn(
            X, jf.TiledDenseTernary.from_dense(W[:, :N - 128], tile_k=32,
                                               tile_n=256),
            b[:N - 128], mesh=m2, axis="model"),
        "err/blockpacked_row": lambda: jrow(
            X[:, :112], jf.BlockPackedTernary.from_dense(
                W[:112], factor=4, tile_kq=16), b, mesh=m2, axis="model"),
        "err/blockpacked_block_split": lambda: jrow(
            X, jf.BlockPackedTernary.from_dense(W, factor=4, tile_kq=16), b,
            mesh=m4, axis="model"),
        "err/blocked_ell_column": lambda: jcolumn(
            X, jf.BlockedEllTCSC.from_dense(W[:, :N - 128], tile_n=256),
            b[:N - 128], mesh=m2, axis="model"),
        "err/blocked_ell_row": lambda: jrow(
            X[:, :112], jf.BlockedEllTCSC.from_dense(W[:112], block_k=64), b,
            mesh=m2, axis="model"),
        "err/unshardable": lambda: jcolumn(
            X, jf.TCSC.from_dense(W), b, mesh=m4, axis="model"),
    }


def _check(port, name, want, jax_out=None):
    """The port's output ``name`` against the dense reference and, where
    given, JAX's global output (the PReLU variants: the reference alone,
    as JAX's own tests check them)."""
    arrays, record = port
    case = name.split("/prelu")[0]
    assert "raised" not in record.get(case, {}), record[case]["trace"]
    got = arrays[name]
    assert reference.compare_results(got, want)
    if jax_out is not None:
        assert reference.compare_results(got, np.asarray(jax_out))


@pytest.mark.parametrize("cls", ["DenseTernary", "PackedTernary53",
                                 "BlockedEllTCSC", "TiledBitplane"])
def test_column_sharded(port, problem, cls):
    W, X, b, alpha, want, want_p = problem
    mesh = jmesh({"model": 4})
    tiled = cls == "TiledBitplane"
    fmt = getattr(jf, cls).from_dense(W, **({"tile_n": 128} if tiled else {}))
    kw = {"kernel": "PallasTiledBitplane_i8"} if tiled else {}
    _check(port, f"column/{cls}", want,
           jcolumn(X, fmt, b, mesh=mesh, axis="model", **kw))
    _check(port, f"column/{cls}/prelu", want_p)


def test_column_sharded_with_placed_container(port, problem):
    _, record = port
    assert record["placed"]["leaf_placements"] == "(Shard(dim=1),)"
    _check(port, "placed", problem[4])


def test_2d_mesh_data_x_model(port, problem):
    W, X, b, _, want, _ = problem
    out = jcolumn(X, jf.PackedTernary53.from_dense(W), b,
                  mesh=jmesh({"data": 2, "model": 4}), axis="model",
                  batch_axis="data")
    _check(port, "2d", want, out)
    assert port[1]["2d"]["placements"] == "(Shard(dim=0), Shard(dim=1))"


@pytest.mark.parametrize("scatter", [False, True])
def test_row_sharded(port, problem, scatter):
    W, X, b, alpha, want, want_p = problem
    mesh, fmt = jmesh({"model": 4}), jf.DenseTernary.from_dense(W)
    _check(port, f"row/{scatter}", want, jrow(
        X, fmt, b, mesh=mesh, axis="model", scatter_output=scatter))
    _check(port, f"row/{scatter}/prelu", want_p)
    assert port[1][f"row/{scatter}"]["placements"] == (
        "(Shard(dim=1),)" if scatter else "(Replicate(),)")


@pytest.mark.parametrize("name,build", [
    ("row_blocked_ell", lambda W: jf.BlockedEllTCSC.from_dense(W, block_k=32)),
    ("row_blockpacked", lambda W: jf.BlockPackedTernary.from_dense(
        W, factor=4, tile_kq=8)),
    ("row_tiled_dense", lambda W: jf.TiledDenseTernary.from_dense(
        W, tile_k=32, tile_n=128)),
    ("row_tiled_blockpacked", lambda W: jf.TiledBlockPacked.from_dense(
        W, factor=4, tile_kq=8, tile_n=128)),
    ("row_tiled_bitplane", lambda W: jf.TiledBitplane.from_dense(W, tkb=4)),
])
def test_row_sharded_blocked_and_tiled(port, problem, name, build):
    W, X, b, _, want, _ = problem
    _check(port, name, want, jrow(X, build(W), b, mesh=jmesh({"model": 4}),
                                  axis="model"))


def test_tiled_column_sharded(port, problem):
    W, X, b, _, want, _ = problem
    fmt = jf.TiledDenseTernary.from_dense(W, tile_k=32, tile_n=128)
    _check(port, "column_tiled_dense", want,
           jcolumn(X, fmt, b, mesh=jmesh({"model": 4}), axis="model"))


@pytest.mark.parametrize("cls", ["DenseTernary", "PackedTernary53"])
def test_overlapped_gather(port, problem, cls):
    W, X, b, alpha, want, want_p = problem
    mesh, fmt = jmesh({"model": 8}), getattr(jf, cls).from_dense(W)
    _check(port, f"ring/{cls}", want,
           jring(X, fmt, b, mesh=mesh, axis="model"))
    _check(port, f"ring/{cls}/prelu", want_p)
    assert port[1][f"ring/{cls}"]["placements"] == "(Shard(dim=1),)"


@pytest.mark.parametrize("scheme", ["column", "ring", "row"])
def test_container_from_local_shard(port, problem, scheme):
    """Each rank packs only its own slice of W (mp_worker.py's schemes)."""
    _check(port, f"local_shard/{scheme}", problem[4])


@pytest.mark.parametrize("name", [
    "err/global_packed_row", "err/tiled_column", "err/blockpacked_row",
    "err/blockpacked_block_split", "err/blocked_ell_column",
    "err/blocked_ell_row", "err/unshardable"])
def test_error_cases_match_jax(port, jax_errors, name):
    kind, msg = _jax_error(jax_errors[name])
    rec = port[1][name]
    assert (rec["raised"], rec["message"]) == (kind, msg)


# ---------------------------------------------------------------------------
# specs and localize: no group needed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", SHARDABLE + ["TCSC"])
@pytest.mark.parametrize("kind", ["column", "row"])
def test_leaf_specs_match_jax(cls, kind):
    port_fn, jax_fn = {"column": (column_leaf_specs, jcolumn_specs),
                       "row": (row_leaf_specs, jrow_specs)}[kind]
    try:
        want = [tuple(s) for s in jax_fn(getattr(jf, cls), "model")]
    except TypeError as e:
        with pytest.raises(TypeError) as te:
            port_fn(getattr(pf, cls), "model")
        assert str(te.value) == str(e)
        return
    assert port_fn(getattr(pf, cls), "model") == want


def _containers(cls):
    """A JAX container of ``cls`` with two or more blocks along every
    sharded dim (K = 496: two deposit superblocks)."""
    W = jf.generate_ternary(496, 512, 4, seed=3)
    kw = {"TiledDenseTernary": dict(tile_k=32, tile_n=128),
          "TiledBlockPacked": dict(factor=4, tile_kq=8, tile_n=128),
          "BlockPackedTernary": dict(factor=4, tile_kq=8),
          "BlockedEllTCSC": dict(block_k=32, tile_n=128),
          "TiledEllTCSC": dict(block_k=32, tile_n=128),
          "TiledBitplane": dict(tkb=4, tile_n=128),
          "TiledEllDeposit": dict(tile_n=128)}.get(cls, {})
    return getattr(jf, cls).from_dense(W, **kw)


@pytest.mark.parametrize("cls,kind", [
    (c, k) for c in SHARDABLE for k in ("column", "row")
    if not (k == "row" and c.startswith("PackedTernary"))])
def test_localize_matches_jax(cls, kind):
    """Rank 1's shard of a 2-way split, localized by both packages: the
    same class, static fields and arrays."""
    jfmt = _containers(cls)
    specs = {"column": jcolumn_specs, "row": jrow_specs}[kind](
        type(jfmt), "model")
    leaves, treedef = jax.tree_util.tree_flatten(jfmt)
    shards = []
    for leaf, spec in zip(leaves, specs):
        a = np.asarray(leaf)
        dim = next(d for d, s in enumerate(spec) if s == "model")
        shards.append(np.split(a, 2, axis=dim)[1])
    want = jlocalize(jax.tree_util.tree_unflatten(treedef, shards))
    pcls = getattr(pf, cls)
    meta = {f.name: getattr(jfmt, f.name) for f in dataclasses.fields(pcls)
            if f.name not in pcls.ARRAY_FIELDS}
    got = localize(pcls(**{f: torch.from_numpy(np.ascontiguousarray(s))
                           for f, s in zip(pcls.ARRAY_FIELDS, shards)},
                        **meta))
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(pcls):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in pcls.ARRAY_FIELDS:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert g == w, f.name


def test_spec_tree_is_the_leaf_list():
    fmt = pf.BlockedEllTCSC.from_dense(jf.generate_ternary(64, 256, 4))
    specs = column_leaf_specs(pf.BlockedEllTCSC, "model")
    assert spec_tree(fmt, specs) == specs
    with pytest.raises(ValueError, match="has 4 leaves"):
        spec_tree(fmt, specs[:2])
