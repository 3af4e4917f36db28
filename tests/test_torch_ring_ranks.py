"""The port's ring all-gather SpMM one rank a process
(``ring_rank_local``, ``ring_allgather_spgemm(..., mesh=, axis=)``) on the
CPU, against the JAX ring kernel.

The JAX kernel runs here as its own tests run it
(``tests/test_ring_kernel.py``): in Pallas TPU interpret mode on the
conftest's 8 host devices. The port's runs in one gloo group of 4
processes over localhost (``tests/torch_mp_worker.py``, suite ``ring``):
each rank's plain version sends its chunks to its right neighbour with
``torch.distributed`` point-to-point calls, at d = 4 over the group and d
= 2 over a subgroup, and the ``mesh=`` / ``axis=`` entry point runs over
CPU meshes of 2 and 4 ranks. The same numpy-seeded X, W and bias go to
both, at the JAX test's shape (K = 64, NL = 128, mc = 8): bitwise on
integer X, where every partial sum is exact, and within atol=1e-5 on
non-integer X (the JAX dot and the port's matmul sum in their own
orders). The per-rank CUDA kernel is held against the one-launch ring on
the card (``tests/test_torch_cuda.py -k ring``, ``chip_smoke.py`` phase
11b).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_mp_worker as mpw
from ternary_spgemm_tpu.formats import DenseTernary as JDenseTernary
from ternary_spgemm_tpu.formats import (generate_bias, generate_ternary,
                                        generate_x)
from ternary_spgemm_tpu.parallel import make_mesh
from ternary_spgemm_tpu.parallel import ring_allgather_spgemm as jring
from ternary_spgemm_tpu_torch.formats import DenseTernary
from ternary_spgemm_tpu_torch.formats import TiledBitplane
from ternary_spgemm_tpu_torch.parallel import ring_allgather_spgemm

#: the JAX test's shape (``tests/test_ring_kernel.py:36``)
K, NL, MC = 64, 128, 8
CASES = [(d, kind) for d in (2, 4) for kind in ("int", "float")]


def _inputs(d, kind):
    W = generate_ternary(K, NL * d, 4, seed=3)
    if kind == "int":
        X = generate_x(MC * d, K, seed=4)
    else:
        X = np.random.default_rng(4).uniform(
            -2.0, 2.0, (MC * d, K)).astype(np.float32)
    return X, W, generate_bias(NL * d)


def _jax_ring(X, W, b, d):
    from jax.experimental.pallas import tpu as pltpu

    out = jring(jnp.asarray(X), JDenseTernary.from_dense(W), b,
                mesh=make_mesh({"model": d}), axis="model",
                interpret=pltpu.InterpretParams())
    return np.asarray(out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    arrays = {}
    for d, kind in CASES:
        for name, a in zip("XWb", _inputs(d, kind)):
            arrays[f"{kind}/{d}/{name}"] = a
    np.savez(tmp / "in_ring.npz", **arrays)
    return mpw.spawn("ring", 4, tmp)


@pytest.fixture(scope="module")
def jax_out():
    return {(d, kind): _jax_ring(*_inputs(d, kind), d) for d, kind in CASES}


def _same(got, want, kind):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    if kind == "int":
        np.testing.assert_array_equal(got, want)


def _ok(record, case):
    assert "raised" not in record.get(case, {}), record[case]["trace"]
    return record[case]


@pytest.mark.parametrize("d,kind", CASES)
def test_rank_local_matches_jax_ring(port, jax_out, d, kind):
    """Each rank's columns from its own process, assembled in rank order:
    JAX's output; three calls on one communicator give the same Y."""
    arrays, record = port
    rec = _ok(record, f"local/{kind}/{d}")
    _same(arrays[f"local/{kind}/{d}"], jax_out[d, kind], kind)
    X, W, b = _inputs(d, kind)
    ref = X.astype(np.float64) @ W.astype(np.float64) + b[None, :]
    np.testing.assert_allclose(arrays[f"local/{kind}/{d}"], ref, atol=1e-5)
    assert rec["calls"] == 3 and rec["same"]


@pytest.mark.parametrize("d,kind", CASES)
def test_rank_local_schedule(port, d, kind):
    """Rank r multiplies at step t the chunk of owner (r - t) mod d, which
    arrived from its left neighbour: every rank sees every chunk once."""
    _, record = port
    for r, steps in enumerate(_ok(record, f"local/{kind}/{d}")["trace"]):
        assert [tuple(s) for s in steps] == [
            (t, r, (r - t) % d, True) for t in range(d)]


@pytest.mark.parametrize("d,kind", CASES)
def test_mesh_entry_matches_jax_ring(port, jax_out, d, kind):
    """``mesh=`` / ``axis=``: a DTensor laid out ``(None, "model")``, whose
    ``full_tensor()`` is JAX's output (the 2-rank mesh as two copies in
    the 4-rank group)."""
    arrays, record = port
    rec = _ok(record, f"mesh/{kind}/{d}")
    assert rec["placements"] == "(Shard(dim=1),)"
    assert rec["local"] == [MC * d, NL]
    _same(arrays[f"mesh/{kind}/{d}"], jax_out[d, kind], kind)


def test_mesh_entry_takes_dtensors(port, jax_out):
    arrays, record = port
    assert _ok(record, "mesh_dtensor")["placements"] == "(Shard(dim=1),)"
    _same(arrays["mesh_dtensor"], jax_out[4, "int"], "int")


def test_close_ring_comms_empties_the_cache(port):
    """The mesh path made one communicator a (group, chunk shape): the
    2-rank and the 4-rank mesh's; ``close_ring_comms``, called by every
    rank, closes and forgets both."""
    _, record = port
    assert _ok(record, "close") == {"made": 2, "left": 0}


@pytest.mark.parametrize("M,match", [(30, "not divisible"),
                                     (12, "multiple of 8")])
def test_mesh_entry_raises_jax_errors(port, M, match):
    """The JAX kernel's two errors (``ring_kernel.py:101-105``), type and
    text, from the mesh path for the same rows and ring size."""
    _, record = port
    W = generate_ternary(K, 128, 4, seed=3)
    with pytest.raises(ValueError, match=match) as e:
        jring(jnp.ones((M, K)), JDenseTernary.from_dense(W),
              generate_bias(128), mesh=make_mesh({"model": 4}), axis="model")
    assert record[f"err/{M}"]["raised"] == "ValueError"
    assert record[f"err/{M}"]["message"] == str(e.value)


@pytest.mark.parametrize("kw", [
    {"mesh": object(), "axis": "model", "ranks": 2}, {},
    {"mesh": object()}, {"axis": "model", "ranks": 2}],
    ids=["both", "neither", "mesh_alone", "axis_alone"])
def test_entry_takes_mesh_and_axis_or_ranks(kw):
    X, W, b = _inputs(2, "int")
    with pytest.raises(TypeError, match="mesh= and axis="):
        ring_allgather_spgemm(X, DenseTernary.from_dense(W), b, device="cpu",
                              **kw)


@pytest.mark.parametrize("kw", [{"mesh": object(), "axis": "model"},
                                {"ranks": 2}], ids=["mesh", "ranks"])
def test_entry_takes_a_dense_ternary(kw):
    X, W, b = _inputs(2, "int")
    with pytest.raises(TypeError, match="DenseTernary"):
        ring_allgather_spgemm(X, TiledBitplane.from_dense(W, tile_n=128), b,
                              device="cpu", **kw)


def test_mesh_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, W, b = _inputs(2, "int")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ring_allgather_spgemm(X, DenseTernary.from_dense(W), b,
                              mesh=object(), axis="model")


def test_a_bare_cuda_device_is_the_current_card(monkeypatch):
    """The communicator's device names its card: a bare ``"cuda"`` (the
    entry point's default) becomes the current card, the card that the
    chunk's tensors land on, so that the launch's check that the
    communicator and the chunk share a device holds."""
    from ternary_spgemm_tpu_torch.parallel import ring_kernel as rk

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert rk._indexed("cuda") == torch.device("cuda", 3)
    assert rk._indexed(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert rk._indexed("cpu") == torch.device("cpu")
