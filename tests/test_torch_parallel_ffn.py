"""The port's tensor-parallel fused SwiGLU (``ternary_spgemm_tpu_torch.
parallel.tensor_parallel_fused_swiglu``) against the JAX package's, on the
CPU.

As ``tests/test_parallel_ffn.py``: the TP block requantizes the hidden
state per shard, so the reference is the sum of per-shard unfused blocks
(JAX's, with ``PallasTiledBitplane_i8``), held at that test's rtol 1e-5 /
atol 0.01; d = 1 is the single-device kernel. The port runs in one gloo
group of 4 processes (``tests/torch_mp_worker.py``, suite ``ffn``) on the
same int8 activations and scales; its own per-shard plain reference
agrees with its TP output bit for bit where the sum has two terms.
"""

import numpy as np
import pytest

import torch_mp_worker as mpw
from ternary_spgemm_tpu.formats import (
    TiledBitplane,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu.ops.fused_ffn import (
    fused_bitplane_swiglu,
    requantize_rows,
    unfused_reference_swiglu,
)
from ternary_spgemm_tpu.parallel import make_mesh, tensor_parallel_fused_swiglu

KERNEL = "PallasTiledBitplane_i8"
GAMMAS = dict(gamma_gate=0.021, gamma_up=0.034, gamma_down=1.3)
TOL = dict(rtol=1e-5, atol=0.01)


def _arrays(M=8, K=128, N1=512, N2=128, s=4):
    Wg = generate_ternary(K, N1, s, seed=0)
    Wu = generate_ternary(K, N1, s, seed=1)
    Wd = generate_ternary(N1, N2, s, seed=2)
    xq, sx = requantize_rows(generate_x(M, K, seed=3))
    return (Wg, Wu, Wd), (np.asarray(xq), np.asarray(sx))


def _fmts(Ws, tile_n, tkb_down=16):
    return (TiledBitplane.from_dense(Ws[0], tile_n=tile_n),
            TiledBitplane.from_dense(Ws[1], tile_n=tile_n),
            TiledBitplane.from_dense(Ws[2], tkb=tkb_down))


def _per_shard_reference(Ws, xq, sx, n_dev, tile_n):
    Wg, Wu, Wd = Ws
    w = Wg.shape[1] // n_dev
    y = None
    for d in range(n_dev):
        cols = slice(d * w, (d + 1) * w)
        ys = unfused_reference_swiglu(
            xq, sx, TiledBitplane.from_dense(Wg[:, cols], tile_n=tile_n),
            TiledBitplane.from_dense(Wu[:, cols], tile_n=tile_n),
            TiledBitplane.from_dense(Wd[cols, :], tkb=16), kernel=KERNEL,
            **GAMMAS)
        y = ys if y is None else y + ys
    return np.asarray(y)


@pytest.fixture(scope="module")
def problems():
    return {"p256": (_arrays(), 256), "p128": (_arrays(), 128),
            "sub": (_arrays(K=64, N1=256, N2=64), 128)}


@pytest.fixture(scope="module")
def port(problems, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ffn")
    inputs = {f"gamma/{k}": np.float64(v) for k, v in GAMMAS.items()}
    for name, ((Ws, (xq, sx)), _) in problems.items():
        for k, a in zip(("Wg", "Wu", "Wd", "xq", "sx"), (*Ws, xq, sx)):
            inputs[f"{name}/{k}"] = np.asarray(a)
    inputs["wide_down"] = generate_ternary(512, 130, 4, seed=4)
    np.savez(tmp / "in_ffn.npz", **inputs)
    return mpw.spawn("ffn", 4, tmp)


def _ok(port, case):
    rec = port[1].get(case, {})
    assert "raised" not in rec, rec.get("trace")


@pytest.mark.parametrize("n_dev,tile_n", [(1, 256), (2, 256), (4, 128)])
def test_tp_fused_swiglu_matches_per_shard_reference(port, problems, n_dev,
                                                     tile_n):
    _ok(port, f"tp/{n_dev}/{tile_n}")
    (Ws, (xq, sx)), _ = problems[f"p{tile_n}"]
    got = port[0][f"tp/{n_dev}/{tile_n}"]
    want = _per_shard_reference(Ws, xq, sx, n_dev, tile_n)
    np.testing.assert_allclose(got, want, **TOL)
    jtp = tensor_parallel_fused_swiglu(
        xq, sx, *_fmts(Ws, tile_n), mesh=make_mesh({"tp": n_dev}), axis="tp",
        **GAMMAS)
    np.testing.assert_allclose(got, np.asarray(jtp), **TOL)
    # the port's own per-shard plain reference: the same bits up to two
    # shards (a + b is b + a); over four the all-reduce adds the partials
    # in its own order (last bits of sums that cancel: JAX's tolerance)
    ref = port[0][f"tp/{n_dev}/{tile_n}/ref"]
    if n_dev <= 2:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, **TOL)


def test_tp_p1_equals_single_device(port, problems):
    _ok(port, "p1")
    (Ws, (xq, sx)), _ = problems["p256"]
    want = np.asarray(fused_bitplane_swiglu(xq, sx, *_fmts(Ws, 256),
                                            **GAMMAS))
    np.testing.assert_allclose(port[0]["p1"], want, **TOL)
    np.testing.assert_array_equal(port[0]["p1"], port[0]["p1/single"])


def test_tp_scatter_output(port, problems):
    _ok(port, "scatter")
    (Ws, (xq, sx)), _ = problems["p256"]
    assert port[1]["scatter"]["placements"] == "(Shard(dim=1),)"
    assert port[1]["scatter"]["local"] == [8, 64]
    np.testing.assert_allclose(port[0]["scatter"],
                               _per_shard_reference(Ws, xq, sx, 2, 256),
                               **TOL)


def test_tp_subtile_output_width(port, problems):
    """N2 = 64 < the 128-column tile: the local container reports the
    padded width and the pad columns are cut before the sum."""
    _ok(port, "subtile")
    (Ws, (xq, sx)), _ = problems["sub"]
    got = port[0]["subtile"]
    assert got.shape == (8, 64)
    np.testing.assert_allclose(got, _per_shard_reference(Ws, xq, sx, 2, 128),
                               **TOL)
    np.testing.assert_array_equal(got, port[0]["subtile/ref"])


@pytest.mark.parametrize("name", ["err/kblock", "err/tiles", "err/down_k",
                                  "err/scatter_n2"])
def test_tp_error_cases_match_jax(port, problems, name):
    """JAX's four ValueErrors, type and text."""
    (Ws, (xq, sx)), _ = problems["p128"]
    f128, f256 = _fmts(Ws, 128), _fmts(Ws, 256)
    fg, fu, fd, kw = {
        "err/kblock": (f128[0], f128[1], TiledBitplane.from_dense(Ws[2]), {}),
        "err/tiles": (*f256, {}),
        "err/down_k": (f128[0], f128[1],
                       TiledBitplane.from_dense(Ws[2][:256], tkb=16), {}),
        "err/scatter_n2": (f128[0], f128[1], TiledBitplane.from_dense(
            generate_ternary(512, 130, 4, seed=4), tkb=16),
            {"scatter_output": True}),
    }[name]
    with pytest.raises(ValueError) as e:
        tensor_parallel_fused_swiglu(xq, sx, fg, fu, fd,
                                     mesh=make_mesh({"tp": 4}), axis="tp",
                                     **kw, **GAMMAS)
    rec = port[1][name]
    assert (rec["raised"], rec["message"]) == ("ValueError", str(e.value))
