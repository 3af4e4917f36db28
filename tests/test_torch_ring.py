"""The port's ring all-gather SpMM (``ternary_spgemm_tpu_torch/parallel/``)
on the CPU, against the JAX ring kernel.

The JAX kernel runs as its own tests run it (``tests/test_ring_kernel.py``):
in Pallas TPU interpret mode on the conftest's 8 host devices, which
emulates the ring's chips, remote copies and semaphores. The port's plain
version runs the same schedule step by step on CPU tensors. The same
numpy-seeded X, W and bias go to both at d in {2, 4, 8}: on integer X every
partial sum is exact, so the two agree to atol=1e-5 (and bitwise, in
fact). The schedule itself is checked from the plain version's trace. The
CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 11).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ternary_spgemm_tpu.formats import DenseTernary as JDenseTernary
from ternary_spgemm_tpu.formats import (generate_bias, generate_ternary,
                                        generate_x)
from ternary_spgemm_tpu.parallel import make_mesh
from ternary_spgemm_tpu.parallel import ring_allgather_spgemm as jring
from ternary_spgemm_tpu_torch.formats import DenseTernary
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.parallel import (
    ring_allgather_spgemm,
    ring_allgather_spgemm_plain,
    ring_launch,
)

#: the JAX test's shape (``tests/test_ring_kernel.py:36``)
K, NL, MC = 64, 128, 8


def _inputs(d, *, integer=True):
    W = generate_ternary(K, NL * d, 4, seed=3)
    if integer:
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


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_plain_ring_matches_jax_ring(d, integer):
    X, W, b = _inputs(d, integer=integer)
    want = _jax_ring(X, W, b, d)
    ck.reset_counts()
    got = ring_allgather_spgemm(X, DenseTernary.from_dense(W), b, ranks=d,
                                device="cpu").numpy()
    assert not ck.launches and not ck.plain_on_cuda      # CPU: plain version
    assert got.shape == want.shape == (MC * d, NL * d)
    np.testing.assert_allclose(got, want, atol=1e-5)
    ref = X.astype(np.float64) @ W.astype(np.float64) + b[None, :]
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if integer:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_ring_schedule(d):
    """Step t: every rank reads slot t % 2, holds the chunk of owner (me -
    t) mod d, and (but at the last step) copies it into its right
    neighbour's other slot, which that neighbour reads at step t + 1;
    every rank sees every chunk once, and every Y block is written once."""
    X, W, b = _inputs(d)
    X = torch.from_numpy(X)
    fmt = DenseTernary.from_dense(W)
    trace = []
    Y = ring_allgather_spgemm_plain(X, fmt, torch.from_numpy(b), ranks=d,
                                    trace=trace)
    assert [(r["step"], r["rank"]) for r in trace] == [
        (t, me) for t in range(d) for me in range(d)]
    by = {(r["step"], r["rank"]): r for r in trace}
    for (t, me), rec in by.items():
        assert rec["slot"] == t % 2
        assert rec["owner"] == (me - t) % d
        o = rec["owner"]
        assert torch.equal(rec["held"], X[o * MC:(o + 1) * MC])
        if t < d - 1:
            right = (me + 1) % d
            assert rec["sent_to"] == (right, (t + 1) % 2)
            nxt = by[(t + 1, right)]
            assert nxt["slot"] == rec["sent_to"][1] != by[(t, right)]["slot"]
            assert torch.equal(nxt["held"], rec["held"])
        else:
            assert rec["sent_to"] is None
    for me in range(d):
        assert sorted(by[(t, me)]["owner"] for t in range(d)) == list(range(d))
    want = X.double() @ torch.from_numpy(W).double() + torch.from_numpy(b)
    assert torch.equal(Y, want.float())


@pytest.mark.parametrize("M,match", [(30, "not divisible"),
                                     (12, "multiple of 8")])
def test_ring_validates_shapes_like_jax(M, match):
    """The two errors of the JAX kernel (``ring_kernel.py:101-105``), with
    the same words, for the same inputs."""
    W = generate_ternary(32, 128, 4, seed=0)
    b = generate_bias(128)
    with pytest.raises(ValueError, match=match):
        jring(jnp.ones((M, 32)), JDenseTernary.from_dense(W), b,
              mesh=make_mesh({"model": 4}), axis="model")
    with pytest.raises(ValueError, match=match):
        ring_allgather_spgemm(np.ones((M, 32), np.float32),
                              DenseTernary.from_dense(W), b, ranks=4,
                              device="cpu")


def test_ring_rejects_what_the_kernel_cannot_take():
    W = generate_ternary(32, 130, 4, seed=0)
    fmt = DenseTernary.from_dense(W)
    with pytest.raises(ValueError, match="N=130 not divisible"):
        ring_allgather_spgemm(np.ones((32, 32), np.float32), fmt,
                              generate_bias(130), ranks=4, device="cpu")
    with pytest.raises(ValueError, match="bias"):
        ring_allgather_spgemm(np.ones((32, 32), np.float32), fmt,
                              generate_bias(128), ranks=2, device="cpu")
    with pytest.raises(TypeError, match="DenseTernary"):
        ring_allgather_spgemm_plain(torch.ones((16, 32)), object(),
                                    torch.zeros(130), ranks=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_launch(torch.ones((16, 32)), DenseTernary.from_dense(W[:, :128]),
                    torch.zeros(128), ranks=2)


def test_ring_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, W, b = _inputs(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ring_allgather_spgemm(X, DenseTernary.from_dense(W), b, ranks=2)
