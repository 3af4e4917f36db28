"""The port's ragged-stream probe (``ternary_spgemm_tpu_torch/tools/
ragged_probe.py``) on the CPU, against the JAX tool (``tools/ragged_probe.py``).

The scalar-deposit kernel's plain version is held against a numpy OR over
the same entries (the CUDA kernel is held against the plain version on the
card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 10). The
tool's ``main`` runs with ``--device cpu`` at a tiny size: its record has
the JAX record's keys, its ``container_bytes`` are the bytes of the JAX
containers over the same W, and its floors count the nonzeros of that W.
The JAX tool's floors count twice as many (``tools/ragged_probe.py:121``):
that parity cell is an expected failure of the reference. The numbers of a
CPU run are host-clock numbers and are checked only for being positive.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.bench import BenchConfig, run_config
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.tools import ragged_probe as rp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--device", "cpu", "--kn", "256", "--s-values", "16", "32",
        "--M", "8"]


def _np_tile(ents: np.ndarray) -> np.ndarray:
    tile = np.zeros((8, 128), np.int64)
    np.bitwise_or.at(tile, (ents[:, 0], ents[:, 1]),
                     np.left_shift(1, ents[:, 2].astype(np.int64)))
    return tile.astype(np.int32)


def test_entries_are_the_jax_draws():
    """The JAX tool's three draws from ``default_rng(0)``, as int32."""
    ents = rp.scalar_entries(4096)
    rng = np.random.default_rng(0)
    want = np.stack([rng.integers(0, 8, 4096), rng.integers(0, 128, 4096),
                     rng.integers(0, 31, 4096)], axis=1).astype(np.int32)
    assert ents.dtype == np.int32 and ents.shape == (4096, 3)
    np.testing.assert_array_equal(ents, want)
    assert ents[:, 2].max() == 30 and ents[:, 0].max() == 7


@pytest.mark.parametrize("entries", [0, 1, 37, 4096, 65536])
def test_scalar_deposit_plain_matches_numpy(entries):
    ents = rp.scalar_entries(entries)
    ck.reset_counts()
    got = rp.scalar_deposit(torch.from_numpy(ents))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 128)
    np.testing.assert_array_equal(got.numpy(), _np_tile(ents))
    assert not ck.launches and not ck.plain_on_cuda      # CPU: plain version


def test_scalar_deposit_repeats_and_bit_30():
    """Entries that hit one word OR into it (order-free); bit 30, the
    highest the probe draws, stays positive in int32."""
    ents = np.array([[3, 5, 30], [3, 5, 0], [3, 5, 30], [7, 127, 4]],
                    np.int32)
    got = rp.scalar_deposit(torch.from_numpy(ents)).numpy()
    assert got[3, 5] == (1 << 30) | 1 and got[7, 127] == 16
    assert np.count_nonzero(got) == 2
    np.testing.assert_array_equal(
        rp.scalar_deposit(torch.from_numpy(ents[::-1].copy())).numpy(), got)


def test_scalar_deposit_checks_its_input():
    with pytest.raises(ValueError, match=r"\(n, 3\) int32"):
        rp.scalar_deposit(torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(n, 3\) int32"):
        rp.scalar_deposit(torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rp.scalar_deposit(torch.zeros((4, 3), dtype=torch.int32,
                                      device="meta"))


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    path = tmp_path_factory.mktemp("ragged") / "ragged.json"
    ck.reset_counts()
    assert rp.main([*ARGV, "--out", str(path)]) == 0
    assert not ck.launches and not ck.plain_on_cuda
    return json.loads(path.read_text())


def test_record_has_the_jax_keys(record):
    with open(os.path.join(ROOT, "bench_artifacts", "ragged_probe.json")) as f:
        jrec = json.load(f)
    # the JAX record on file lacks the floors (its Mosaic refused the
    # scalar kernel); the JAX tool writes them when the rate exists (:116)
    assert set(record) == set(jrec) | {"ragged_floor_analysis", "device"}
    assert record["device"] == "cpu"
    assert set(record["scalar_deposit"]) == {"entries", "seconds",
                                             "entries_per_s"}
    sd = record["scalar_deposit"]
    assert sd["entries"] == 4096 and sd["entries_per_s"] > 0
    assert sd["entries_per_s"] == pytest.approx(4096 / sd["seconds"])
    rows = record["high_sparsity"]
    assert [(r["s"], r["kernel"]) for r in rows] == [
        (s, k) for s in (16, 32) for k in rp.KERNELS]
    for row in rows:
        # and the branch the bitplane kernel took: the plain version here
        assert set(row) == set(jrec["high_sparsity"][0]) | {"branch"}
        assert row["branch"] == ("plain" if row["kernel"] == rp.KERNELS[0]
                                 else None)
        assert row["error"] is None and row["seconds"] > 0
    assert set(record["ragged_floor_analysis"]) == {"note", "floors_seconds"}


@pytest.mark.parametrize("s", [16, 32])
def test_container_bytes_are_the_jax_containers(record, s):
    W = jf.generate_ternary(256, 256, s, seed=0)
    want = {"CudaTiledBitplane_i8": jf.TiledBitplane.from_dense(W),
            "CudaEllDeposit_i8": jf.TiledEllDeposit.from_dense(W)}
    for row in record["high_sparsity"]:
        if row["s"] != s:
            continue
        jfmt = want[row["kernel"]]
        # the arrays as JAX holds them on its device (int32, not numpy's
        # int64 of the host-side packer's wsum)
        nbytes = sum(jnp.asarray(getattr(jfmt, f)).nbytes
                     for f in type(jfmt).ARRAY_FIELDS)
        assert row["container_bytes"] == nbytes == jfmt.size_bytes()


def test_container_bytes_agree_with_the_jax_subtraction():
    """Where the harness counts X and Y at 4 bytes (its reference byte
    formula, ``total_input_bytes``), the JAX tool's subtraction gives the
    container's own bytes."""
    M, kn = 8, 256
    cfg = BenchConfig(M=M, K=kn, N=kn, s=16, correctness=False,
                      min_seconds=0.0, kernels=list(rp.KERNELS),
                      device="cpu", timer="wall")
    for r in run_config(cfg):
        assert r.container_bytes == \
            r.total_input_bytes - 4 * (M * kn + M * kn + kn)


@pytest.mark.parametrize("s", [16, 32])
def test_floors_count_the_containers_nonzeros(record, s):
    nnz = int(np.count_nonzero(tf.generate_ternary(256, 256, s, seed=0)))
    assert nnz == 256 * 2 * ((256 // s) // 2)          # ~ K * N / s
    rate = record["scalar_deposit"]["entries_per_s"]
    got = record["ragged_floor_analysis"]["floors_seconds"][f"KN=256,s={s}"]
    assert got == pytest.approx(nnz / rate, rel=1e-12)


@pytest.mark.xfail(strict=True, reason=(
    "reference fault, tools/ragged_probe.py:121: the JAX floors take "
    "2*kn*kn//s nonzeros, twice what generate_ternary places (density 1/s, "
    "formats/generate.py:87-91); the port counts the container's "
    "(ROADMAP queue C)"))
@pytest.mark.parametrize("s", [16, 32])
def test_floors_parity_with_the_jax_formula(record, s):
    rate = record["scalar_deposit"]["entries_per_s"]
    jax_floor = (2 * 256 * 256 // s) / rate
    got = record["ragged_floor_analysis"]["floors_seconds"][f"KN=256,s={s}"]
    assert got == pytest.approx(jax_floor, rel=1e-6)


def test_ragged_probe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.scalar_deposit_rate()
