"""The port's ragged-stream probe (``ternary_spgemm_tpu_torch/tools/
ragged_probe.py``) on the CPU, against the JAX tool (``tools/ragged_probe.py``).

The scalar-deposit kernel's plain version is held against a numpy OR over
the same entries, and against it on a stream whose entries all hit one word
(the CUDA kernel is held against the plain version on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 10). The kernel's
grid (``deposit_plan``) covers the stream with no gap and no overlap. The
tool's ``main`` runs with ``--device cpu`` at a tiny size: its record has
the JAX record's keys, its ``container_bytes`` are the bytes of the JAX
containers over the same W, and each floor is its config's nonzeros over
the rate measured at those nonzeros. The JAX tool's floors count twice as
many nonzeros (``tools/ragged_probe.py:121``): that parity cell is an
expected failure of the reference. The numbers of a CPU run are host-clock
numbers and are checked only for being positive.
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


def test_scalar_deposit_plain_on_one_word():
    """A stream whose 1,048,576 entries all hit one word (``chip_smoke.py``
    phase 10's): that word is the OR of their bits, every other word 0."""
    ents = rp.scalar_entries(1 << 20)
    ents[:, 0], ents[:, 1] = 5, 77
    got = rp.scalar_deposit(torch.from_numpy(ents)).numpy()
    np.testing.assert_array_equal(got, _np_tile(ents))
    assert got[5, 77] == (1 << 31) - 1 and np.count_nonzero(got) == 1


#: the stream's sizes the grid is checked at: the edges and the largest
#: config's nonzeros (K = N = 11008, s = 16)
PLAN_SIZES = [0, 1, 3, 4, 4095, 4096, 4097, 65536, 7_573_504]


@pytest.mark.parametrize("sms", [132, 1, 7])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_deposit_plan_covers_the_stream(n, sms):
    """Block b takes ``[b * per_block, min(n, (b + 1) * per_block))``: the
    blocks cover ``[0, n)`` with no gap and no overlap, in clusters of
    ``DEPOSIT_CLUSTER``, ``per_block`` a multiple of 4, at most one cluster
    more than ``DEPOSIT_BLOCKS_PER_SM`` an SM and no empty cluster."""
    blocks, per_block = rp.deposit_plan(n, sms)
    assert blocks % rp.DEPOSIT_CLUSTER == 0 and blocks > 0
    assert per_block % 4 == 0 and per_block > 0
    starts = [min(n, b * per_block) for b in range(blocks)]
    ends = [min(n, (b + 1) * per_block) for b in range(blocks)]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e == s for e, s in zip(ends, starts[1:]))      # no gap, no overlap
    assert all(s <= e for s, e in zip(starts, ends))
    assert blocks <= max(rp.DEPOSIT_CLUSTER,
                         sms * rp.DEPOSIT_BLOCKS_PER_SM + rp.DEPOSIT_CLUSTER - 1)
    # the last cluster holds at least one entry (or the stream is empty)
    assert n == 0 or starts[blocks - rp.DEPOSIT_CLUSTER] < n


def _kernel_walk(n: int, blocks: int, per_block: int, phase: int):
    """A model of ``csrc/ragged.cu``'s index arithmetic: how many times each
    entry is deposited, and every 16-byte load's offset in bytes from the
    stream's base (the base ``phase`` words past a 16-byte boundary)."""
    seen = np.zeros(n, np.int64)
    loads = []
    for b in range(blocks):
        lo = b * per_block
        hi = max(lo, min(n, lo + per_block))
        head = min(hi, lo + phase)
        groups = (hi - head) >> 2
        tail = head + 4 * groups
        seen[lo:head] += 1                  # one a thread (t < 3)
        seen[tail:hi] += 1                  # one a thread (3 <= t < 6)
        assert head - lo <= 3 and hi - tail <= 3
        seen[head:tail] += 1                # three 16-byte loads a group
        if groups:
            loads.append(4 * phase + 12 * head)
    return seen, loads


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_kernel_walk_deposits_each_entry_once(n, phase):
    """Under the plan, the kernel's head, groups of four and tail deposit
    every entry exactly once, and every group's first load (hence all three)
    sits on a 16-byte boundary, whatever the base's phase."""
    blocks, per_block = rp.deposit_plan(n, 132)
    seen, loads = _kernel_walk(n, blocks, per_block, phase)
    assert (seen == 1).all()
    assert all(off % 16 == 0 for off in loads)


@pytest.mark.parametrize("kn,s", [(kn, s) for kn in (4096, 11008)
                                  for s in (16, 32, 64)])
def test_deposit_plan_fills_the_card_at_the_configs(kn, s):
    """At each config's nonzeros the grid spreads the stream over at least
    the H100's 132 SMs, and a block never gets fewer than
    ``DEPOSIT_MIN_ENTRIES`` unless the card is full."""
    nnz = kn * 2 * ((kn // s) // 2)
    blocks, per_block = rp.deposit_plan(nnz, 132)
    assert blocks >= 132
    assert per_block >= rp.DEPOSIT_MIN_ENTRIES \
        or blocks >= 132 * rp.DEPOSIT_BLOCKS_PER_SM


def test_scalar_deposit_checks_its_input():
    with pytest.raises(ValueError, match=r"\(n, 3\) int32"):
        rp.scalar_deposit(torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(n, 3\) int32"):
        rp.scalar_deposit(torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rp.scalar_deposit(torch.zeros((4, 3), dtype=torch.int32,
                                      device="meta"))
    # the kernel's C entry takes the count as an int
    with pytest.raises(ValueError, match=r"fewer than 2\*\*31 entries"):
        rp.scalar_deposit_launch(torch.empty((2 ** 31, 3), dtype=torch.int32,
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
    assert set(record["ragged_floor_analysis"]) == {"note", "floors_seconds",
                                                    "entries_per_s"}


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
    """Each floor is its config's nonzeros over the rate measured at those
    nonzeros, which stands beside it (not the 4096-entry rate)."""
    nnz = int(np.count_nonzero(tf.generate_ternary(256, 256, s, seed=0)))
    assert nnz == 256 * 2 * ((256 // s) // 2)          # ~ K * N / s
    analysis = record["ragged_floor_analysis"]
    rate = analysis["entries_per_s"][f"KN=256,s={s}"]
    assert rate > 0
    got = analysis["floors_seconds"][f"KN=256,s={s}"]
    assert got == pytest.approx(nnz / rate, rel=1e-12)


def test_floors_are_each_configs_deposit():
    """``ragged_floor_analysis`` takes each config's own measured deposit:
    the floor is that deposit's seconds, the rate its entries a second."""
    nnz = {(64, 16): 256, (64, 32): 128, (64, 8): None}
    rates = {k: rp.scalar_deposit_rate(n, device="cpu")
             for k, n in nnz.items() if n is not None}
    for k, r in rates.items():
        assert r["entries"] == nnz[k]
    got = rp.ragged_floor_analysis(nnz, rates)
    for (kn, s), n in nnz.items():
        key = f"KN={kn},s={s}"
        if n is None:
            assert got["floors_seconds"][key] is None
            assert got["entries_per_s"][key] is None
            continue
        assert got["entries_per_s"][key] == rates[(kn, s)]["entries_per_s"]
        assert got["floors_seconds"][key] == pytest.approx(
            rates[(kn, s)]["seconds"], rel=1e-12)


@pytest.mark.xfail(strict=True, reason=(
    "reference fault, tools/ragged_probe.py:121: the JAX floors take "
    "2*kn*kn//s nonzeros, twice what generate_ternary places (density 1/s, "
    "formats/generate.py:87-91); the port counts the container's "
    "(ROADMAP queue C)"))
@pytest.mark.parametrize("s", [16, 32])
def test_floors_parity_with_the_jax_formula(record, s):
    """The JAX formula at each config's own rate."""
    rate = record["ragged_floor_analysis"]["entries_per_s"][f"KN=256,s={s}"]
    jax_floor = (2 * 256 * 256 // s) / rate
    got = record["ragged_floor_analysis"]["floors_seconds"][f"KN=256,s={s}"]
    assert got == pytest.approx(jax_floor, rel=1e-6)


def test_ragged_probe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.scalar_deposit_rate()
