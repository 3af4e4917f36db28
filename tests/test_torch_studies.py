"""The port's study tools against the JAX package's (``tools/
chain_bench.py``, ``trace_validation.py``, ``kernel_v4b_study.py``,
``compiler_sweep.py``, ``format_diagram.py``), on the CPU:
``tools.chain_bench``'s slope fit against ``np.linalg.lstsq`` as the JAX
tool fits it, its chained and independent stacks against sequential JAX
``ternary_spgemm`` calls with the same clip, and its record; the trace
parser of ``tools.trace_validation`` on a synthetic Chrome trace (device
records split from host ones, as ``tests/test_bench.py``'s parser test
splits a perfetto trace) and its verdicts; ``TiledBitplane`` at ``tkb`` 64
and 32 byte for byte the JAX packer's, the i8 kernel's plain version
bitwise across ``tkb`` and against JAX's Pallas kernel, and
``tools.kernel_v4b_study`` at a tiny size; ``tools.compiler_sweep``'s child
commands and one library path a set; ``tools.format_diagram``'s four
figures."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu.formats import TiledBitplane as JaxTiledBitplane
from ternary_spgemm_tpu.ops import ternary_spgemm as jax_spgemm
from ternary_spgemm_tpu_torch.formats import (
    TiledBitplane,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu_torch.ops import all_kernels
from ternary_spgemm_tpu_torch.tools import (
    chain_bench,
    compiler_sweep,
    format_diagram,
    kernel_v4b_study,
    trace_validation,
)

SMALL = (8, 256, 512, 4)
I8 = "CudaTiledBitplane_i8"


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_chain_fit_against_lstsq():
    rows = [{"L": L, "seconds": 3e-6 + 2.5e-6 * L + 1e-7 * np.sin(L)}
            for L in chain_bench.DEPTHS]
    got = chain_bench.fit(rows)
    # tools/chain_bench.py:128-134
    Ls = np.array([r["L"] for r in rows], np.float64)
    ts = np.array([r["seconds"] for r in rows], np.float64)
    A = np.stack([Ls, np.ones_like(Ls)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, ts, rcond=None)
    assert got["marginal_seconds_lsq"] == pytest.approx(slope, rel=1e-12)
    assert got["intercept_seconds"] == pytest.approx(intercept, rel=1e-12)
    pairs = [(rows[i + 1]["seconds"] - rows[i]["seconds"])
             / (rows[i + 1]["L"] - rows[i]["L"]) for i in range(len(rows) - 1)]
    assert got["pair_slopes"] == pairs
    assert got["deep_marginal_seconds"] == pairs[-1]


@pytest.fixture(scope="module")
def stack():
    M, K, N, s = SMALL
    Ws = [generate_ternary(K, N, s, seed=100 + i) for i in range(3)]
    X = generate_x(M, K, seed=1)
    b = generate_bias(N)
    return Ws, X, b


@pytest.mark.parametrize("variant", ["chained", "independent"])
def test_chain_stacks_against_jax(stack, variant):
    from ternary_spgemm_tpu_torch.bench.stacked import make_chain

    Ws, X, b = stack
    K = SMALL[1]
    spec = all_kernels()[I8]
    fmts = [TiledBitplane.from_dense(W) for W in Ws]
    bs = [torch.from_numpy(b)] * len(Ws)
    maker = (make_chain(spec, fmts, bs, K) if variant == "chained"
             else chain_bench.make_independent(spec, fmts, bs))
    got = maker(torch.from_numpy(X)).numpy()

    jfmts = [JaxTiledBitplane.from_dense(W) for W in Ws]
    call = jax.jit(lambda x, f: jax_spgemm(x, f, b,
                                           kernel="PallasTiledBitplane_i8"))
    cur, acc = jnp.asarray(X), None
    for f in jfmts:   # tools/chain_bench.py:82-99
        y = call(cur if variant == "chained" else jnp.asarray(X), f)
        acc = y if acc is None else acc + y
        cur = jnp.clip(y[:, :K], -512.0, 512.0)
    want = np.asarray(y if variant == "chained" else acc)
    np.testing.assert_array_equal(got, want)


def test_chain_bench_main_on_the_cpu(tmp_path, monkeypatch):
    for k, v in zip("MKN", SMALL):
        monkeypatch.setattr(chain_bench, k, v)
    out = tmp_path / "chain.json"
    rc, text = _run(chain_bench.main, ["--device", "cpu", "--depths", "1",
                                       "2", "3", "--repeats", "1",
                                       "--output", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["depths"] == [1, 2, 3] and rec["timer"] == "time_wall"
    assert rec["card"] is None and rec["bound_by"] == "bytes"
    for v in rec["variants"].values():
        assert [r["L"] for r in v["rows"]] == [1, 2, 3]
        assert len(v["pair_slopes"]) == 2
        assert "bound_fraction_lsq" not in v   # no device time on the CPU
    assert json.loads(text.splitlines()[-1])["chain_bench"].keys() == {
        "independent", "chained"}


#: a synthetic Chrome trace as ``profiling.trace`` writes one: the card's
#: kernel, memcpy and memset records and the host's ops, runtime calls and
#: annotations
TRACE = [
    {"ph": "X", "cat": "kernel", "name": "gemv_kernel<4>", "ts": 10,
     "dur": 9.5},
    {"ph": "X", "cat": "kernel", "name": "gemv_kernel<4>", "ts": 30,
     "dur": 9.7},
    {"ph": "X", "cat": "kernel", "name": "clamp", "ts": 41, "dur": 1.5},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 5,
     "dur": 0.5},
    {"ph": "X", "cat": "cpu_op", "name": "aten::clamp", "ts": 1, "dur": 20},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2,
     "dur": 3.0},
    {"ph": "X", "cat": "user_annotation", "name": "region", "ts": 0,
     "dur": 50},
    {"ph": "i", "cat": "cpu_op", "name": "marker", "ts": 3},
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "x"}},
]


def test_trace_parser_splits_device_from_host():
    parsed = trace_validation.parse_trace(TRACE)
    assert parsed["device"] == {"gemv_kernel<4>": [9.5, 9.7],
                                "clamp": [1.5], "Memset (Device)": [0.5]}
    assert parsed["host"] == {"aten::clamp": [20.0],
                              "cudaLaunchKernel": [3.0], "region": [50.0]}
    row = trace_validation.summarize(parsed, runs=2)
    assert row["device_us"] == pytest.approx((9.5 + 9.7 + 1.5 + 0.5) / 2)
    assert row["n_events"] == 4
    assert list(row["ops_us"]) == ["gemv_kernel<4>", "clamp",
                                   "Memset (Device)"]
    assert row["ops_us"]["gemv_kernel<4>"] == {"median_us": 9.6, "count": 2}
    host_only = trace_validation.summarize(
        trace_validation.parse_trace(TRACE[4:]), runs=2)
    assert host_only["device_us"] is None


def test_trace_verdicts():
    rows = {"bare_add": {"device_us": 1.5, "event_us": 4.0, "floor_us": 2.5},
            "flagship": {"device_us": 9.0, "event_us": 11.0, "floor_us": 2.0},
            "chain8": {"device_us": 100.0, "graph_us": 120.0},
            "chain16": {"device_us": 196.0, "graph_us": 232.0}}
    v = trace_validation.verdicts(rows)
    assert v["flagship_kernel_us"] == 9.0
    assert v["flagship_floor_share"] == pytest.approx(2.0 / 11.0)
    assert v["trace_stacked_marginal_us"] == 12.0
    assert v["graph_stacked_marginal_us"] == 14.0
    assert v["marginal_gap_us"] == 2.0
    assert "flagship_qkv_floor_us" not in v
    assert trace_validation.verdicts({}) == {}


@pytest.mark.parametrize("tkb", [64, 32])
def test_bitplane_tkb_bytes_and_outputs(tkb):
    M, K, N, s = 8, 1024, 256, 4      # 2 and 4 K-blocks
    W = generate_ternary(K, N, s, seed=0)
    mine = TiledBitplane.from_dense(W, tkb=tkb)
    theirs = JaxTiledBitplane.from_dense(W, tkb=tkb)
    assert mine.tkb == tkb and mine.plane.shape[0] == K // (8 * tkb)
    np.testing.assert_array_equal(mine.plane.numpy(), np.asarray(theirs.plane))
    np.testing.assert_array_equal(mine.wsum.numpy(), np.asarray(theirs.wsum))
    X, b = generate_x(M, K, seed=1), generate_bias(N)
    spec = all_kernels()[I8]
    default = spec.fn(torch.from_numpy(X), TiledBitplane.from_dense(W),
                      torch.from_numpy(b)).numpy()
    got = spec.fn(torch.from_numpy(X), mine, torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, default)
    want = jax.jit(lambda x, f: jax_spgemm(
        x, f, b, kernel="PallasTiledBitplane_i8"))(X, theirs)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_kernel_v4b_study_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_v4b_study, "NIBBLE_SHAPES",
                        [(4, 512, 256, 4), (40, 256, 512, 4)])
    monkeypatch.setattr(kernel_v4b_study, "NS", (8, 1024, 256, 4))
    out = tmp_path / "v4b.json"
    rc, text = _run(kernel_v4b_study.main, ["--device", "cpu", "--repeats",
                                            "1", "--output", str(out)])
    assert rc == 0, text
    rec = json.loads(out.read_text())
    assert rec["nib/4x512x256/nibpair4"]["ok"] is True
    assert rec["nib/40x256x512/nibpair4"]["ok"] is True
    assert [rec[f"tkb/{t}"].get("ok") for t in (128, 64, 32)] == [
        None, True, True]
    assert json.loads(text.splitlines()[-1])["kernel_v4b_study"][
        "bitwise"] is True


def test_compiler_sweep_commands_and_libraries():
    from ternary_spgemm_tpu_torch.ops import _build

    flags = list(_build.NVCC_FLAGS)
    paths = {n: compiler_sweep.library_path(n)
             for n in compiler_sweep.OPTION_SETS}
    assert _build.NVCC_FLAGS == flags      # restored after each set
    assert paths["baseline"] == _build.library_path()
    assert len(set(paths.values())) == len(paths)
    assert all(os.path.dirname(p) == _build.BUILD_DIR for p in paths.values())
    cmd = compiler_sweep.child_command("fast_math", "/tmp/x", "cuda")
    assert cmd[1:] == ["-m", "ternary_spgemm_tpu_torch.tools.compiler_sweep",
                       "--child", "fast_math", "--child-dir", "/tmp/x",
                       "--device", "cuda"]
    assert compiler_sweep.OPTION_SETS["maxrregcount_128"] == [
        "-maxrregcount=128"]
    with compiler_sweep.extra_flags(["--use_fast_math"]):
        assert _build.NVCC_FLAGS == flags + ["--use_fast_math"]
    assert _build.NVCC_FLAGS == flags
    with pytest.raises(ValueError, match="start with baseline"):
        compiler_sweep.main(["--sets", "fast_math", "--device", "cpu"])


def test_compiler_sweep_compare():
    base = {"CudaDense": np.zeros(4), "swiglu/4": np.zeros(4)}
    got = {"CudaDense": np.array([0, 1.0, 0, 0]),
           "swiglu/4": np.array([0, 0, 2.0, 3.0])}
    assert compiler_sweep.compare(base, got) == {
        "spmm_flips": {"CudaDense": 1}, "ffn_flips": {"swiglu/4": 2}}


def test_format_diagram_figures(tmp_path):
    """The four figures of ``tests/test_aux.py``'s check, drawn from the
    port's packers."""
    rc, _ = _run(format_diagram.main, ["--outdir", str(tmp_path),
                                       "--device", "cpu"])
    assert rc == 0
    made = sorted(os.listdir(tmp_path))
    assert made == ["bitplane_structure.png", "blocked_tcsc_structure.png",
                    "ell_deposit_structure.png", "tcsc_structure.png"]
    assert all((tmp_path / f).stat().st_size > 10_000 for f in made)
