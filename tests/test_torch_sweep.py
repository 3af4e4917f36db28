"""The port's sweep tools against the JAX package's (``tools/sweep.py``,
``sweep_sanitize.py``, ``grid_summary.py``): the grids as lists in all four
modes, the gather skips under the JAX budget config for config, the
sanitize scan and the grid summary on the same records, and a CLI record
at one config with the JAX CLI's test case and per-kernel keys; then the
port's own artifact through ``--resume``, ``sweep_remeasure`` and the three
plots (PNG files; matplotlib's ``Agg`` backend)."""

import argparse
import contextlib
import io
import json
import os

import pytest

from tools import grid_summary as jsummary
from tools import sweep as jsweep
from tools import sweep_sanitize as jsanitize
from ternary_spgemm_tpu_torch.ops import REFERENCE_KERNELS
from ternary_spgemm_tpu_torch.tools import (
    grid_summary,
    plot_perf,
    plot_roofline,
    plot_speedup,
    sweep,
    sweep_remeasure,
    sweep_sanitize,
)


def _args(**kw):
    defaults = dict(preset=None, varyonly=None, sparsityonly=False,
                    m_values=None, kn=None, s_values=None)
    defaults.update(kw)
    return argparse.Namespace(**defaults)


GRIDS = {
    "canonical": {},
    "canonical_cut": dict(m_values=[1, 32], kn=[(1024, 4096)],
                          s_values=[4, 8]),
    "vary_M": dict(varyonly="M"),
    "vary_K": dict(varyonly="K", s_values=[4]),
    "vary_N": dict(varyonly="N", s_values=[2, 16]),
    "sparsity": dict(sparsityonly=True),
    "sparsity_cut": dict(sparsityonly=True, s_values=[3]),
    "bitnet": dict(preset="bitnet"),
    "bitnet_cut": dict(preset="bitnet", m_values=[4], s_values=[2]),
}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) in (0, None)
    return buf.getvalue()


@pytest.mark.parametrize("mode", sorted(GRIDS))
def test_build_grid_is_the_jax_grid(mode):
    args = _args(**GRIDS[mode])
    assert list(sweep.build_grid(args)) == list(jsweep.build_grid(args))


def test_gather_skips_are_the_jax_skips():
    """Every config of the canonical and bitnet grids, every kernel of the
    JAX registry by its counterpart: the same skip, word for word, under
    the JAX budget."""
    assert sweep.GATHER_BUDGET_FLOATS == jsweep._GATHER_BUDGET_FLOATS
    assert set(sweep.GATHER_KERNELS) == set(jsweep._GATHER_KERNELS)
    import torch
    assert sweep.gather_budget_floats(torch.device("cpu")) == \
        jsweep._GATHER_BUDGET_FLOATS
    grid = (list(jsweep.build_grid(_args()))
            + list(jsweep.build_grid(_args(preset="bitnet"))))
    skipped = 0
    for jname, pname in REFERENCE_KERNELS.items():
        for m, k, n, s in grid:
            want = jsweep.skip_reason(jname, m, k, n, s)
            assert sweep.skip_reason(pname, m, k, n, s) == want
            skipped += want is not None
    assert skipped > 0


def test_card_budget_scales_with_its_memory():
    """An 80 GB card's budget (a quarter, 5e9 floats) runs a config that
    the JAX budget skips, and skips one it cannot hold."""
    assert sweep.skip_reason("BaseTCSR", 64, 4096, 16384, 2) is not None
    assert sweep.skip_reason("BaseTCSR", 64, 4096, 16384, 2,
                             budget_floats=5e9) is None
    assert sweep.skip_reason("BaseTCSR", 256, 4096, 16384, 2,
                             budget_floats=5e9) is not None


def _records():
    def rec(m, res):
        return {"test_case": {"M": m, "K": 512, "N": 2048, "s": 4},
                "results": res}

    t = lambda sec, rf=0.5, **kw: dict(seconds=sec, roofline_fraction=rf,
                                       **kw)
    return [
        rec(1, {"BaseTCSC": t(4e-5), "PallasTiledBitplane_i8": t(1e-5),
                "DenseMXU_bf16": t(5e-6), "PallasTiledBitplane_x8": t(6e-6),
                "PallasDense": t(2e-5, own_roofline_fraction=0.3)}),
        rec(16, {"BaseTCSC": t(6.25e-11)}),                # picoseconds
        rec(64, {"BaseTCSC": t(1e-5, 1.11)}),              # above the roof
        rec(256, {"BaseTCSR": {"error": "skipped: gather too big"},
                  "PallasDense": t(3e-5)}),                # no BaseTCSC
        rec(1000, {"BaseTCSC": t(2e-4), "PallasTiledBitplane_i8": t(2e-5),
                   "PallasDense_bf16": t(1e-5, 0.9)}),
        {"test_case": {"M": 4000, "K": 512, "N": 2048, "s": 4},
         "error": "RuntimeError: config failed"},
    ]


@pytest.mark.parametrize("floor,roof", [(1e-7, 1.05), (1e-4, 0.6)])
def test_sanitize_scan_is_the_jax_scan(floor, roof):
    records = _records()
    kept, scrubbed = sweep_sanitize.scan(records, min_seconds=floor,
                                         max_roofline=roof)
    jkept, jscrubbed = jsanitize.scan(records, min_seconds=floor,
                                      max_roofline=roof)
    assert kept == jkept and scrubbed == jscrubbed and scrubbed


def test_sanitize_cli_is_the_jax_cli(tmp_path):
    for name, main in (("jax", jsanitize.main), ("port", sweep_sanitize.main)):
        (tmp_path / f"{name}.json").write_text(json.dumps(_records()))
    outs = {name: _run(main, [str(tmp_path / f"{name}.json")])
            for name, main in (("jax", jsanitize.main),
                               ("port", sweep_sanitize.main))}
    assert outs["port"].splitlines()[:-1] == outs["jax"].splitlines()[:-1]
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())


def _port_names(records):
    return [{**r, "results": {REFERENCE_KERNELS.get(k, k): v
                              for k, v in r.get("results", {}).items()}}
            if "results" in r else r for r in records]


def test_grid_summary_is_the_jax_summary(tmp_path):
    """The JAX tool's JSON for the same records; the port's records (its
    kernel names) give the same figures under those names."""
    path = tmp_path / "records.json"
    path.write_text(json.dumps(_records()))
    want = json.loads(_run(jsummary.main, [str(path)]))
    assert json.loads(_run(grid_summary.main, [str(path)])) == want
    ported = grid_summary.summarize(_port_names(_records()))
    rename = lambda d: {REFERENCE_KERNELS.get(k, k): v for k, v in d.items()}
    assert ported["flagship_speedup_vs_basetcsc"] == \
        want["flagship_speedup_vs_basetcsc"]
    assert ported["exact_winner_counts"] == rename(want["exact_winner_counts"])
    assert ported["overall_winner_counts"] == \
        rename(want["overall_winner_counts"])


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The port's CLI and the JAX CLI at one config (M=4, 32x64, s=4)."""
    d = tmp_path_factory.mktemp("sweep")
    kernels = "DenseMXU,BaseTCSC,PallasTiledBitplane_i8,PallasDense"
    common = ["--m-values", "4", "--kn", "32x64", "--s-values", "4",
              "--kernels", kernels, "--min-seconds", "0.01", "--correctness"]
    _run(jsweep.main, [*common, "--output", str(d / "jax.json")])
    out = _run(sweep.main, [*common, "--output", str(d / "port.json"),
                            "--device", "cpu"])
    assert "wrote 1 records" in out
    return d


def test_cli_record_matches_the_jax_record(artifact):
    (j,) = json.loads((artifact / "jax.json").read_text())
    (p,) = json.loads((artifact / "port.json").read_text())
    assert p["test_case"] == j["test_case"] == {"M": 4, "K": 32, "N": 64,
                                                "s": 4}
    assert set(p["results"]) == {REFERENCE_KERNELS[k] for k in j["results"]}
    for name, r in j["results"].items():
        mine = p["results"][REFERENCE_KERNELS[name]]
        assert set(mine) == set(r), name
        assert mine["correct"] is True
        assert mine["total_input_size"] == r["total_input_size"], name
    assert not os.path.exists(str(artifact / "port.json") + ".tmp")


def test_resume_skips_recorded_configs(artifact, tmp_path):
    path = tmp_path / "s.json"
    path.write_text((artifact / "port.json").read_text())
    out = _run(sweep.main, ["--m-values", "4", "8", "--kn", "32x64",
                            "--s-values", "4", "--kernels", "DenseMXU",
                            "--min-seconds", "0.01", "--resume", "--output",
                            str(path), "--device", "cpu"])
    assert "resume: 1 configs" in out and "[1/1] M=8" in out
    recs = json.loads(path.read_text())
    assert [r["test_case"]["M"] for r in recs] == [4, 8]


def test_remeasure_keeps_the_verdict_and_rebases(artifact, tmp_path):
    path = tmp_path / "s.json"
    path.write_text((artifact / "port.json").read_text())
    _run(sweep_remeasure.main, [str(path), "--kernels",
                                "CudaDense,BaseTCSC", "--min-seconds",
                                "0.01", "--device", "cpu"])
    (rec,) = json.loads(path.read_text())
    res = rec["results"]
    assert res["CudaDense"]["correct"] is True
    base = res["BaseTCSC"]["seconds"]
    for entry in res.values():
        assert entry["speedup"] == pytest.approx(base / entry["seconds"])


@pytest.mark.parametrize("tool", [plot_perf, plot_speedup, plot_roofline],
                         ids=["perf", "speedup", "roofline"])
def test_plots_write_pngs(artifact, tmp_path, tool):
    pytest.importorskip("matplotlib")
    png = tmp_path / "plot.png"
    _run(tool.main, [str(artifact / "port.json"), "--output", str(png)])
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_roofline_defaults_are_the_cards():
    assert plot_roofline.BETA_GBPS == 3350.0
    assert plot_roofline.PI_GFLOPS == 1979e3
