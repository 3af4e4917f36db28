"""CPU tests of the benchmark at a tiny size: the reference against the
port's CPU path, the check's control and faults, the trace and bound
arithmetic, the harness's discovery of new files, and its imports. The
card's test is marked ``cuda`` and skips without one.

    python -m pytest benchmark/test_benchmark_cpu.py -q
"""

from __future__ import annotations

import ast
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import bitnet, bounds, compare, inputs, reference, serve, trace
from benchmark.stats import percentile

ROOT = serve.ROOT
HERE = serve.HERE
SEED = 2**31 + 12345
TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_key_value_heads=4, num_hidden_layers=2, vocab_size=64)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with a tiny configuration and a cell of it
    under each traffic mix (``tiny.chat``, ``tiny.longprompt``), the limit
    the 7B chat cell holds."""
    root = str(tmp_path / "checkout")
    shutil.copytree(HERE, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = os.path.join(root, "benchmark")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(HERE, "configs", "bitnet3b.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", **TINY)
    with open(os.path.join(here, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    with open(os.path.join(HERE, "limits", "bitnet7b.chat.json")) as f:
        limits = json.load(f)
    for mix in ("chat", "longprompt"):
        with open(os.path.join(HERE, "traffic", mix + ".json")) as f:
            traffic = json.load(f)
        traffic.update(batch=4, prompt_len=8, new_tokens=6, check_batches=2,
                       trace={"batch": 1, "call": 0, "calls": 6})
        if mix == "chat":
            traffic["greedy_rows"] = 2
        with open(os.path.join(here, "traffic", "tiny" + mix + ".json"),
                  "w") as f:
            json.dump(traffic, f)
        name = "tiny." + mix
        with open(os.path.join(here, "limits", name + ".json"), "w") as f:
            json.dump(limits, f)
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": "tiny" + mix, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith("." + mix)
                                        for w in m["workloads"]):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def _run(root, workload, seconds=0.3, traced=False, control=None,
         lower=(), seed=SEED):
    cell = serve.Cell(workload, root=root)
    return serve.run(cell, seed, seconds, traced, "cpu",
                     time.perf_counter(), control=control, lower=lower)


def test_reference_matches_port_prefill():
    """The reference's logits at every prompt position against the port's
    CPU prefill into an int8 cache (the same bits: the same operations in
    the same order)."""
    from ternary_spgemm_tpu_torch.models.generate import init_cache

    model = inputs.sizes(TINY)
    lm = bitnet.build_lm(model, SEED, torch.device("cpu"))
    tokens = torch.randint(0, model["vocab"], (3, 11),
                           generator=torch.Generator().manual_seed(1))
    caches = init_cache(lm.cfg, 3, 11, torch.int8, device="cpu")
    with torch.no_grad():
        got, _ = lm.prefill(tokens, caches)
    want = reference.logits(model, SEED, tokens, 0, "cpu")
    assert want.shape == got.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mix", ["chat", "longprompt"])
def test_cell_correct(tiny_root, mix):
    """A whole run of a tiny cell: the served logits against the
    reference, every metric of the cell reported."""
    out = _run(tiny_root, "tiny." + mix)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] <= 1e-6
    assert out["failed"] == 0 and out["attempted"] > 0
    names = {m["name"] for m in serve.Cell("tiny." + mix,
                                           root=tiny_root).end_to_end}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"


def test_traced_run_reads_per_layer(tiny_root):
    out = _run(tiny_root, "tiny.chat", seconds=1.0, traced=True)
    assert out["correct"]
    # no device on the CPU: the readers that need device time read none
    assert {"idle_share.decode", "mfu.decode"} <= set(out["metrics"])
    assert "kernel_roofline.decode" not in out["metrics"]
    assert out["device"]["window_s"] > 0


def test_control_fails(tiny_root):
    """The controls come out as not correct: the program's own bf16 head in
    place of the f32 one the configuration states, and the reference with
    its head's operands in bf16 put in the program's place. (TF32 and the
    f32 attention are read on the card: the CPU has no TF32, and two tiny
    layers do not carry a rounding far.)"""
    for mix in ("chat", "longprompt"):
        out = _run(tiny_root, "tiny." + mix, control="bf16_head")
        assert not out["correct"], out["checks"]
        out = _run(tiny_root, "tiny." + mix, lower=reference.LOWER)
        assert out["correct"], out["checks"]
        limit = out["checks"]["logit_gap"]["limit"]
        assert set(out["controls"]) == {"control." + v
                                        for v in reference.LOWER}
        assert out["controls"]["control.head_bf16"] > limit, out["controls"]


def _state_unchanged(monkeypatch):
    """A decode step that leaves the caches as they were."""
    generate = importlib.import_module(
        "ternary_spgemm_tpu_torch.models.generate")
    put = generate._cache_put
    monkeypatch.setattr(
        generate, "_cache_put",
        lambda cache, k, v, pos: cache if k.shape[2] == 1
        else put(cache, k, v, pos))


def _half_batch(monkeypatch):
    """A decode step that computes the first half of the batch and gives
    its rows to the other half."""
    from ternary_spgemm_tpu_torch.models.generate import ExportedTransformerLM

    step = ExportedTransformerLM.decode_step

    def half(self, tokens, caches, pos):
        logits, caches = step(self, tokens, caches, pos)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:h]]), caches

    monkeypatch.setattr(ExportedTransformerLM, "decode_step", half)


def _token_altered(monkeypatch):
    """Each sampled token altered where the sampler produces it."""
    graphs = importlib.import_module("ternary_spgemm_tpu_torch.models.graphs")
    sample = graphs.sample
    monkeypatch.setattr(
        graphs, "sample",
        lambda logits, *a: (sample(logits, *a) + 1) % logits.shape[-1])


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
@pytest.mark.parametrize("mix", ["chat", "longprompt"])
def test_fault_fails(tiny_root, monkeypatch, fault, mix):
    """A broken timed path under a whole run gives ``correct`` false. (The
    cells run on one card: no exchange between cards to leave out.)"""
    fault(monkeypatch)
    out = _run(tiny_root, "tiny." + mix)
    assert not out["correct"], out["checks"]


def _sampler_fault(monkeypatch, change):
    graphs = importlib.import_module("ternary_spgemm_tpu_torch.models.graphs")
    sample = graphs.sample

    def broken(logits, gumbel, temperature, top_k=0, top_p=1.0):
        return sample(logits, *change(gumbel, temperature, top_k, top_p))

    monkeypatch.setattr(graphs, "sample", broken)


def _top_p_dropped(monkeypatch):
    _sampler_fault(monkeypatch, lambda g, t, k, p: (g, t, k, 1.0))


def _temperature_ignored(monkeypatch):
    _sampler_fault(monkeypatch, lambda g, t, k, p: (g, 1.0, k, p))


def _noise_reversed(monkeypatch):
    """The Gumbel noise of each row read in the reverse order."""
    _sampler_fault(monkeypatch,
                   lambda g, t, k, p: (torch.flip(g, dims=[-1]), t, k, p))


@pytest.mark.parametrize("fault", [_top_p_dropped, _temperature_ignored,
                                   _noise_reversed])
def test_sampler_fault_fails(tiny_root, monkeypatch, fault):
    """A timed sampler that drops the nucleus, ignores the temperature or
    draws other noise gives ``correct`` false in a sampled cell."""
    fault(monkeypatch)
    out = _run(tiny_root, "tiny.chat")
    assert not out["correct"], out["checks"]


def test_logit_gap():
    ref = torch.randn(2, 3, 10, generator=torch.Generator().manual_seed(0))
    served = torch.argmax(ref, dim=-1)
    assert compare.logit_gap(ref.clone(), ref, served) == 0.0
    prog = ref.clone()
    prog[1, 2, 4] += 0.5
    rms = float(torch.sqrt(torch.mean(ref[1, 2].double() ** 2)))
    assert compare.logit_gap(prog, ref, served) == pytest.approx(
        0.5 / rms, rel=1e-6)
    # a greedy request served another token than the best
    other = served.clone()
    other[0, 0] = torch.argmin(ref[0, 0])
    gap = compare.logit_gap(ref.clone(), ref, other)
    row = ref[0, 0].double()
    assert gap == pytest.approx(float((row.max() - row.min())
                                      / torch.sqrt(torch.mean(row ** 2))))
    bad = prog.clone()
    bad[0, 0, 0] = float("nan")
    ok, checks = compare.judge(
        {"logit_gap": compare.logit_gap(bad, ref, served)},
        {"logit_gap": 1.0})
    assert not ok and checks["logit_gap"]["limit"] == 1.0


def test_logit_gap_sampled():
    """A sampled token is held to the reference's nucleus and to its
    Gumbel-max draw from the same uniform draws."""
    g = torch.Generator().manual_seed(1)
    ref = 3.0 * torch.randn(2, 4, 50, generator=g)
    u = torch.rand(2, 4, 50, generator=g)
    sampler = (0.7, 0, 0.9)
    chosen = torch.stack([compare.choose(ref[r], sampler, u[r])
                          for r in range(2)])
    assert compare.logit_gap(ref.clone(), ref, chosen, sampler, u) == 0.0
    scaled = reference.tdiv(ref[0, 0], 0.7)
    outer = reference.cutoff(scaled, 0, 0.9 + compare.EDGE)
    inner = reference.cutoff(scaled, 0, 0.9 - compare.EDGE)
    rms = float(torch.sqrt(torch.mean(ref[0, 0].double() ** 2)))
    # a token outside the nucleus reads how far below its least it lies
    out = int(torch.argmin(ref[0, 0]))
    served = chosen.clone()
    served[0, 0] = out
    gap = compare.logit_gap(ref.clone(), ref, served, sampler, u)
    assert gap >= float(outer[0] - scaled[out]) * 0.7 / rms * (1 - 1e-6)
    # a kept token that the draw did not choose reads its shortfall
    score = scaled + reference.gumbel(u[0, 0])
    core = [t for t in range(50) if scaled[t] >= inner[0]]
    kept = [t for t in core if t != int(chosen[0, 0])][0]
    served[0, 0] = kept
    short = float(max(score[t] for t in core) - score[kept]) * 0.7 / rms
    assert compare.logit_gap(ref.clone(), ref, served, sampler, u) == \
        pytest.approx(short, rel=1e-5)
    # greedy rows (draws held at 0.5) are held to the argmax
    half = torch.full_like(u, 0.5)
    best = torch.argmax(ref, dim=-1)
    assert compare.logit_gap(ref.clone(), ref, best, sampler, half) == 0.0


def test_logit_gap_nucleus_edge(monkeypatch):
    """A token at the nucleus' edge, kept by the reference and dropped by a
    program whose logits differ by rounding, moves the draw where its noise
    is the largest: that reads as the logits' difference, not as the
    draw's."""
    sampler = (1.0, 0, 0.8)
    ref = torch.log(torch.tensor([[0.5, 0.3 - 1e-5, 0.15, 0.05 + 1e-5]]))
    prog = torch.log(torch.tensor([[0.5, 0.3 + 1e-5, 0.15, 0.05 - 1e-5]]))
    u = torch.tensor([[0.1, 0.1, 0.99, 0.1]])
    assert int(compare.choose(ref, sampler, u)[0]) == 2
    served = compare.choose(prog, sampler, u)
    assert int(served[0]) == 0
    gap = compare.logit_gap(prog[None], ref[None], served[None], sampler,
                            u[None])
    assert gap < 1e-3
    # held to the nucleus' exact edge, the same token reads the draw's jump
    monkeypatch.setattr(compare, "EDGE", 0.0)
    assert compare.logit_gap(prog[None], ref[None], served[None], sampler,
                             u[None]) > 1.0


def test_percentiles_over_all_requests_and_gaps():
    """The tails take every request and every gap of the window, each
    request counted, and not a percentile of each batch's."""
    batches = [
        {"issue": 0.0, "times": [1.0, 1.1, 1.2], "failed": 0},
        {"issue": 1.2, "times": [1.5, 2.5, 3.5], "failed": 0},
        # its last token comes after the close: not counted
        {"issue": 3.5, "times": [3.6, 3.7, 9.0], "failed": 1},
        {"issue": 9.5, "times": [9.6], "failed": 0},       # after the close
    ]
    run = serve.Run(5.0, batches, start=0.0, close=4.0, batch=2,
                    prompt_len=10)
    assert run.window_s == 4.0
    assert run.tokens == 2 * (3 + 3 + 2)
    assert run.prompt_tokens == 2 * 3 * 10
    assert run.attempted == 6 and run.failed == 1
    gaps = [0.1, 0.1, 1.0, 1.0, 0.1]
    assert sorted(run.gaps_s) == pytest.approx(sorted(gaps * 2))
    assert percentile(run.gaps_s, 95) == pytest.approx(
        percentile([g for g in gaps for _ in range(2)], 95))
    assert sorted(run.ttfts_s) == pytest.approx([0.1, 0.1, 0.3, 0.3, 1.0,
                                                 1.0])
    assert percentile([1.0], 95) is None


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_calls_and_breakdown():
    """Segments from the harness's spans; busy time as the union; the
    port's kernels by their namespace; idle time by the host's span."""
    events = [
        _ev("load", "user_annotation", 0, 10),
        _ev("prefill", "user_annotation", 10, 5),
        _ev("readback", "user_annotation", 15, 85),
        _ev("step", "user_annotation", 100, 5),
        _ev("readback", "user_annotation", 105, 45),
        _ev("void ternary::gemv<8>(...)", "kernel", 12, 30),
        _ev("aten::add", "kernel", 40, 20),               # overlaps
        _ev("Memcpy DtoH", "gpu_memcpy", 90, 5),
        _ev("void ternary::gemv<8>(...)", "kernel", 110, 20),
        _ev("aten::mm", "kernel", 130, 10),
        _ev("ignored", "cpu_op", 0, 150),
    ]
    assert trace.segments(events) == [("prefill", 0, 100), ("step", 100, 150)]
    calls = trace.calls(events)
    assert [c["kind"] for c in calls] == ["prefill", "step"]
    assert calls[0]["span_s"] == pytest.approx(100e-6)
    assert calls[0]["busy_s"] == pytest.approx(53e-6)     # 12-60, 90-95
    assert calls[0]["ternary_s"] == pytest.approx(30e-6)
    assert calls[0]["glue_s"] == pytest.approx(25e-6)
    assert calls[1]["busy_s"] == pytest.approx(30e-6)
    assert trace.device(events) == pytest.approx(
        {"busy_s": 83e-6, "window_s": 150e-6})
    assert trace.busy_union([(0, 2), (1, 3), (5, 6)]) == 4
    b = trace.breakdown(events)
    assert b["device_ops"][0] == ["void ternary::gemv<8>(...)",
                                  pytest.approx(50e-6)]
    idle = dict(b["idle_gaps"])
    # each gap by the innermost span the host was in as it began
    assert idle == pytest.approx({"load": 12e-6, "readback": 55e-6})


def test_bounds():
    assert bounds.ternary_bits(0.5) == pytest.approx(1.5)
    assert bounds.ternary_bits(1.0) == pytest.approx(1.0)
    with open(os.path.join(HERE, "configs", "bitnet7b.json")) as f:
        m7 = inputs.sizes(json.load(f))
    # 7B: 202.4M ternary weights a layer, 32 layers, at 1.5 bits
    w = bitnet._layer_weights(m7).bytes * m7["layers"]
    assert w == pytest.approx(202_375_168 * 32 * 1.5 / 8)
    step = bitnet.decode_work(m7, 16, 257)
    kv = 32 * 16 * 257 * 32 * 2 * (128 + 4)
    assert step.bytes == pytest.approx(w + 32000 * 4096 * 4 + 16 * 32000 * 4
                                       + kv + 16 * 8)
    assert step.seconds() == step.bytes / bounds.PEAK_BYTES
    pre = bitnet.prefill_work(m7, 4, 1024)
    assert pre.seconds() == pre.ops / bounds.PEAK_OPS
    # the head at the last position only; attention over the causal half
    assert pre.ops == pytest.approx(
        2 * 4 * 1024 * 202_375_168 * 0.5 * 32 + 2 * 4 * 4096 * 32000
        + 4 * 4 * (1024 * 1025 // 2) * 32 * 128 * 32)


def test_no_container_beats_the_weight_bound():
    """Every one of the port's 18 containers holds, and every kernel over
    it reads (``bench/instrument.py``'s ``weight_bytes``), at least the
    entropy bytes the bound counts: a kernel's share of its bound cannot
    pass 100% through the container's bytes."""
    from ternary_spgemm_tpu_torch.bench.instrument import weight_bytes
    from ternary_spgemm_tpu_torch.formats import all_formats

    K, N = 512, 384
    W = inputs.ternary(torch.rand(K, N, generator=torch.Generator()
                                  .manual_seed(3)))
    need = bounds.weights(K, N, inputs.DENSITY).bytes
    formats = all_formats()
    assert len(formats) == 18
    for name, cls in formats.items():
        fmt = cls.from_dense(W)
        held = sum(t.numel() * t.element_size()
                   for t in fmt.arrays().values() if t is not None)
        assert held >= need, name
        assert weight_bytes(fmt) >= need, name


def test_new_files_found_without_an_edit(tiny_root):
    """A configuration, a traffic mix and a metric added as files (and as
    entries of BENCHMARK.json) run with no harness file edited."""
    here = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(here, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny2", num_attention_heads=2, num_key_value_heads=2,
               num_hidden_layers=1)
    with open(os.path.join(here, "configs", "tiny2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "traffic", "tinychat.json")) as f:
        traffic = json.load(f)
    traffic.update(batch=2, prompt_len=5, new_tokens=3)
    with open(os.path.join(here, "traffic", "burst.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(here, "metrics", "requests_per_s.py"), "w") as f:
        f.write("def read(run):\n    return run.attempted / run.window_s\n")
    shutil.copy(os.path.join(here, "limits", "tiny.chat.json"),
                os.path.join(here, "limits", "tiny2.burst.json"))
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny2", "source": "test",
                             "file": "benchmark/configs/tiny2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny2.burst", "config": "tiny2",
                               "traffic": "burst", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "requests_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny2.burst"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = serve.Cell("tiny2.burst", root=tiny_root)
    assert cell.model["heads"] == 2 and cell.traffic["batch"] == 2
    out = _run(tiny_root, "tiny2.burst")
    assert out["correct"]
    assert {"requests_per_s", "setup_s"} <= set(out["metrics"])
    assert "itl_p95_ms" not in out["metrics"]


FORBIDDEN = {"jax", "jaxlib", "flax", "ternary_spgemm_tpu", "tools"}


def _imports(path: str) -> set:
    """Top-level names of the modules a file imports (whole names)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_imports():
    """Nothing of the benchmark imports JAX, the JAX package or the
    repository's root ``tools`` package: top-level names compared whole
    (``ternary_spgemm_tpu_torch`` is the port)."""
    seen = set()
    for path in _sources():
        names = _imports(path)
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        seen |= names
    assert "ternary_spgemm_tpu_torch" in seen
    assert FORBIDDEN & {"ternary_spgemm_tpu_torch"} == set()


def test_reference_imports_nothing_of_the_port():
    """The reference, and the inputs it draws, import torch and the
    standard library alone; loaded in a process of their own, they bring
    no module of the port with them."""
    for f in ("reference.py", "inputs.py"):
        names = _imports(os.path.join(HERE, f))
        assert names <= {"__future__", "torch", "hashlib", "benchmark"}, names
    code = ("import sys; import benchmark.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ternary_spgemm_tpu_torch', 'jax', 'ternary_spgemm_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _bench_cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bitnet7b.chat",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_cli_refuses_without_a_card_or_the_program(tmp_path):
    """No result and a nonzero exit without a card (this machine) and in a
    directory that holds only BENCHMARK.json and the benchmark."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card test covers the command")
    out = _bench_cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    bare = tmp_path / "bare"
    shutil.copytree(HERE, bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    out = _bench_cli(str(bare))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of the 3B long-prompt cell on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bitnet3b.longprompt", "--seed", str(SEED), "--seconds", "5",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert "kernel_roofline.prefill" in line["metrics"]
