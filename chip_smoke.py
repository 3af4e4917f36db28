#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Run from the repository root on a machine with a card::

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails, or if no GPU is visible):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: ``csrc/*.cu`` compiled with nvcc for sm_90a
   (``ternary_spgemm_tpu_torch/ops/_build.py``);
3. every kernel of the path against its plain PyTorch version on the card,
   at the BitNet-7B path shapes (d=4096, ff=11008): the x8 kernel on the
   merged QKV (4096 -> 12288) and wo (4096 -> 4096) at M in {4, 256, 512}
   (decode, and the serve's 4 x 128-token prefill), the i8 kernel at the
   north star 32x1024x4096 and at 32x4096x11008 (gn=3), both bitwise equal
   with PReLU on and off; the SwiGLU kernel at M in {4, 128, 512}
   (at most 1e-4 of the requantized hidden values may flip, each by 1, and
   every row without a flip agrees within rtol=1e-5, atol=0.01). Median
   times from CUDA events, with a 256 MB buffer written between launches
   so that the weights come from device memory as they do in serving;
4. whole-model parity: a small model (2 layers, d=256, 4 heads, ff=512,
   vocab 64) from a numpy-seeded parameter tree in the shape of the JAX
   ``BitTransformerLM.init``, built once, one copy on the CPU (plain
   versions) and one on the card (kernels): identical greedy tokens, prefill
   logits within rtol=atol=1e-4;
5. the serving path, counted: the headline SpMM through ``ternary_spgemm``'s
   default dispatch at the north star, then BitNet-7B width (all 32 layers,
   random ternary weights from a seed, built on the card) serving 4
   requests of 128 prompt tokens each, greedy-decoding 32 new tokens each
   through ``generate`` with an int8 KV cache. The launch counters must
   match the path (x8 twice and the SwiGLU once per layer per forward; i8
   on the headline op) and no plain version may run on a CUDA tensor;
6. the benchmark path's other kernels against their plain versions on the
   card (bf16 bitplane, nibble-pair i8, tiled-dense i8 and x8) at the
   north star 32x1024x4096 (s=4), at the BitNet-7B up-projection
   32x4096x11008 (s=2, three N-tiles), and for bf16 and dense x8 at
   512x4096x4096 (s=2): bitwise equal on integer X in each kernel's domain
   with PReLU on and off; bf16 also on non-integer X (uniform in +-2),
   within rtol=1e-5, atol=1e-3 (f32 summation order);
7. the benchmark entry point, counted: ``python -m ternary_spgemm_tpu_torch
   -M 32 -K 1024 -N 4096 -s 4 -correctness`` with PReLU off and on
   (in-process, ``__main__.main``): every registered kernel correct, no
   ERROR line, each of the six hand-written SpMM kernels launched and no
   plain version on a CUDA tensor; then the headline
   (``python -m ternary_spgemm_tpu_torch.bench.headline``), whose JSON line
   is printed.

The last lines are the headline JSON, the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the CUDA source of each hand-written kernel; the TPU kernel a registered
#: kernel replaces is its registration's ``reference``
SOURCES = {
    "CudaTiledBitplane_x8": "ternary_spgemm_tpu_torch/csrc/bitplane.cu",
    "CudaTiledBitplane_i8": "ternary_spgemm_tpu_torch/csrc/bitplane.cu",
    "fused_bitplane_swiglu": "ternary_spgemm_tpu_torch/csrc/swiglu.cu",
    "CudaTiledBitplane_bf16": "ternary_spgemm_tpu_torch/csrc/bitplane_bf16.cu",
    "CudaTiledNibblePair_i8": "ternary_spgemm_tpu_torch/csrc/nibblepair.cu",
    "CudaTiledDense_i8": "ternary_spgemm_tpu_torch/csrc/tiled_dense.cu",
    "CudaTiledDense_x8": "ternary_spgemm_tpu_torch/csrc/tiled_dense.cu",
}
#: the fused SwiGLU is no registered SpMM kernel: the TPU kernel it replaces
SWIGLU_REPLACES = "ternary_spgemm_tpu/ops/fused_ffn.py:384"
#: phase 6: kernel -> (its plain version in ``ops/cuda_kernels.py``, whether
#: it also runs at the large-M shape the TPU built it for); the wrapper, the
#: container and the |x| domain come from the registry
NEW_KERNELS = {
    "CudaTiledBitplane_bf16": ("bitplane_bf16_plain", True),
    "CudaTiledNibblePair_i8": ("nibblepair_i8_plain", False),
    "CudaTiledDense_i8": ("tiled_dense_i8_plain", False),
    "CudaTiledDense_x8": ("tiled_dense_x8_plain", True),
}


def spmm_kernels() -> list:
    """The registered hand-written SpMM kernels: every one but BaseTCSC."""
    from ternary_spgemm_tpu_torch.ops import BASELINE_KERNEL_NAME, all_kernels

    return [n for n in all_kernels() if n != BASELINE_KERNEL_NAME]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def phase_kernels(dev, card: str) -> dict:
    """Phase 3: each kernel against its plain version at the path shapes."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops.fused_ffn import (
        requantize_rows, swiglu_hidden_plain, swiglu_launch, swiglu_plain,
        true_div)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    stats = {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
             for name in SOURCES if name not in NEW_KERNELS}

    def fmt(K, N, s=2):
        return TiledBitplane.from_dense(random_ternary(K, N, s, gen, dev))

    def spmm_case(name, kern, plain, M, K, N, *, s, x, headline):
        f = fmt(K, N, s)
        b = torch.full((N,), 2.0, device=dev)
        a = torch.full((N,), 0.1, device=dev)
        for alpha in (None, a):
            got = kern(x, f, b, alpha)
            want = plain(x, f, b, alpha)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"{name} {M}x{K}x{N} prelu={alpha is not None}: kernel != "
                  f"plain (max |diff| {float((got - want).abs().max())})")
            err = float((got - want).abs().max())
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        ms = event_ms(lambda: kern(x, f, b, None), flush=flush)
        pms = event_ms(lambda: plain(x, f, b, None), flush=flush)
        print(f"kernel {name} {M}x{K}x{N}: bitwise equal (PReLU on/off); "
              f"{ms:.4f} ms vs plain {pms:.4f} ms [{card}]", flush=True)
        if headline:
            stats[name].update(ms=ms, plain_ms=pms)

    for M in (4, 256, 512):
        # A8 activations: floats that round and clamp to int8
        for K, N, what in ((4096, 12288, "qkv"), (4096, 4096, "wo")):
            x = 60.0 * torch.randn((M, K), generator=gen, device=dev)
            spmm_case("CudaTiledBitplane_x8", ck.cuda_tiled_bitplane_x8_kernel,
                      ck.bitplane_x8_plain, M, K, N, s=2, x=x,
                      headline=(M == 4 and what == "qkv"))
    for K, N, s in ((1024, 4096, 4), (4096, 11008, 2)):
        x = torch.randint(-512, 513, (32, K), generator=gen,
                          device=dev).to(torch.float32)
        spmm_case("CudaTiledBitplane_i8", ck.cuda_tiled_bitplane_i8_kernel,
                  ck.bitplane_i8_plain, 32, K, N, s=s, x=x,
                  headline=(K == 1024))

    fg, fu, fd = fmt(4096, 11008), fmt(4096, 11008), fmt(11008, 4096)
    kw = dict(gamma_gate=0.03, gamma_up=0.03, gamma_down=0.03)
    for M in (4, 128, 512):
        x = torch.randn((M, 4096), generator=gen, device=dev)
        xq, sx = requantize_rows(x)
        y, h, rmax = swiglu_launch(xq, sx, fg, fu, fd, **kw)
        want = swiglu_plain(xq, sx, fg, fu, fd, **kw)
        hq = torch.round(h / true_div(rmax[:, None] + 1e-12, 127.0))
        hq_plain, _ = requantize_rows(swiglu_hidden_plain(
            xq, sx, fg, fu, gamma_gate=0.03, gamma_up=0.03))
        torch.cuda.synchronize()
        diff = (hq - hq_plain).abs()
        flips = int((diff > 0).sum())
        check(float(diff.max()) <= 1.0, f"SwiGLU M={M}: hq differs by > 1")
        check(flips <= 1e-4 * diff.numel(),
              f"SwiGLU M={M}: {flips} of {diff.numel()} hq values flip")
        clean = ~(diff > 0).any(dim=1)
        yc, wc = y[clean], want[clean]
        bad = (yc - wc).abs() > 0.01 + 1e-5 * wc.abs()
        check(not bool(bad.any()),
              f"SwiGLU M={M}: {int(bad.sum())} outputs outside rtol=1e-5, "
              f"atol=0.01")
        err = float((yc - wc).abs().max()) if yc.numel() else 0.0
        stats["fused_bitplane_swiglu"]["max_abs_err"] = max(
            stats["fused_bitplane_swiglu"]["max_abs_err"], err)
        ms = event_ms(lambda: swiglu_launch(xq, sx, fg, fu, fd, **kw),
                      flush=flush)
        pms = event_ms(lambda: swiglu_plain(xq, sx, fg, fu, fd, **kw),
                       flush=flush)
        print(f"kernel fused_bitplane_swiglu M={M} 4096->11008->4096: "
              f"{flips} of {diff.numel()} hq flips, max |err| {err:.3g} in "
              f"{int(clean.sum())}/{M} clean rows; {ms:.4f} ms vs plain "
              f"{pms:.4f} ms [{card}]", flush=True)
        if M == 4:
            stats["fused_bitplane_swiglu"].update(ms=ms, plain_ms=pms)
    del flush
    return stats


def small_tree(cfg, seed: int) -> dict:
    """A latent parameter tree in the shape of the JAX BitTransformerLM.init
    (``ternary_spgemm_tpu/models/transformer.py:256-265``), from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, ff, kvw = cfg.d_model, cfg.d_ff, cfg.kv_width

    def lin(K, N):
        return {"w": (rng.standard_normal((K, N)) * math.sqrt(2.0 / K)
                      ).astype(np.float32),
                "b": np.zeros(N, np.float32)}

    blocks = [{"wq": lin(d, d), "wk": lin(d, kvw), "wv": lin(d, kvw),
               "wo": lin(d, d), "w_gate": lin(d, ff), "w_up": lin(d, ff),
               "w_down": lin(ff, d), "norm_attn": np.ones(d, np.float32),
               "norm_ffn": np.ones(d, np.float32)}
              for _ in range(cfg.n_layers)]
    embed = (rng.standard_normal((cfg.vocab, d)) * d ** -0.5).astype(np.float32)
    return {"embed": embed, "blocks": blocks,
            "norm_out": np.ones(d, np.float32)}


def phase_model_parity(dev) -> None:
    """Phase 4: the CPU copy (plain versions) and the card copy (kernels) of
    one small model give identical greedy tokens. The kernels are exact and
    the glue is device-independent (``models/transformer.py``), so the two
    copies agree bit for bit up to the f32 logits head, whose dot products
    sum in another order on the card: logits within rtol=atol=1e-4."""
    import numpy as np
    import torch

    from ternary_spgemm_tpu_torch.models import (
        BitTransformerConfig, generate, init_cache, lm_from_jax_params)
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    cfg = BitTransformerConfig(vocab=64, d_model=256, n_heads=4, d_ff=512,
                               n_layers=2)
    lm_cpu = lm_from_jax_params(cfg, small_tree(cfg, seed=7), a8=True,
                                fused_qkv=True, fused_ffn=True, device="cpu")
    lm_gpu = copy.deepcopy(lm_cpu).to(dev)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (4, 16)))
    before = sum(ck.launches.values())
    logits = []
    for lm, p in ((lm_cpu, prompt), (lm_gpu, prompt.to(dev))):
        caches = init_cache(cfg, 4, 16, torch.int8, device=p.device)
        logits.append(lm.prefill(p, caches)[0].cpu())
    check(sum(ck.launches.values()) > before,
          "the card copy launched no kernel")
    diff = (logits[0] - logits[1]).abs()
    err = float(diff.max())
    close = float((diff <= 1e-4 + 1e-4 * logits[0].abs()).float().mean())
    rows_off = int((diff.amax(dim=-1) > 1e-4).sum())
    print(f"model parity: prefill logits max |diff| {err:.4g}, "
          f"{close:.4%} within rtol=atol=1e-4, {rows_off} of "
          f"{diff.shape[0] * diff.shape[1]} positions with a larger diff",
          flush=True)
    check(close == 1.0,
          f"prefill logits differ between CPU and card by {err}")
    toks_cpu = generate(lm_cpu, prompt, 16, cache_dtype=torch.int8)
    toks_gpu = generate(lm_gpu, prompt.to(dev), 16,
                        cache_dtype=torch.int8).cpu()
    check(torch.equal(toks_cpu, toks_gpu),
          f"greedy tokens differ:\n{toks_cpu}\n{toks_gpu}")
    print(f"model parity (2 layers, d=256): prefill logits max |diff| "
          f"{err:.3g}; greedy tokens identical ({tuple(toks_gpu.shape)})",
          flush=True)


def phase_serve(dev, card: str) -> dict:
    """Phase 5: the counted main path at BitNet-7B width."""
    import torch

    from ternary_spgemm_tpu_torch.formats import TiledBitplane
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerConfig, build_serving_lm, generate, init_cache)
    from ternary_spgemm_tpu_torch.models.serving import PRESETS, random_ternary
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
    from ternary_spgemm_tpu_torch.ops import ternary_spgemm

    B, T0, n_new = 4, 128, 32
    cfg = BitTransformerConfig(**PRESETS["bitnet7b"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    t0 = time.perf_counter()
    lm = build_serving_lm(cfg, s=2, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    f_ns = TiledBitplane.from_dense(random_ternary(1024, 4096, 4, gen, dev))
    x_ns = torch.randint(-512, 513, (32, 1024), generator=gen,
                         device=dev).to(torch.float32)
    b_ns = torch.full((4096,), 2.0, device=dev)
    prompt = torch.randint(0, cfg.vocab, (B, T0), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ck.reset_counts()
    with warnings.catch_warnings():
        # default dispatch warns that non-integer X would be rounded; this
        # X is integer-valued
        warnings.simplefilter("ignore", UserWarning)
        y_ns = ternary_spgemm(x_ns, f_ns, b_ns)      # default dispatch -> i8
    t1 = time.perf_counter()
    toks = generate(lm, prompt, n_new, cache_dtype=torch.int8)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    counts = dict(ck.launches)
    plain = dict(ck.plain_on_cuda)
    peak = torch.cuda.max_memory_allocated(dev)

    L, F = cfg.n_layers, 1 + (n_new - 1)
    print(f"serve launches: {counts}; plain versions on CUDA: {plain}",
          flush=True)
    check(not plain, f"a plain version ran on a CUDA tensor: {plain}")
    check(counts.get("CudaTiledBitplane_x8") == 2 * L * F,
          f"x8 launches {counts.get('CudaTiledBitplane_x8')} != 2*{L}*{F}")
    check(counts.get("fused_bitplane_swiglu") == L * F,
          f"SwiGLU launches {counts.get('fused_bitplane_swiglu')} != {L}*{F}")
    check(counts.get("CudaTiledBitplane_i8") == 1,
          f"i8 launches {counts.get('CudaTiledBitplane_i8')} != 1")
    check(tuple(toks.shape) == (B, T0 + n_new), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of vocab")
    check(torch.equal(toks[:, :T0], prompt), "prompt not kept")
    check(bool(torch.isfinite(y_ns).all()), "headline SpMM not finite")

    # timing pass over the same entry points (outside the counted run)
    with torch.no_grad():
        caches = init_cache(cfg, B, T0 + n_new, torch.int8, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        logits, caches = lm.prefill(prompt, caches)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t2
        check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        cur = torch.argmax(logits[:, -1], dim=-1)
        t3 = time.perf_counter()
        for t in range(T0, T0 + n_new - 1):
            logits, caches = lm.decode_step(cur, caches, t)
            cur = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t3) / (n_new - 1) * 1e3
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    print(f"serve bitnet7b (32 layers, d=4096, ff=11008), batch {B}, prompt "
          f"{T0}, {n_new} new tokens: build {build_s:.2f} s; generate "
          f"{gen_s:.3f} s; prefill {prefill_s * 1e3:.2f} ms = "
          f"{B * T0 / prefill_s:.1f} tokens/s; decode {decode_ms:.3f} ms per "
          f"step of {B} tokens; max_memory_allocated {peak / 2**30:.3f} GiB "
          f"[{card}]", flush=True)
    return counts


def phase_new_kernels(dev, card: str) -> dict:
    """Phase 6: the benchmark path's other kernels against their plain
    versions on the card."""
    import torch

    from ternary_spgemm_tpu_torch.bench.timing import event_ms
    from ternary_spgemm_tpu_torch.models.serving import random_ternary
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    stats = {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
             for name in NEW_KERNELS}
    shapes = [(32, 1024, 4096, 4), (32, 4096, 11008, 2), (512, 4096, 4096, 2)]
    for M, K, N, s in shapes:
        W = random_ternary(K, N, s, gen, dev)
        fmts = {}
        b = torch.full((N,), 2.0, device=dev)
        a = torch.full((N,), 0.1, device=dev)
        for name, (plain, large_m) in NEW_KERNELS.items():
            if M == 512 and not large_m:
                continue
            spec = all_kernels()[name]
            kern, plain, vr = spec.fn, getattr(ck, plain), spec.x_absmax
            if spec.format_cls not in fmts:
                fmts[spec.format_cls] = spec.format_cls.from_dense(W)
            f = fmts[spec.format_cls]
            xs = [torch.randint(-vr, vr + 1, (M, K), generator=gen,
                                device=dev).to(torch.float32)]
            if name == "CudaTiledBitplane_bf16":
                xs.append(4.0 * torch.rand((M, K), generator=gen, device=dev)
                          - 2.0)
            for i, x in enumerate(xs):
                for alpha in (None, a):
                    got = kern(x, f, b, alpha)
                    want = plain(x, f, b, alpha)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    what = (f"{name} {M}x{K}x{N} prelu={alpha is not None} "
                            f"{'integer' if i == 0 else 'non-integer'} X")
                    if i == 0:
                        check(torch.equal(got, want),
                              f"{what}: kernel != plain (max |diff| {err})")
                    else:
                        bad = (got - want).abs() > 1e-3 + 1e-5 * want.abs()
                        check(not bool(bad.any()),
                              f"{what}: {int(bad.sum())} outputs outside "
                              f"rtol=1e-5, atol=1e-3 (max |diff| {err})")
                    stats[name]["max_abs_err"] = max(
                        stats[name]["max_abs_err"], err)
            x = xs[0]
            ms = event_ms(lambda: kern(x, f, b, None), flush=flush)
            pms = event_ms(lambda: plain(x, f, b, None), flush=flush)
            extra = "" if len(xs) == 1 else "; non-integer X within tolerance"
            print(f"kernel {name} {M}x{K}x{N} s={s}: bitwise equal on integer "
                  f"X (PReLU on/off){extra}; {ms:.4f} ms vs plain {pms:.4f} ms "
                  f"[{card}]", flush=True)
            if (M, K, N) == (32, 1024, 4096):
                stats[name].update(ms=ms, plain_ms=pms)
        del W, fmts
    del flush
    return stats


def phase_entry_point(dev) -> dict:
    """Phase 7: the benchmark CLI (correctness on, PReLU off and on), then
    the headline; returns the CLI runs' launch counts."""
    from ternary_spgemm_tpu_torch import __main__ as cli
    from ternary_spgemm_tpu_torch.bench import headline
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    ck.reset_counts()
    for extra in ([], ["-prelu"]):
        argv = ["-M", "32", "-K", "1024", "-N", "4096", "-s", "4",
                "-correctness", *extra]
        rc, out = run(cli.main, argv)
        print(f"$ python -m ternary_spgemm_tpu_torch {' '.join(argv)}\n"
              f"{out}", end="", flush=True)
        check(rc == 0, f"the CLI exited {rc}")
        check("ERROR" not in out, "the CLI reported an ERROR")
        lines = out.splitlines()
        for name in all_kernels():
            mine = [ln for ln in lines if ln.split()[:1] == [name]]
            check(len(mine) == 1 and mine[0].endswith("correct=True"),
                  f"{name} not reported correct: {mine}")
    counts = dict(ck.launches)
    plain = dict(ck.plain_on_cuda)
    print(f"entry-point launches: {counts}; plain versions on CUDA: {plain}",
          flush=True)
    check(not plain, f"a plain version ran on a CUDA tensor: {plain}")
    for name in spmm_kernels():
        check(counts.get(name, 0) > 0, f"{name} was not launched")

    rc, out = run(headline.main, [])
    check(rc == 0, f"the headline exited {rc}:\n{out}")
    rec = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(len(rec) == 1, f"no headline JSON line:\n{out}")
    check(json.loads(rec[0]).get("value", 0) > 0, f"headline {rec[0]}")
    print(out, end="", flush=True)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs only on "
              "the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import ternary_spgemm_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    check(os.path.abspath(pkg.__file__).startswith(ROOT + os.sep),
          f"imported the port from {pkg.__file__}, not from {ROOT}")
    check("jax" not in sys.modules, "jax was imported")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    from ternary_spgemm_tpu_torch.ops import _build
    _build.load()
    print(f"build: {_build.last_build['seconds']:.2f} s "
          f"({'compiled' if _build.last_build['built'] else 'cached'} "
          f"{os.path.relpath(_build.last_build['path'], ROOT)})", flush=True)

    check(set(spmm_kernels()) | {"fused_bitplane_swiglu"} == set(SOURCES),
          f"SOURCES {sorted(SOURCES)} != the hand-written kernels")
    stats = phase_kernels(dev, card)
    phase_model_parity(dev)
    serve_counts = phase_serve(dev, card)
    stats.update(phase_new_kernels(dev, card))
    bench_counts = phase_entry_point(dev)
    check("jax" not in sys.modules, "jax was imported")

    from ternary_spgemm_tpu_torch.ops import all_kernels
    registry = all_kernels()
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": (registry[name].reference if name in registry
                             else SWIGLU_REPLACES),
                "launches": serve_counts.get(name, 0)
                + bench_counts.get(name, 0),
                "max_abs_err": stats[name]["max_abs_err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
               for name, src in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
