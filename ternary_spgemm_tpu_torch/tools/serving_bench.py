"""End-to-end serving benchmark: whole-model tokens/s of a BitNet preset —
counterpart of the repository's ``tools/serving_bench.py``.

It builds a preset of ``models.serving.PRESETS`` (``test``, ``bitnet3b``,
``bitnet7b``: the JAX tool's) with random ternary weights of density 1/s
(``models.serving.build_serving_lm``: W1.58-A8, the fast paths that
``--fast-paths`` names, ``--kv-heads`` shared K/V heads), checks that
``generate`` gives in-range tokens (the eager loop, counted: the kernels
the variant launches), then times, each ``--repeats`` times:

* ``prefill``: one replay of the captured prefill of ``batch`` prompts of
  ``T0`` tokens (``models/graphs.py``; on the CPU the same body eagerly);
* ``decode``: the captured generate loop's ``n_new`` decode steps, replayed
  back to back after that prefill, per token;
* ``decode_single_dispatch``: one decode step, and ``per_block``: one block
  at the decode shape, and ``head``: the norm and the logits head, each
  from a CUDA graph (``bench.timing.time_cuda_graph``); the step's cost is
  set against ``n_layers`` blocks and the head, the rest being ``glue``.

On the card the times are CUDA events around the replays; on the CPU the
host clock around the eager bodies (a CPU number, no device figure). The
JAX tool adds a runtime-zero dummy carry to every timed function, a data
dependency its TPU loop needs; CUDA events need none, so it is not ported.
``--trace`` adds a ``torch.profiler`` summary of one captured decode step
(``tools/serve_trace.py``'s ``traced``).

Usage::

    python -m ternary_spgemm_tpu_torch.tools.serving_bench [--preset bitnet7b]
        [--s 2] [--repeats 3] [--cache-dtype int8|f32] [--head-dtype f32|bf16]
        [--fast-paths both|qkv|ffn|none] [--kv-heads 0] [--batch 1]
        [--trace] [--output PATH] [--device cuda|cpu]

It prints a line a measurement and the whole record as one JSON line; it
writes a file only where ``--output`` says, never under
``bench_artifacts/``.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time

import torch

from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.bench.timing import time_calls
from ternary_spgemm_tpu_torch.models import serving
from ternary_spgemm_tpu_torch.models.generate import (
    _block_decode,
    _fused_hooks,
    generate,
)
from ternary_spgemm_tpu_torch.models.graphs import GenerateLoop, captured
from ternary_spgemm_tpu_torch.models.transformer import rms_norm
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.tools import emit, timer
from ternary_spgemm_tpu_torch.utils.device import resolve_device

#: what each ``--fast-paths`` builds: (fused_ffn, fused_qkv)
FAST_PATHS = {"both": (True, True), "ffn": (True, False),
              "qkv": (False, True), "none": (False, False)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.serving_bench")
    p.add_argument("--preset", choices=sorted(serving.PRESETS),
                   default="bitnet7b")
    p.add_argument("--s", type=int, default=2)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--cache-dtype", default="int8", choices=["int8", "f32"])
    p.add_argument("--head-dtype", default="f32", choices=["f32", "bf16"],
                   help="logits-head embedding storage: bf16 halves the "
                        "bytes the head streams a decode step")
    p.add_argument("--fast-paths", default="both", choices=sorted(FAST_PATHS),
                   help="the serving fast paths to build: the fused SwiGLU "
                        "FFN, the merged QKV, both or none")
    p.add_argument("--kv-heads", type=int, default=0,
                   help="grouped-query attention: shared K/V heads (0 = "
                        "n_heads, MHA)")
    p.add_argument("--batch", type=int, default=1,
                   help="requests decoded together (B)")
    p.add_argument("--trace", action="store_true",
                   help="also profile one captured decode step")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    shape = serving.PRESETS[args.preset]
    T0, n_new = shape["T0"], shape["n_new"]
    B, max_t = args.batch, T0 + n_new
    cache_dtype = torch.int8 if args.cache_dtype == "int8" else torch.float32
    fused_ffn, fused_qkv = FAST_PATHS[args.fast_paths]

    t0 = time.perf_counter()
    lm = serving.build_serving_lm(
        serving.preset_config(args.preset), s=args.s, device=dev,
        head_dtype=torch.bfloat16 if args.head_dtype == "bf16" else None,
        fused_ffn=fused_ffn, fused_qkv=fused_qkv, n_kv_heads=args.kv_heads)
    _sync(dev)
    build_s = time.perf_counter() - t0
    cfg, blk = lm.cfg, lm.blocks[0]
    # the FFN's kernel: the fused SwiGLU where the block asks for it and its
    # contract holds (the JAX rule), else the three A8 linears
    branch = ("fused" if blk.fused_ffn and blk._fused_ffn_applicable()
              else "unfused")
    print(f"build: {build_s:.1f} s ({args.preset}, {cfg.n_layers} layers, "
          f"fast paths {args.fast_paths}, FFN {branch}, kv_heads "
          f"{cfg.kv_heads}) [{device_name(dev)}]", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    gen = torch.Generator(device=dev).manual_seed(42)
    prompt = torch.randint(0, cfg.vocab, (B, T0), generator=gen, device=dev)
    out = {"preset": args.preset, "config": shape, "s": args.s,
           "kv_heads": cfg.kv_heads, "cache_dtype": args.cache_dtype,
           "head_dtype": args.head_dtype, "build_seconds": build_s,
           "fast_paths": {"fused_ffn": fused_ffn, "fused_qkv": fused_qkv,
                          "a8": True},
           "ffn_branch": branch, "batch": B, "device": device_name(dev)}

    with torch.no_grad():
        # the eager loop gives in-range tokens; its launches, counted, are
        # the kernels this variant runs (one prefill of 8 tokens, 3 steps)
        ck.reset_counts()
        toks = generate(lm, prompt[:, :8], 4, max_t=max_t,
                        cache_dtype=cache_dtype, graph=False)
        _sync(dev)
        if tuple(toks.shape) != (B, 12) or not bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise RuntimeError(f"generate() gave {tuple(toks.shape)} tokens "
                               "out of range")
        out["launches"] = dict(ck.launches)
        out["plain_on_cuda"] = dict(ck.plain_on_cuda)
        print(f"generate() sanity OK; kernels launched (a prefill, 3 steps): "
              f"{out['launches']}", flush=True)

        # the generate loop: captured on the card, eager on the CPU
        loop = (captured(lm, B, T0, max_t, cache_dtype=cache_dtype,
                         prefill=True, temperature=0.0, top_k=0, top_p=1.0,
                         device=dev)
                if dev.type == "cuda" else
                GenerateLoop(lm, B, T0, max_t, cache_dtype=cache_dtype,
                             device=dev))
        loop.load(prompt)
        prefill, step = loop.calls["prefill"], loop.calls["step"]
        r_fill = time_calls(prefill, dev, runs=2, repeats=args.repeats)
        print(f"prefill: {r_fill.seconds * 1e3:.3f} ms "
              f"({B * T0 / r_fill.seconds:.1f} tokens/s)", flush=True)

        def decode():
            loop.pos.fill_(T0)
            for _ in range(n_new):
                step()

        r_dec = time_calls(decode, dev, runs=1, repeats=args.repeats)
        step_s = r_dec.seconds / n_new
        print(f"decode: {step_s * 1e3:.3f} ms a step "
              f"({B / step_s:.1f} tokens/s)", flush=True)

        # one dispatched step, one block and the head, each a CUDA graph
        caches_f = loop.caches
        first = loop.cur.clone()
        time_graph = timer(dev, graph=True)
        r_step = time_graph(lambda x: lm.decode_step(x, caches_f, T0)[0],
                            first, repeats=args.repeats)
        cache1 = copy.copy(caches_f[0])
        x1 = torch.zeros((B, 1, cfg.d_model), device=dev)

        def block_fn(x):
            lin = lambda n, z: blk.linears[n](z.reshape(B, -1))[:, None, :]
            ffn, qkv = _fused_hooks(blk, B, lambda z: (B, 1))
            return _block_decode(cfg.head_tuple, lin, blk.norm_attn,
                                 blk.norm_ffn, x, cache1, T0, ffn=ffn,
                                 qkv=qkv, window=cfg.window)[0]

        r_blk = time_graph(block_fn, x1, repeats=args.repeats)
        r_head = time_graph(lambda x: lm._head(rms_norm(x, lm.norm_out)),
                            x1, repeats=args.repeats)
        # the captured generate loop's greedy tokens for the prompt
        out["greedy_tokens"] = loop.run(prompt, n_new).tolist()
        if args.trace:
            from ternary_spgemm_tpu_torch.tools.serve_trace import traced
            loop.pos.fill_(T0)
            out["trace"] = traced(step, dev)

    blk_s, head_s = r_blk.seconds, r_head.seconds
    layers_s = cfg.n_layers * blk_s
    glue_s = step_s - layers_s - head_s
    out.update({
        "prefill": {"seconds": r_fill.seconds,
                    "spread": r_fill.seconds_spread,
                    "tokens_per_s": T0 / r_fill.seconds,
                    "aggregate_tokens_per_s": B * T0 / r_fill.seconds,
                    "n_estimates": r_fill.n_estimates},
        "decode": {"seconds_per_token": step_s,
                   "spread": r_dec.seconds_spread,
                   "tokens_per_s": 1.0 / step_s,
                   "aggregate_tokens_per_s": B / step_s,
                   "scan_length": n_new,
                   "n_estimates": r_dec.n_estimates},
        "decode_single_dispatch": {"seconds": r_step.seconds,
                                   "spread": r_step.seconds_spread,
                                   "tokens_per_s": 1.0 / r_step.seconds},
        "attribution_us": {
            "step": step_s * 1e6, "per_block": blk_s * 1e6,
            "blocks_total": layers_s * 1e6, "head": head_s * 1e6,
            "glue": glue_s * 1e6, "glue_fraction": glue_s / step_s},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    })
    a = out["attribution_us"]
    print(f"step {r_step.seconds * 1e3:.3f} ms dispatched alone; block "
          f"{a['per_block']:.1f} us x {cfg.n_layers} = "
          f"{a['blocks_total']:.1f} us, head {a['head']:.1f} us, glue "
          f"{a['glue']:.1f} us ({a['glue_fraction']:.1%} of the step)",
          flush=True)
    lm._captured.clear()
    emit(out, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
