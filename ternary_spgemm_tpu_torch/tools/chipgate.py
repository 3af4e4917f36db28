"""On-card multi-tile correctness gate — counterpart of the repository's
``tools/chipgate.py``.

Every registered kernel (the port's 31, a counterpart of each of the JAX
registry's) runs through ``bench.harness.run_config`` with the correctness
gate on, at one shape chosen to cut every kernel's work into several tiles
(default M=384, K=2048, N=8192, s=16: two 4096-column storage tiles and
two 1024-row K-blocks of the bit planes, M above every decode branch's
rows; ``--prelu`` gates the PReLU epilogue too), against the dense
reference at abs 1e-5 (the reference gate of
``cpp_impl/main.cpp:206-249``).

The harness's reference is the f32 product with TF32 off. Before the
kernels run, the gate holds it bitwise against the f64 product rounded to
f32 (then the same f32 bias and PReLU), in each activation domain the
kernels are gated in (the X the restricted kernels see is clipped into
their domain): on the integer X of the harness every partial sum is an
integer below 2**24, so the two agree, and the gate stands against the f64
reference. Both are computed on the device, outside any timed region.

The record is the harness's sweep record (``to_reference_json``) with a
``gate`` block: the device, the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit``), the reference check, ``failed`` (kernels
whose output disagreed) and ``errors`` (kernels that raised). Exit 1 if
either is non-empty or the reference check fails.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.chipgate [--output PATH]
        [--M 384 --K 2048 --N 8192 --s 16] [--prelu] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import datetime
import sys

import torch


def f64_reference_check(cfg, dev: torch.device, domains) -> dict:
    """The harness's f32 reference against the f64 product rounded to f32
    for ``cfg``'s W, X, bias (and alpha) on ``dev``, in each activation
    domain of ``domains`` (None: unclipped; else ``|x| <= absmax``): the
    max |diff| a domain and whether every domain is bitwise."""
    from ternary_spgemm_tpu_torch import reference
    from ternary_spgemm_tpu_torch.formats import (
        generate_alpha, generate_bias, generate_ternary, generate_x)

    W = torch.from_numpy(generate_ternary(cfg.K, cfg.N, cfg.s,
                                          seed=cfg.seed)).to(dev)
    X = torch.from_numpy(generate_x(cfg.M, cfg.K, seed=cfg.seed + 1)).to(dev)
    b = torch.from_numpy(generate_bias(cfg.N)).to(dev)
    alpha = (torch.from_numpy(generate_alpha(cfg.N)).to(dev)
             if cfg.prelu else None)
    out = {}
    for absmax in domains:
        Xc = X if absmax is None else torch.clamp(X, -absmax, absmax)
        want = (reference.dense_gemm_prelu(Xc, W, b, alpha) if cfg.prelu
                else reference.dense_gemm(Xc, W, b))
        y64 = (Xc.double() @ W.double()).float() + b[None, :]
        if cfg.prelu:
            y64 = reference.prelu(y64, alpha[None, :])
        out["all" if absmax is None else str(absmax)] = float(
            (want - y64).abs().max())
    return {"f32_equals_f64": all(v == 0.0 for v in out.values()),
            "max_abs_diff_by_domain": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.chipgate")
    p.add_argument("--M", type=int, default=384)
    p.add_argument("--K", type=int, default=2048)
    p.add_argument("--N", type=int, default=8192)
    p.add_argument("--s", type=int, default=16)
    p.add_argument("--prelu", action="store_true",
                   help="also gate the fused PReLU epilogue")
    p.add_argument("--output", default=None)
    p.add_argument("--min-seconds", type=float, default=0.02)
    p.add_argument("--repeats", type=int, default=2,
                   help="independent timing estimates per kernel")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench import (
        BenchConfig, run_config, to_reference_json)
    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.tools import card_line, write_json
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = BenchConfig(M=args.M, K=args.K, N=args.N, s=args.s,
                      prelu=args.prelu, correctness=True,
                      min_seconds=args.min_seconds,
                      repeats=max(1, args.repeats),
                      device=args.device,
                      timer="cuda_events" if dev.type == "cuda" else "wall")
    # the activation domains run_config gates in (an x_absmax of 512 or
    # more is the whole domain)
    domains = sorted({s.x_absmax if (s.x_absmax or 512) < 512 else None
                      for s in all_kernels().values()},
                     key=lambda a: -1 if a is None else a)
    ref = f64_reference_check(cfg, dev, domains)
    results = run_config(cfg, verbose=True)
    record = to_reference_json(cfg, results)
    bad = [r.name for r in results if r.correct is False]
    errs = {r.name: r.error for r in results if r.error}
    record["gate"] = {
        "device": device_name(args.device),
        "backend": dev.type,
        "card": card_line(dev),
        "when": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "purpose": "multi-tile correctness gate of every kernel (two N "
                   "tiles and two K-blocks of the bit planes at the default "
                   "shape)",
        "reference": ref,
        "failed": bad,
        "errors": errs,
    }
    if args.output:
        write_json(args.output, [record])
    n_ok = sum(1 for r in results if r.correct)
    print(f"chipgate {args.M}x{args.K}x{args.N} s={args.s} prelu="
          f"{args.prelu}: {n_ok}/{len(results)} correct, {len(bad)} failed, "
          f"{len(errs)} errored; f32 reference equals f64 "
          f"{ref['f32_equals_f64']}"
          + (f" -> {args.output}" if args.output else ""), flush=True)
    if bad or errs or not ref["f32_equals_f64"]:
        print("FAILED:", ", ".join(bad + list(errs)) or "the reference "
              "check", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
