"""Block-level benchmark: one ternary transformer block at BitNet shapes,
across exported-container kernels — counterpart of the repository's
``tools/model_bench.py``.

The SpMM sweeps (``tools.sweep``) time the isolated op; this tool times
what a user deploys, one block (attention and the SwiGLU FFN, seven
ternary projections), in three regimes:

* ``qat``: a training step (forward, backward through the STE and a
  ``torch.optim.SGD`` step) and a forward, of the QAT block;
* ``exported``: the frozen block through each kernel of the registry for
  ``--format`` (the hand-written ones on the card, the torch-op ones on
  the CPU; ``--kernels`` names any, each with its own container), then
  the measured dispatch (``autotune_exported`` at the prefill and the
  decode shape), the fixed kernel at the decode shape and the decode
  block with both serving fast paths (the fused SwiGLU FFN and the merged
  QKV);
* ``a8``: the W1.58-A8 block, every projection through
  ``apply_exported_a8``.

Each result is seconds a block call (the median of ``--repeats``
estimates, with their spread), with the projections' dense-equivalent
TFLOP/s: CUDA events around back-to-back calls on the card, the host clock
on the CPU (``bench.timing.time_for``). Presets:
``bitnet3b`` d=3200 ff=8640, ``bitnet7b`` d=4096 ff=11008 (B=1, T=512),
``test`` (tiny). Prints one JSON line a result and the whole record;
writes a file only with ``--output`` (never under ``bench_artifacts/``).

Usage::

    python -m ternary_spgemm_tpu_torch.tools.model_bench [--preset bitnet7b]
        [--format TiledBitplane] [--kernels a,b] [--regimes qat,exported,a8]
        [--min-seconds 0.1] [--output PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import torch

from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.bench.timing import time_for
from ternary_spgemm_tpu_torch.formats import all_formats
from ternary_spgemm_tpu_torch.models.bitlinear import (
    apply_exported_a8,
    default_generator,
    export_layer,
)
from ternary_spgemm_tpu_torch.models.convert import jax_tree
from ternary_spgemm_tpu_torch.models.exported import autotune_exported
from ternary_spgemm_tpu_torch.models.transformer import (
    LINEARS,
    BitTransformerBlock,
    BitTransformerConfig,
    ExportedTransformerBlock,
    causal_attend,
    rms_norm,
    silu,
)
from ternary_spgemm_tpu_torch.ops import all_kernels
from ternary_spgemm_tpu_torch.tools import emit
from ternary_spgemm_tpu_torch.tools.sweep import kernel_names
from ternary_spgemm_tpu_torch.utils.device import resolve_device

#: the JAX tool's presets (``tools/model_bench.py:28-32``)
PRESETS = {
    "test": dict(d_model=64, n_heads=4, d_ff=128, B=2, T=16),
    "bitnet3b": dict(d_model=3200, n_heads=32, d_ff=8640, B=1, T=512),
    "bitnet7b": dict(d_model=4096, n_heads=32, d_ff=11008, B=1, T=512),
}
#: the kernel the decode-shaped baselines run, where it is benchmarked
FIXED_KERNEL = "CudaTiledBitplane_i8"


def default_kernels(fmt_cls, dev: torch.device) -> list:
    """The registry's kernels for ``fmt_cls`` that run on ``dev``'s kind
    (hand-written on the card, torch ops on the CPU), the int8-native ones
    left out (the block's activations are not int8)."""
    return [s.name for s in all_kernels().values()
            if s.format_cls is fmt_cls
            and s.name.startswith("Cuda") == (dev.type == "cuda")
            and s.x_absmax != 127]


def a8_block(cfg, frozen, norm_attn, norm_ffn):
    """The W1.58-A8 block over ``frozen`` (name -> ``export_layer``'s
    tuple): every projection through ``apply_exported_a8``."""
    def block(z):
        B, T, _ = z.shape

        def lin(n, h):
            fmt, gamma, b, alpha = frozen[n]
            return apply_exported_a8(h.reshape(B * T, -1), fmt, gamma, b,
                                     alpha).reshape(B, T, -1)

        h = rms_norm(z, norm_attn)
        z = z + lin("wo", causal_attend(cfg.head_tuple, lin("wq", h),
                                        lin("wk", h), lin("wv", h)))
        h = rms_norm(z, norm_ffn)
        return z + lin("w_down", silu(lin("w_gate", h)) * lin("w_up", h))
    return block


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.model_bench")
    p.add_argument("--preset", choices=sorted(PRESETS), default="bitnet7b")
    p.add_argument("--format", dest="fmt", default="TiledBitplane")
    p.add_argument("--kernels", default=None,
                   help="comma-separated exported-path kernels, the port's "
                        "or the JAX registry's names (default: the "
                        "registered kernels for --format)")
    p.add_argument("--regimes", default="qat,exported,a8")
    p.add_argument("--min-seconds", type=float, default=0.1)
    p.add_argument("--repeats", type=int, default=1,
                   help="independent estimates a result (its "
                        "seconds_spread: (max - min) / median)")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    shape = PRESETS[args.preset]
    cfg = BitTransformerConfig(vocab=64, d_model=shape["d_model"],
                               n_heads=shape["n_heads"], d_ff=shape["d_ff"],
                               n_layers=1)
    gen = default_generator(dev)
    block = BitTransformerBlock(cfg, generator=gen, device=dev)
    params = copy.deepcopy(jax_tree(block, numpy=False))  # SGD steps below
    B, T = shape["B"], shape["T"]
    x = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
    fmt_cls = all_formats()[args.fmt]
    regimes = args.regimes.split(",")
    results = {"preset": args.preset, "shape": shape, "format": args.fmt,
               "device": device_name(dev), "results": {}}

    def seconds(fn):
        return time_for(fn, dev, args.min_seconds, args.repeats)

    def record(name, t, ntok=None):
        ntok = B * T if ntok is None else ntok
        flops = 2 * ntok * (4 * cfg.d_model ** 2 + 3 * cfg.d_model * cfg.d_ff)
        rec = {"seconds": t.seconds, "seconds_spread": t.seconds_spread,
               "n_estimates": t.n_estimates,
               "proj_tflops_effective": flops / t.seconds / 1e12}
        results["results"][name] = rec
        print(json.dumps({name: rec}), flush=True)
        return rec

    def attempt(name, fn):
        """Run ``fn``; a failure is recorded under ``name``, and the run
        goes on."""
        try:
            fn()
        except Exception as e:
            results["results"][name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"{name} FAILED: {e}", flush=True)

    if "qat" in regimes:
        opt = torch.optim.SGD(block.parameters(), lr=1e-3)

        def train_step():
            opt.zero_grad(set_to_none=True)
            loss = torch.mean(block(x) ** 2)
            loss.backward()
            opt.step()

        record("qat_train_step", seconds(train_step))
        with torch.no_grad():
            record("qat_forward", seconds(lambda: block(x)))
        opt.zero_grad(set_to_none=True)

    def exported_block(kernel, fmt=fmt_cls, **kw):
        return ExportedTransformerBlock.from_params(
            cfg, params, fmt, kernel=kernel, device=dev,
            with_transpose=False, **kw)

    kernels = (kernel_names(args.kernels) if args.kernels
               else default_kernels(fmt_cls, dev))
    x1 = x[:, :1, :]
    with torch.no_grad():
        if "exported" in regimes:
            for kname in kernels:
                def one(kname=kname):
                    blk = exported_block(
                        kname, all_kernels()[kname].format_cls)
                    record(f"exported/{kname}", seconds(lambda: blk(x)))
                attempt(f"exported/{kname}", one)

            # measured dispatch: each projection its own measured winner
            # at the prefill (M = B*T) and the decode (M = B) shape
            for tag, M, z in (("prefill", B * T, x), ("decode", B, x1)):
                def auto(tag=tag, M=M, z=z):
                    blk = exported_block("auto")
                    picks = autotune_exported(blk, M, absmax=512)
                    rec = record(f"exported/auto_{tag}",
                                 seconds(lambda: blk(z)),
                                 ntok=z.shape[0] * z.shape[1])
                    rec["picks"] = {f"{k[0]}x{k[1]}": v
                                    for k, v in picks.items()}
                attempt(f"exported/auto_{tag}", auto)

            fixed = (FIXED_KERNEL if FIXED_KERNEL in kernels
                     else (kernels[0] if kernels else None))
            if fixed:
                def decode():
                    blk = exported_block(fixed,
                                         all_kernels()[fixed].format_cls)
                    record(f"exported/{fixed}_decode",
                           seconds(lambda: blk(x1)), ntok=B)
                attempt(f"exported/{fixed}_decode", decode)

                def fused():
                    blk = exported_block(fixed, fused_ffn=True,
                                         fused_qkv=True)
                    if not blk._fused_ffn_applicable():
                        raise RuntimeError("fused-FFN contract not met for "
                                           "this preset/format")
                    record("exported/fused_block_decode",
                           seconds(lambda: blk(x1)), ntok=B)
                attempt("exported/fused_block_decode", fused)

        if "a8" in regimes:
            if not any(s.format_cls is fmt_cls and s.x_absmax == 127
                       for s in all_kernels().values()):
                results["results"]["a8_block"] = {
                    "error": f"no _x8 kernel registered for {args.fmt}"}
            else:
                frozen = {n: export_layer(params[n], fmt_cls)
                          for n in LINEARS}
                run = a8_block(cfg, frozen, block.norm_attn.detach(),
                               block.norm_ffn.detach())
                record("a8_block", seconds(lambda: run(x)))
    emit(results, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
