"""Checkpoint -> serving bundle -> generation: the deployment CLI, the
counterpart of the repository's ``tools/export_model.py``::

    # freeze a trained checkpoint into a one-file ternary serving bundle
    python -m ternary_spgemm_tpu_torch.tools.export_model export \\
        --checkpoint ckpt --cfg cfg.json --format TiledBitplane \\
        --out model_bundle.npz

    # decode from the bundle
    python -m ternary_spgemm_tpu_torch.tools.export_model generate \\
        --bundle model_bundle.npz --prompt "3 1 4 1 5" --new-tokens 16

``cfg.json`` holds ``BitTransformerConfig`` fields (e.g. ``{"vocab": 256,
"d_model": 128, "n_heads": 4, "d_ff": 256, "n_layers": 2}``). The
checkpoint is the ``.npz`` that either package's ``checkpoint.save_pytree``
writes (the JAX package where orbax is not importable): the JAX
``BitTransformerLM.init`` parameter tree itself, or a training state whose
``--state-key`` (default ``params``) holds it. The bundle is the JAX
package's format, so either package's CLI and loader read it.

Reading a training state: the JAX CLI restores it against the skeleton
``{"params": like, "opt": optax.adam(1e-3).init(like), "step": 0}``. This
module builds the same leaf layout without optax: ``like`` is
``models.convert.jax_tree`` of a ``BitTransformerLM`` of the cfg's
structure (its widths cut to the least the cfg allows: only the tree's
keys and order matter), Adam's state is ``(count, mu, nu)`` and an empty
tuple, and ``checkpoint.restore_pytree_key`` reads only the leaves under
``--state-key``. A file whose leaves do not fit that skeleton (or a key
the skeleton lacks) is read as the bare params tree, as the JAX CLI falls
back.

Kernels are named by the port's registry or the JAX registry's (mapped to
the counterpart). ``--platform`` of the JAX CLI is ``--device`` here: the
card by default (raises without one), ``cpu`` for the plain versions.
``generate`` runs the captured loop on the card; ``--prompt`` may hold
several prompts of one length separated by commas (one line of tokens
each). Sampling (``--temperature`` > 0) draws the JAX package's noise for
``--seed`` (``models/threefry.py``), so both CLIs print the same tokens.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from ternary_spgemm_tpu_torch import checkpoint
from ternary_spgemm_tpu_torch.formats import all_formats
from ternary_spgemm_tpu_torch.models.convert import jax_tree
from ternary_spgemm_tpu_torch.models.generate import (
    ExportedTransformerLM,
    generate,
)
from ternary_spgemm_tpu_torch.models.threefry import KeyStream
from ternary_spgemm_tpu_torch.models.transformer import (
    BitTransformerConfig,
    BitTransformerLM,
)
from ternary_spgemm_tpu_torch.ops.api import all_kernels, port_name
from ternary_spgemm_tpu_torch.utils.device import resolve_device


def params_like(cfg: BitTransformerConfig) -> dict:
    """The key layout of ``cfg``'s JAX ``BitTransformerLM.init`` tree (tiny
    leaves: the widths cut to the least the cfg allows)."""
    small = dataclasses.replace(cfg, vocab=1, d_model=2 * cfg.n_heads,
                                d_ff=1, remat=False)
    return jax_tree(BitTransformerLM(small, device="cpu"))


def read_params(path: str, cfg: BitTransformerConfig, state_key: str):
    """The params tree (numpy leaves) of a ``save_pytree`` file: under
    ``state_key`` of a training state, else the file itself (module
    docstring)."""
    like = params_like(cfg)
    if state_key:
        adam = ((0, like, like), ())
        try:
            return checkpoint.restore_pytree_key(
                path, {"params": like, "opt": adam, "step": 0}, state_key)
        except (KeyError, ValueError):
            pass
    return checkpoint.restore_pytree(path, like)


def _kernel(name):
    """A kernel of the port's registry, or the counterpart of a JAX one."""
    if name is None or name == "auto" or name in all_kernels():
        return name
    return port_name(name)


def cmd_export(args) -> int:
    dev = resolve_device(args.device)
    with open(args.cfg) as f:
        cfg = BitTransformerConfig(**json.load(f))
    params = read_params(args.checkpoint, cfg, args.state_key)
    lm = ExportedTransformerLM.from_params(
        cfg, params, all_formats()[args.format], kernel=_kernel(args.kernel),
        a8=args.a8, with_transpose=not args.serving_only,
        fused_ffn=args.fused_ffn, fused_qkv=args.fused_qkv, auto=args.auto,
        head_dtype=torch.bfloat16 if args.head_dtype == "bf16" else None,
        device=dev)
    checkpoint.save_lm_bundle(args.out, lm)
    size = os.path.getsize(args.out if args.out.endswith(".npz")
                           else args.out + ".npz")
    print(f"wrote {args.out}: {size / 1e6:.2f} MB for "
          f"{sum(a.size for a in checkpoint._leaves(params)) / 1e6:.2f}M "
          f"params ({args.format})")
    return 0


def cmd_generate(args) -> int:
    dev = resolve_device(args.device)
    lm = checkpoint.load_lm_bundle(args.bundle, device=dev)
    rows = [[int(t) for t in p.split()] for p in args.prompt.split(",")]
    if len({len(r) for r in rows}) != 1:
        raise SystemExit("the prompts must have one length")
    prompt = torch.tensor(rows, dtype=torch.long, device=dev)
    if int(prompt.max()) >= lm.cfg.vocab:
        raise SystemExit(f"prompt token {int(prompt.max())} >= vocab "
                         f"{lm.cfg.vocab}")
    T0 = prompt.shape[1]
    stream = KeyStream(args.seed, T0 - 1) if args.temperature > 0 else None
    out = generate(lm, prompt, args.new_tokens,
                   cache_dtype=torch.int8 if args.int8_kv else torch.float32,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, generator=stream)
    for row in out[:, T0:].tolist():
        print(" ".join(map(str, row)))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.export_model",
        description="checkpoint -> serving bundle -> generation")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="checkpoint -> serving bundle")
    pe.add_argument("--checkpoint", required=True)
    pe.add_argument("--cfg", required=True, help="BitTransformerConfig JSON")
    pe.add_argument("--format", default="TiledBitplane",
                    help="container class name (formats.all_formats())")
    pe.add_argument("--kernel", default=None,
                    help="pin a registry kernel, the port's or the JAX "
                         "registry's name (default: safe dispatch)")
    pe.add_argument("--state-key", default="params",
                    help="key of the params tree inside a saved training "
                         "state ('' if the checkpoint IS the params tree)")
    pe.add_argument("--a8", action="store_true",
                    help="W1.58-A8 serving mode: per-row int8 activation "
                         "requantize on every projection")
    pe.add_argument("--serving-only", action="store_true",
                    help="skip the transposed containers (forward-only "
                         "export; halves bundle size and export time)")
    pe.add_argument("--fused-ffn", action="store_true")
    pe.add_argument("--fused-qkv", action="store_true")
    pe.add_argument("--auto", action="store_true",
                    help="pick fused_ffn/fused_qkv by measurement at the "
                         "decode shape (autotune_serving_flags)")
    pe.add_argument("--head-dtype", default="f32", choices=["f32", "bf16"],
                    help="logits-head embedding storage (bf16 halves the "
                         "per-step head bytes)")
    pe.add_argument("--out", required=True)
    pe.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pe.set_defaults(fn=cmd_export)

    pg = sub.add_parser("generate", help="decode from a bundle")
    pg.add_argument("--bundle", required=True)
    pg.add_argument("--prompt", required=True,
                    help="space-separated token ids; several prompts of one "
                         "length separated by commas")
    pg.add_argument("--new-tokens", type=int, default=16)
    pg.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default); >0 samples the softmax")
    pg.add_argument("--top-k", type=int, default=0)
    pg.add_argument("--top-p", type=float, default=1.0)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--int8-kv", action="store_true",
                    help="serve with the int8 KV cache (4x smaller)")
    pg.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pg.set_defaults(fn=cmd_generate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
