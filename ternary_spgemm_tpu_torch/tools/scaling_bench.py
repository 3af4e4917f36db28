"""Weak scaling of the sharded schemes — counterpart of the repository's
``tools/scaling_bench.py`` (BASELINE.json config 5: column / block
partitioned ternary SpMM with the activation gather overlapped against
compute, >= 80% weak-scaling efficiency).

For each device count d (powers of 2 up to the process group's size) the
scheme runs at a per-device work that stays constant, and
``weak_scaling_efficiency(d) = t(1) / t(d)``:

* ``column`` / ``overlapped`` — ``parallel.column_sharded_spgemm`` /
  ``overlapped_gather_spgemm`` at N = ``--n-per-device`` x d over the
  ``--format`` container (``BlockPackedTernary`` by default), M rows (at
  least d for the ring's row chunks);
* ``pipeline`` — ``parallel.pipeline_lm_apply`` over 2d blocks (2 a
  stage), 4 microbatches; the GPipe bubble bounds the efficiency at
  ``schedule_bound = n_micro / (n_micro + d - 1)``;
* ``moe`` — a ``BitMoE`` layer of d experts split over d ranks (expert
  parallelism) on 256 d tokens.

``host_normalized_efficiency`` (the SpMM schemes) and
``shared_host_efficiency`` (pipeline, moe) hold t(d) against d t(1) (over
the schedule bound): the fair reference where the d ranks share one host's
cores, as gloo processes on one machine do. A time is the slowest rank's,
CUDA events around ``--runs`` calls on the card, the host clock on the CPU.

The process group is the caller's when one is initialised (the tests run
d up to 2 over gloo processes); otherwise this process starts a group of
one rank (NCCL on the card, gloo with ``--device cpu``) and ends it, so d
= 1 on one card.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.scaling_bench
        [--scheme column|overlapped|pipeline|moe] [--n-per-device 8192]
        [--M 32 --K 1024 --s 4] [--format BlockPackedTernary]
        [--kernel NAME] [--runs 20] [--output PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
from typing import Callable

import torch
import torch.distributed as dist

DEVICE_COUNTS = (1, 2, 4, 8, 16, 32)
N_MICRO = 4


@dataclasses.dataclass
class Case:
    """One scheme at d devices: the sharded call, the same computation on
    one device (whole inputs, no group), and the scheme's bound."""
    sharded: Callable
    single: Callable
    bound: float = 1.0
    N: int = None


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def build_case(args, d: int, dev) -> Case:
    """``args.scheme`` at ``d`` devices on the group's mesh (every rank
    builds the same seeded inputs)."""
    from ternary_spgemm_tpu_torch.parallel import make_mesh

    if args.scheme in ("column", "overlapped"):
        from ternary_spgemm_tpu_torch.formats import (
            all_formats, generate_bias, generate_ternary, generate_x)
        from ternary_spgemm_tpu_torch.ops import ternary_spgemm
        from ternary_spgemm_tpu_torch.parallel import (
            column_sharded_spgemm, overlapped_gather_spgemm)

        N = args.n_per_device * d
        mesh = make_mesh({"model": d}, device_type=dev.type)
        fmt = all_formats()[args.fmt].from_dense(
            generate_ternary(args.K, N, args.s, seed=0), device=dev)
        b = torch.from_numpy(generate_bias(N)).to(dev)
        M = max(args.M, d) if args.scheme == "overlapped" else args.M
        X = torch.from_numpy(generate_x(M, args.K, seed=1)).to(dev)
        scheme = (overlapped_gather_spgemm if args.scheme == "overlapped"
                  else column_sharded_spgemm)
        return Case(lambda: scheme(X, fmt, b, mesh=mesh, axis="model",
                                   kernel=args.kernel),
                    lambda: ternary_spgemm(X, fmt, b, kernel=args.kernel),
                    N=N)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.scheme == "pipeline":
        from ternary_spgemm_tpu_torch.models import (
            BitTransformerConfig, BitTransformerLM)
        from ternary_spgemm_tpu_torch.parallel import pipeline_lm_apply

        cfg = BitTransformerConfig(vocab=64, d_model=128, n_heads=4,
                                   d_ff=256, n_layers=2 * d)
        model = BitTransformerLM(cfg, generator=gen, device=dev)
        toks = torch.zeros((8 * N_MICRO, 32), dtype=torch.long, device=dev)
        mesh = make_mesh({"pipe": d}, device_type=dev.type)
        return Case(lambda: pipeline_lm_apply(model, toks, mesh,
                                              n_micro=N_MICRO),
                    lambda: model(toks), bound=N_MICRO / (N_MICRO + d - 1))
    from torch.distributed.tensor import Replicate, distribute_tensor

    from ternary_spgemm_tpu_torch.models import (
        BitMoE, BitMoEConfig, moe_param_shardings)

    cfg = BitMoEConfig(d_model=128, d_ff=256, n_experts=d,
                       capacity_factor=2.0)
    moe = BitMoE(cfg, generator=gen, device=dev)
    mesh = make_mesh({"expert": d}, device_type=dev.type)
    sharded = copy.deepcopy(moe)
    for name, pl in moe_param_shardings(mesh).items():
        setattr(sharded, name, torch.nn.Parameter(distribute_tensor(
            getattr(moe, name).detach(), mesh, pl)))
    x = torch.randn((256 * d, cfg.d_model), generator=gen, device=dev)
    xd = distribute_tensor(x, mesh, [Replicate()])
    return Case(lambda: sharded(xd)[0], lambda: moe(x)[0])


def slowest_seconds(fn, dev, runs: int) -> float:
    """Seconds a call of ``fn`` takes on the slowest rank: ``runs`` calls
    after a warm-up, timed as ``bench.timing.time_calls`` times them,
    every rank the same count (the schemes' collectives pair up)."""
    from ternary_spgemm_tpu_torch.bench.timing import time_calls

    fn()
    dist.barrier()
    t = torch.tensor([time_calls(fn, dev, runs).seconds], dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def scale(args, dev, keep: dict = None) -> list:
    """The weak-scaling records of ``args.scheme`` over the group's device
    counts; with ``keep``, each d's sharded and single-device outputs too
    (``keep[d] = (sharded, single)``, whole tensors on every rank)."""
    counts = [d for d in DEVICE_COUNTS if d <= dist.get_world_size()]
    results = []
    with torch.no_grad():
        for d in counts:
            case = build_case(args, d, dev)
            if keep is not None:
                keep[d] = (_whole(case.sharded()), case.single())
            t = slowest_seconds(case.sharded, dev, args.runs)
            t1 = results[0]["seconds"] if results else t
            rec = {"devices": d, "seconds": t,
                   "weak_scaling_efficiency": t1 / t}
            if args.scheme in ("column", "overlapped"):
                rec.update(N=case.N, host_normalized_efficiency=d * t1 / t)
            else:
                rec.update(schedule_bound=case.bound,
                           shared_host_efficiency=(d * t1 / case.bound) / t)
            results.append(rec)
            if dist.get_rank() == 0:
                print(json.dumps(rec), flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.scaling_bench")
    p.add_argument("--n-per-device", type=int, default=8192)
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--K", type=int, default=1024)
    p.add_argument("--s", type=int, default=4)
    p.add_argument("--scheme", default="overlapped",
                   choices=["column", "overlapped", "pipeline", "moe"])
    p.add_argument("--format", dest="fmt", default="BlockPackedTernary")
    p.add_argument("--kernel", default=None)
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.parallel import init_distributed
    from ternary_spgemm_tpu_torch.tools import (
        card_line, free_port, write_json)
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    own = not dist.is_initialized()
    if own:
        init_distributed(0, 1, f"tcp://127.0.0.1:{free_port()}", dev.type)
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        results = scale(args, dev)
    finally:
        if own:
            dist.destroy_process_group()
    if own or dist.get_rank() == 0:
        out = {"config": vars(args), "device": device_name(args.device),
               "card": card_line(dev), "results": results}
        if args.output:
            write_json(args.output, out)
        print(json.dumps({"scaling_bench": {
            "scheme": args.scheme,
            "ms": {r["devices"]: r["seconds"] * 1e3 for r in results},
            "efficiency": {r["devices"]: r["weak_scaling_efficiency"]
                           for r in results}},
            "device": out["device"], "card": out["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
