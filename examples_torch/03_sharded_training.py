#!/usr/bin/env python
"""SPMD training of a ternary transformer LM over a device mesh — the
PyTorch + CUDA port's twin of ``examples/03_sharded_training.py``.

A data x model (dp x tp) mesh on ``torch.distributed``: on the card one
NCCL rank a card (``--devices``, default every visible card), or with
``--device cpu`` ``--devices`` gloo processes on this host. Each rank is a
process of its own (one rank runs in this process); the group meets on a
free ``127.0.0.1`` port, and the script exits 0 only when every rank does.

Knobs shown (``models/train.py``):
  * Megatron tensor parallelism (alternating column/row sharded BitLinears)
  * sequence parallelism — activations T-sharded over the TP axis
  * ZeRO-1 — optimizer moments sharded over the dp axis
  * per-block remat — activations recomputed in the backward

Run:  python examples_torch/03_sharded_training.py [--device cpu --devices 8]
"""

import argparse
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
parser.add_argument("--devices", type=int, default=0,
                    help="ranks (default: the visible cards; 8 on the CPU)")
parser.add_argument("--steps", type=int, default=5)
parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
parser.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
args = parser.parse_args()

import torch  # noqa: E402


def mesh_shape(n: int) -> dict:
    """The dp x tp mesh of ``n`` ranks: TP over 4 where 4 divides ``n``
    (the JAX example's 2 x 4 on 8), else over 2 or 1."""
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return {"data": n // model, "model": model}


def run_rank(rank: int, world: int, port: int) -> None:
    from ternary_spgemm_tpu_torch.models import (
        BitTransformerConfig, BitTransformerLM, make_sharded_lm_train_step)
    from ternary_spgemm_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(rank, world, f"tcp://127.0.0.1:{port}", args.device)
    try:
        mesh = make_mesh(mesh_shape(world), device_type=args.device)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if args.device == "cuda" else torch.device("cpu"))
        if rank == 0:
            print(f"mesh: {mesh_shape(world)} on {args.device}", flush=True)
        cfg = BitTransformerConfig(vocab=256, d_model=128, n_heads=4,
                                   d_ff=256, n_layers=2, remat=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = BitTransformerLM(cfg, generator=gen, device=dev)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, foreach=False)
        step, place = make_sharded_lm_train_step(
            model, opt, mesh, sequence_parallel=True, zero1=True)
        tokens = place(torch.randint(0, cfg.vocab, (16, 64), generator=gen,
                                     device=dev))
        for i in range(args.steps):
            loss = float(step(tokens))
            if rank == 0:
                print(f"step {i}: loss {loss:.4f}", flush=True)
        # where a TP-sharded weight lives
        wq = model.blocks[0].wq.w
        if rank == 0:
            print(f"wq placements: {wq.placements}, per-rank shard "
                  f"{tuple(wq.to_local().shape)} of global "
                  f"{tuple(wq.shape)}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if args.rank is not None:
    run_rank(args.rank, args.devices, args.port)
    sys.exit(0)

from ternary_spgemm_tpu_torch.utils.device import resolve_device  # noqa: E402

resolve_device(args.device)
world = args.devices or (torch.cuda.device_count() if args.device == "cuda"
                         else 8)
port = free_port()
if world == 1:
    run_rank(0, 1, port)
    sys.exit(0)
env = dict(os.environ, OMP_NUM_THREADS="1")
procs = [subprocess.Popen(
    [sys.executable, os.path.abspath(__file__), "--device", args.device,
     "--devices", str(world), "--steps", str(args.steps), "--rank", str(r),
     "--port", str(port)], env=env) for r in range(world)]
# a rank that fails leaves the others waiting in a collective: stop them
while any(p.poll() is None for p in procs):
    if any(p.poll() not in (None, 0) for p in procs):
        for p in procs:
            p.kill()
    time.sleep(0.2)
codes = [p.wait() for p in procs]
if any(codes):
    print(f"ranks exited {codes}", file=sys.stderr)
    sys.exit(1)
