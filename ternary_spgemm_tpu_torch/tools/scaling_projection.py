"""Weak-scaling projection of the ring-overlapped sharded SpMM across H100
cards — counterpart of the repository's ``tools/scaling_projection.py``.

BASELINE's multi-host configuration (N = 65536 = 8 shards of 8192
columns, >= 80% weak-scaling efficiency) needs more cards than one
machine of this repository's card holds. This tool projects it from a
measured shard time and named link assumptions that a run on more cards
can check line by line:

* **Measured** — ``CudaTiledBitplane_i8`` on one 1024 x 8192 column shard
  at chunk rows 4-256 (the ring's M / d rows a step), on the card
  (``tools.timer``: CUDA events, L2 evicted).
* **Assumed** — :data:`ASSUMPTIONS`: NVLink 4 inside a host, 450 GB/s a
  direction a card (NVIDIA H100 SXM data sheet: 900 GB/s bidirectional);
  between hosts one 400 Gb/s InfiniBand NDR NIC a card (NVIDIA DGX H100
  user guide: eight ConnectX-7 at 400 Gb/s), 50 GB/s, swept derated at
  12.5, 25 and 50 GB/s as the JAX tool sweeps its data-centre network; a
  step's time the max of its compute and its slowest edge's transfer.

The formulas are the JAX tool's (``tools/scaling_projection.py:99-128``):
the flat ring, whose every step every edge carries one chunk, the slowest
edge gating the step; and the hierarchical ring (an intra-host ring per
phase, the next M/h rows crossing hosts once a phase, overlapped with
it). The JAX tool's TPU ICI and DCN figures are replaced by the H100
links above.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.scaling_projection
        [--output PATH] [--repeats 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

#: Named link assumptions (GB/s), each with its public source.
ASSUMPTIONS = {
    "nvlink_GBps": 450.0,
    "nvlink_source": "NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s "
                     "bidirectional a card, so 450 GB/s a direction",
    "inter_host_GBps": 50.0,
    "inter_host_sweep_GBps": [12.5, 25.0, 50.0],
    "inter_host_source": "NVIDIA DGX H100: one ConnectX-7 400 Gb/s "
                         "InfiniBand NDR NIC a card, 50 GB/s; swept "
                         "derated",
    "overlap_model": "per-step time = max(compute_chunk, slowest-edge comm)",
    "fill_model": "(d-1) extra chunk-comm for ring fill/drain",
}
K, N_SHARD, S = 1024, 8192, 4
N_TOTAL = 65536
CHUNK_ROWS = [4, 8, 16, 32, 64, 128, 256]
#: (devices, hosts) and M of the projections
LAYOUTS = [(8, 1), (8, 2), (8, 4)]
PROJECTED_M = (64, 256, 1024)


def project(t_chunk_us: dict, assumptions: dict = ASSUMPTIONS) -> list:
    """The flat and hierarchical rings' projected efficiencies from the
    measured shard times ``{chunk rows: us}`` (the JAX tool's formulas)."""
    link = assumptions["nvlink_GBps"] * 1e9
    rows_measured = sorted(t_chunk_us)

    def tc_for(m_chunk):
        # the measured time of the smallest measured chunk that holds it
        m_eff = max(m_chunk, rows_measured[0])
        return t_chunk_us[min(c for c in rows_measured if c >= m_eff)] / 1e6

    rows = []
    for d, hosts in LAYOUTS:
        for M in PROJECTED_M:
            for host_gbps in assumptions["inter_host_sweep_GBps"]:
                if hosts == 1 and host_gbps != \
                        assumptions["inter_host_sweep_GBps"][0]:
                    continue   # no link between hosts on one host
                cross = host_gbps * 1e9
                m_chunk = M // d
                tc = tc_for(m_chunk)
                chunk_bytes = m_chunk * K * 4
                t_link = chunk_bytes / link
                t_cross = chunk_bytes / cross if hosts > 1 else t_link
                ideal = d * tc
                flat = d * max(tc, t_cross) + (d - 1) * t_cross
                phase_c = (d // hosts) * max(tc, t_link)
                t_block = (M // hosts) * K * 4 / cross if hosts > 1 else 0
                hier = hosts * max(phase_c, t_block) + t_block
                for scheme, proj in (("flat_ring", flat),
                                     ("hierarchical", hier)):
                    eff = ideal / proj
                    rows.append({
                        "scheme": scheme, "devices": d, "hosts": hosts,
                        "M": M, "inter_host_GBps": host_gbps,
                        "rows_per_chunk": m_chunk,
                        "compute_chunk_us": tc * 1e6,
                        "projected_total_us": proj * 1e6,
                        "projected_weak_scaling_efficiency": round(eff, 4),
                        "meets_baseline_80pct": bool(eff >= 0.80)})
    return rows


def headline(rows: list):
    """The row the JAX tool headlines: hierarchical, 2 hosts, M = 256, the
    middle of the inter-host sweep."""
    return next((r for r in rows if r["scheme"] == "hierarchical"
                 and r["hosts"] == 2 and r["M"] == 256
                 and r["inter_host_GBps"] == 25.0), None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.scaling_projection")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.formats import (
        TiledBitplane, generate_bias, generate_ternary, generate_x)
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.tools import card_line, timer, write_json
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    spec = all_kernels()["CudaTiledBitplane_i8"]
    fmt = TiledBitplane.from_dense(generate_ternary(K, N_SHARD, S, seed=3),
                                   device=dev)
    bias = torch.from_numpy(generate_bias(N_SHARD)).to(dev)
    measured = {}
    for m in CHUNK_ROWS:
        X = torch.from_numpy(generate_x(m, K, seed=1)).to(dev)
        r = timer(dev)(lambda x: spec.fn(x, fmt, bias, None), X,
                       repeats=args.repeats)
        measured[m] = {"us": r.seconds * 1e6, "spread": r.seconds_spread}
        print(f"shard kernel M={m} x {K} x {N_SHARD}: {r.seconds * 1e6:.2f} "
              f"us (spread {r.seconds_spread:.1%})", flush=True)
    rows = project({m: v["us"] for m, v in measured.items()})
    out = {"config": {"K": K, "N_total": N_TOTAL, "N_shard": N_SHARD,
                      "s": S, "kernel": spec.name},
           "device": device_name(args.device), "card": card_line(dev),
           "assumptions": ASSUMPTIONS, "measured_chunk_times": measured,
           "projections": rows, "headline": headline(rows)}
    if args.output:
        write_json(args.output, out)
    print(json.dumps({"scaling_projection": out["headline"],
                      "chunk_us": {m: v["us"] for m, v in measured.items()},
                      "meets_80pct": sum(r["meets_baseline_80pct"]
                                         for r in rows),
                      "rows": len(rows), "device": out["device"],
                      "card": out["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
