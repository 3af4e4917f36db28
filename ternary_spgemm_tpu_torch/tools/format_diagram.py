"""Container-layout figures from the port's packers — counterpart of the
repository's ``tools/format_diagram.py`` (the reference's hand-drawn
``plots/data_example_image``).

A small ternary matrix is packed by the port's own ``from_dense`` on
``--device`` and the arrays it holds are drawn (matplotlib, ``Agg``), so
the figures cannot drift from the layouts:

    tcsc_structure.png          split-sign TCSC streams
    bitplane_structure.png      TiledBitplane pos / neg bit planes
    blocked_tcsc_structure.png  BlockedTCSC's per-K-block column pointers
    ell_deposit_structure.png   TiledEllDeposit's offset slots

The packing runs on the card by default (raising without one); the
drawing is host code, so the tool needs matplotlib, which the card's
machine lacks: run it with ``--device cpu`` where matplotlib is.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.format_diagram --outdir DIR
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

POS, NEG, ZERO = "#f4a6a6", "#a9c6ea", "#f2f2f2"
CELL = 1.0


def _grid(ax, data, x0, y0, color_fn, fmt=str, cell=CELL, fs=9):
    from matplotlib.patches import Rectangle
    data = np.atleast_2d(np.asarray(data))
    for r in range(data.shape[0]):
        for c in range(data.shape[1]):
            v = data[r, c]
            ax.add_patch(Rectangle((x0 + c * cell, y0 - (r + 1) * cell),
                                   cell, cell, facecolor=color_fn(v),
                                   edgecolor="black", linewidth=0.8))
            ax.text(x0 + (c + 0.5) * cell, y0 - (r + 0.5) * cell, fmt(v),
                    ha="center", va="center", fontsize=fs)
    return data.shape


def host(fmt):
    """``fmt``'s arrays as numpy, by field name, and its int fields."""
    return types.SimpleNamespace(**{
        k: (v.cpu().numpy() if hasattr(v, "cpu") else v)
        for k, v in vars(fmt).items()})


def _tern_color(v):
    return POS if v > 0 else NEG if v < 0 else ZERO


def draw_tcsc(outdir: str, dev) -> str:
    """Split-sign TCSC streams of a real 6x6 example (TCSC.h:41-48)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ternary_spgemm_tpu_torch.formats import TCSC, generate_ternary

    W = generate_ternary(6, 6, 2, seed=7)
    f = host(TCSC.from_dense(W, device=dev))
    fig, ax = plt.subplots(figsize=(11, 7))
    _grid(ax, W, 0, 0, _tern_color)
    ax.text(3, 0.6, "W (ternary, K x N)", ha="center", fontsize=11)
    rows = [("col_start_pos (CSP)", f.col_start_pos, POS),
            ("row_index_pos (RIP)", f.row_index_pos, POS),
            ("col_start_neg (CSN)", f.col_start_neg, NEG),
            ("row_index_neg (RIN)", f.row_index_neg, NEG)]
    y = -7.5
    for label, arr, color in rows:
        _grid(ax, arr, 0, y, lambda v, c=color: c)
        ax.text(len(arr) * CELL + 0.4, y - 0.5, label, va="center",
                fontsize=10)
        y -= 1.6
    ax.set_xlim(-0.5, 14); ax.set_ylim(y - 0.5, 1.2)
    ax.set_aspect("equal"); ax.axis("off")
    path = os.path.join(outdir, "tcsc_structure.png")
    fig.savefig(path, dpi=120, bbox_inches="tight"); plt.close(fig)
    return path


def draw_bitplane(outdir: str, dev) -> str:
    """TiledBitplane: dense rows -> pos / neg bit planes
    (``formats/bitplane.py``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ternary_spgemm_tpu_torch.formats import (
        TiledBitplane, generate_ternary)

    W = generate_ternary(8, 8, 2, seed=3)          # one block: tkb=1, B=8 rows
    f = host(TiledBitplane.from_dense(W, tkb=1, tile_n=128, device=dev))
    pos, neg = f.plane[0, 0, 0, :8], f.plane[0, 0, 1, :8]
    fig, ax = plt.subplots(figsize=(11, 6))
    _grid(ax, W, 0, 0, _tern_color)
    ax.text(4, 0.6, "W (one 8-row block, 8 cols shown)", ha="center",
            fontsize=11)
    _grid(ax, pos, 0, -9.2, lambda v: POS, fmt=lambda v: f"{v:08b}")
    ax.text(8.4, -9.7, "pos plane byte-row (bit j = row-j flag)",
            va="center", fontsize=10)
    _grid(ax, neg, 0, -10.8, lambda v: NEG, fmt=lambda v: f"{v:08b}")
    ax.text(8.4, -11.3, "neg plane byte-row", va="center", fontsize=10)
    _grid(ax, f.wsum[0, 0, 0, :8], 0, -12.4, lambda v: ZERO)
    ax.text(8.4, -12.9, "wsum (per-tile column sums, int32)",
            va="center", fontsize=10)
    ax.text(0, -14.0,
            "CUDA decode: a pos / neg byte pair -> four packed int8 "
            "weights\n(csrc/gemv_core.cuh ternary4), summed with __dp4a; "
            "above 32 rows\nthe planes decode to int8 tiles for mma.sync "
            "(csrc/bitplane_mma.cuh)", fontsize=9, va="top",
            family="monospace")
    ax.set_xlim(-0.5, 14); ax.set_ylim(-16.5, 1.2)
    ax.set_aspect("equal"); ax.axis("off")
    path = os.path.join(outdir, "bitplane_structure.png")
    fig.savefig(path, dpi=120, bbox_inches="tight"); plt.close(fig)
    return path


def draw_blocked(outdir: str, dev) -> str:
    """BlockedTCSC: per-K-block column pointers (BlockedTCSC.h:6-49 analogue,
    reference figure plots/data_example_image)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ternary_spgemm_tpu_torch.formats import BlockedTCSC, generate_ternary

    W = generate_ternary(8, 6, 2, seed=5)
    f = host(BlockedTCSC.from_dense(W, block_size=4, device=dev))  # 2 blocks
    fig, ax = plt.subplots(figsize=(11, 8))
    _grid(ax, W, 0, 0, _tern_color)
    ax.text(3, 0.6, "W (K=8 x N=6, two K-blocks of 4)", ha="center",
            fontsize=11)
    ax.plot([-0.3, 6.3], [-4, -4], color="black", linewidth=1.5,
            linestyle="--")
    rows = [("col_start_pos ((K/B)*N+1, block-major)", f.col_start_pos, POS),
            ("row_index_pos (global row ids)", f.row_index_pos, POS),
            ("col_start_neg", f.col_start_neg, NEG),
            ("row_index_neg", f.row_index_neg, NEG)]
    y = -9.5
    for label, arr, color in rows:
        _grid(ax, arr, 0, y, lambda v, c=color: c, fs=7)
        ax.text(len(arr) * CELL + 0.4, y - 0.5, label, va="center", fontsize=9)
        y -= 1.6
    ax.set_xlim(-0.5, 20); ax.set_ylim(y - 0.5, 1.2)
    ax.set_aspect("equal"); ax.axis("off")
    path = os.path.join(outdir, "blocked_tcsc_structure.png")
    fig.savefig(path, dpi=120, bbox_inches="tight"); plt.close(fig)
    return path


def draw_ell_deposit(outdir: str, dev) -> str:
    """TiledEllDeposit: per-slot local offsets feeding the bit-deposit decode
    (``formats/ell_deposit.py``; no analogue in the reference)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ternary_spgemm_tpu_torch.formats import (
        TiledEllDeposit, generate_ternary)

    W = generate_ternary(12, 6, 3, seed=11)
    f = host(TiledEllDeposit.from_dense(W, tile_n=128, device=dev))
    fig, ax = plt.subplots(figsize=(12, 9))
    _grid(ax, W, 0, 0, _tern_color)
    ax.text(3, 0.6, "W (K=12 x N=6; one superblock, all rows in word 0)",
            ha="center", fontsize=11)
    cp, cn = int(f.cap_pos[0, 0]), int(f.cap_neg[0, 0])
    dot = lambda v: "·" if v == 31 else str(v)
    # word 0 of each slot (rows 0..30 live there for K<=31; words 1-7 are
    # all-sentinel for this small example and are omitted)
    pos = f.plane[0, 0, 0:8 * cp:8, :6]
    neg = f.plane[0, 0, 8 * f.cap_p_max:8 * f.cap_p_max + 8 * cn:8, :6]
    y = -13.5
    _grid(ax, pos, 0, y, lambda v: POS, fmt=dot)
    ax.text(6.4, y - 0.5 * cp,
            f"pos offset slots (word 0 of each of {cp} slots;\n"
            "value = dense-row bit index deposited, · = sentinel 31)",
            va="center", fontsize=9)
    y -= cp + 1.2
    _grid(ax, neg, 0, y, lambda v: NEG, fmt=dot)
    ax.text(6.4, y - 0.5 * cn, f"neg offset slots ({cn})",
            va="center", fontsize=9)
    y -= cn + 1.4
    ax.text(0, y,
            "CUDA kernel (csrc/ell_core.cuh): each slot's offset picks the "
            "row of X\nits weight meets, its sign from the slot's section; "
            "\nsentinel 31 names a staged zero -> contributes 0",
            fontsize=9, va="top", family="monospace")
    ax.set_xlim(-0.5, 16); ax.set_ylim(y - 3.5, 1.2)
    ax.set_aspect("equal"); ax.axis("off")
    path = os.path.join(outdir, "ell_deposit_structure.png")
    fig.savefig(path, dpi=120, bbox_inches="tight"); plt.close(fig)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.format_diagram")
    p.add_argument("--outdir", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.tools import check_out
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(check_out(args.outdir), exist_ok=True)
    for fn in (draw_tcsc, draw_bitplane, draw_blocked, draw_ell_deposit):
        print(fn(args.outdir, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
