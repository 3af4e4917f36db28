"""Where do the ELL deposit kernel's bytes and time go? — counterpart of
``tools/deposit_study.py``.

Part A, :func:`bytes_audit` (host arithmetic on the containers): the stored
bits a weight of ``TiledEllDeposit`` against the 8/s ideal and the 2-bit
bitplane flagship, with the cap statistics that explain the gap (slots pad
to the largest count of any word in a (superblock, tile)). The containers
are byte-identical to the JAX package's, so its rows equal the JAX tool's.

Part B, :func:`time_ladder`: the deposit kernel with parts removed, on the
card (``csrc/deposit_variant.cu``, the variants of ``csrc/ell_core.cuh``).
``CudaEllDeposit_i8`` gathers staged X at each slot's offset and deposits
no bits, so the ladder removes what the H100 kernel does (each mode names
the JAX mode it stands in for, :data:`MODES`):

* ``full`` — the registered kernel's work, loops to the per-tile caps,
  each warp stopping once all its lanes read the sentinel;
* ``staticcap`` — loops to the global ``cap_p_max`` / ``cap_n_max`` with
  no early exit, the extra sentinel slots adding 0;
* ``nogather`` — slot bytes copied, loaded and consumed, X read
  lane-contiguously: no random-offset bank conflicts; loops to the
  per-tile caps with no early exit;
* ``noslots`` — no slot copies or loads, only the staging of X and the
  adds of the walk to the per-tile caps.

``full`` and ``staticcap`` compute ``Y = i8(X) . W + b`` and must be exact
against ``reference.dense_gemm``. The attribution modes compute, for column
``c`` of tile ``g`` and lane ``l = c % 32`` (:func:`deposit_variant_plain`)::

    Y[m, c] = sum_sb (cap_pos[sb, g] - cap_neg[sb, g])
                     * sum_w i8(X)[m, 248 sb + 31 w + l]  (0 for l = 31)
              [+ the sum of the slot bytes the loops walk, nogather]  + b[c]

The flagship ``CudaTiledBitplane_i8`` on the same matrix anchors each
config, as a user calls it: at the ladder's M = 32 its tensor-core branch
(above ``ops.cuda_kernels.I8_MMA_MIN_M`` rows), which each row names
(``flagship_branch``). Bytes a second come from the card's measured memory
rate.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.deposit_study [--bytes-only]
        [--repeats 3] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ternary_spgemm_tpu_torch import reference
from ternary_spgemm_tpu_torch.bench import measure_hbm_bandwidth
from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.formats import (
    TiledBitplane,
    TiledEllDeposit,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu_torch.formats.ell_deposit import (
    SB_ROWS,
    WORD_ROWS,
    WORDS,
)
from ternary_spgemm_tpu_torch.ops import _build, get_kernel
from ternary_spgemm_tpu_torch.ops.api import finish, matmul_plain, to_i8
from ternary_spgemm_tpu_torch.ops.cuda_kernels import (
    check_ell_deposit,
    check_f32,
    i8_branch,
    launches,
    note_plain,
    stream_handle,
)
from ternary_spgemm_tpu_torch.tools import emit, timer
from ternary_spgemm_tpu_torch.utils import cdiv
from ternary_spgemm_tpu_torch.utils.device import resolve_device

KERNEL_NAME = "deposit_variant"
SOURCE = "ternary_spgemm_tpu_torch/csrc/deposit_variant.cu"
REFERENCE = "tools/deposit_study.py:144"
#: the ladder's modes -> the JAX mode each stands in for
MODES = {"full": "full", "staticcap": "staticcap", "nogather": "nodeposit",
         "noslots": "nodecode"}
_MODE_IDS = {m: i for i, m in enumerate(MODES)}
FLAGSHIP = "CudaTiledBitplane_i8"
#: the JAX tool's configs (``tools/deposit_study.py:269-276``)
AUDIT_CONFIGS = [(1024, 4096), (4096, 16384), (16384, 4096)]
LADDER_CONFIGS = [(32, 16384, 4096, 16), (32, 4096, 16384, 16),
                  (32, 1024, 4096, 4)]


def bytes_audit(configs, s_values=(2, 4, 8, 16), device="cpu"):
    """Part A: stored bits a weight of TiledEllDeposit against the 8/s ideal
    and the flagship, plus the cap statistics (the JAX tool's rows; the
    containers are packed on ``device``)."""
    rows = []
    for K, N in configs:
        for s in s_values:
            W = torch.from_numpy(generate_ternary(K, N, s, seed=7)).to(device)
            dep = TiledEllDeposit.from_dense(W)
            kn = K * N
            row = {
                "K": K, "N": N, "s": s,
                "ideal_bits_per_weight": 8.0 / s,
                "deposit_bits_per_weight": 8.0 * dep.size_bytes() / kn,
                "flagship_bits_per_weight":
                    8.0 * TiledBitplane.from_dense(W).size_bytes() / kn,
                "cap_p_max": int(dep.cap_p_max),
                "cap_p_mean": float(dep.cap_pos.double().mean()),
                "cap_n_max": int(dep.cap_neg.max()),
                "pad_inflation": 8.0 * dep.size_bytes() / kn / (8.0 / s),
            }
            rows.append(row)
            print(f"K={K} N={N} s={s}: deposit "
                  f"{row['deposit_bits_per_weight']:.2f} b/wt (ideal "
                  f"{row['ideal_bits_per_weight']:.2f}, "
                  f"x{row['pad_inflation']:.1f} padding) vs flagship "
                  f"{row['flagship_bits_per_weight']:.2f}", flush=True)
    return rows


def _fixed_part(Xi: torch.Tensor, fmt: TiledEllDeposit) -> torch.Tensor:
    """``sum_sb (cap_pos - cap_neg)[sb, g] * sum_w Xi[m, 248 sb + 31 w + l]``
    (``l = c % 32``; 0 for l = 31) -> (M, N) f64, exact."""
    M, K = Xi.shape
    nsb = cdiv(K, SB_ROWS)
    xp = torch.zeros((M, nsb * SB_ROWS), dtype=torch.float64,
                     device=Xi.device)
    xp[:, :K] = Xi
    G = torch.zeros((M, nsb, 32), dtype=torch.float64, device=Xi.device)
    G[:, :, :WORD_ROWS] = xp.view(M, nsb, WORDS, WORD_ROWS).sum(dim=2)
    cols = torch.arange(fmt.N, device=Xi.device)
    capd = (fmt.cap_pos - fmt.cap_neg).to(torch.float64)[:, cols // fmt.tile_n]
    return torch.einsum("mkn,kn->mn", G[:, :, cols % 32], capd)


def _slot_sum(fmt: TiledEllDeposit) -> torch.Tensor:
    """The sum of the slot bytes the dynamic-cap loops walk, a column ->
    (N,) f64."""
    nsb, gn, R, tn = fmt.plane.shape
    r = torch.arange(R, device=fmt.plane.device)
    split = WORDS * fmt.cap_p_max
    live = (r < WORDS * fmt.cap_pos[..., None]) | (
        (r >= split) & (r - split < WORDS * fmt.cap_neg[..., None]))
    s = (fmt.plane.to(torch.float64) * live[..., None]).sum(dim=(0, 2))
    return s.reshape(-1)[:fmt.N]


def deposit_variant_plain(X, fmt: TiledEllDeposit, bias, *,
                          mode: str) -> torch.Tensor:
    """The plain version of each mode's function (module docstring)."""
    note_plain(KERNEL_NAME, X)
    Xi = to_i8(X)
    if mode in ("full", "staticcap"):
        return finish(matmul_plain(Xi, fmt), bias)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {list(MODES)}, got {mode!r}")
    y = _fixed_part(Xi.to(torch.float64), fmt)
    if mode == "nogather":
        y = y + _slot_sum(fmt)[None, :]
    return finish(y.to(torch.float32), bias)


def deposit_variant_launch(X, fmt: TiledEllDeposit, bias, *,
                           mode: str) -> torch.Tensor:
    """One launch of the ladder's kernel in ``mode`` on CUDA tensors."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {list(MODES)}, got {mode!r}")
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL_NAME} runs on CUDA tensors (CPU tensors "
                         f"take the plain version); got a tensor on {dev}")
    if X.dim() != 2:
        raise ValueError(f"X must be 2-D (M, K), got {tuple(X.shape)}")
    M, K, N = X.shape[0], fmt.K, fmt.N
    check_f32(X, (M, K), dev, f"{KERNEL_NAME}: X")
    check_f32(bias, (N,), dev, f"{KERNEL_NAME}: bias")
    plane, neg, cap_pos, cap_neg = check_ell_deposit(fmt, dev)
    nsb, gn, rows = plane.shape[0], plane.shape[1], plane.shape[2]
    Y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return Y
    err = _build.load().ternary_deposit_variant(
        X.data_ptr(), M, K, plane.data_ptr(), neg.data_ptr(),
        cap_pos.data_ptr(), cap_neg.data_ptr(), nsb, gn, rows, fmt.tile_n,
        WORDS * fmt.cap_p_max, WORDS * fmt.cap_n_max, N, bias.data_ptr(),
        Y.data_ptr(), _MODE_IDS[mode], stream_handle(dev))
    _build.check(err, "ternary_deposit_variant")
    launches[KERNEL_NAME] += 1
    return Y


def deposit_variant(X, fmt: TiledEllDeposit, bias, *, mode: str):
    """The ladder's function in ``mode``: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    if X.device.type == "cpu":
        return deposit_variant_plain(X, fmt, bias, mode=mode)
    return deposit_variant_launch(X, fmt, bias, mode=mode)


def time_ladder(configs, dev, *, repeats: int = 3, beta: float = None):
    """Part B: the ladder and the flagship anchor at each config
    (``bench.timing``'s timer for ``dev``: median of ``repeats`` CUDA-event
    estimates with the L2 evicted on the card, the plain versions' host
    time on the CPU)."""
    flag = get_kernel(FLAGSHIP)
    out = []

    def timed(fn, X, aux):
        t = timer(dev)(fn, X, aux=aux, repeats=repeats)
        return {"us": t.seconds * 1e6, "spread": t.seconds_spread}

    for M, K, N, s in configs:
        W = torch.from_numpy(generate_ternary(K, N, s, seed=7)).to(dev)
        dep = TiledEllDeposit.from_dense(W)
        bpf = TiledBitplane.from_dense(W)
        X = torch.from_numpy(generate_x(M, K, seed=1)).to(dev)
        bias = torch.from_numpy(generate_bias(N)).to(dev)
        want = reference.dense_gemm(X, W, bias)
        row = {"M": M, "K": K, "N": N, "s": s,
               "deposit_bytes": dep.size_bytes(),
               "flagship_bytes": bpf.size_bytes(),
               "flagship_branch": i8_branch(M, dev),
               "deposit_dma_ideal_us": None, "flagship_dma_ideal_us": None,
               "stands_in_for": dict(MODES), "times_us": {}, "correct": {}}
        if beta:
            row["deposit_dma_ideal_us"] = dep.size_bytes() / beta * 1e6
            row["flagship_dma_ideal_us"] = bpf.size_bytes() / beta * 1e6
        for mode in MODES:
            if mode in ("full", "staticcap"):
                got = deposit_variant(X, dep, bias, mode=mode)
                row["correct"][mode] = bool(
                    reference.compare_results(got, want))
            row["times_us"][mode] = timed(
                lambda x, f, b, m=mode: deposit_variant(x, f, b, mode=m),
                X, (dep, bias))
            print(f"{M}x{K}x{N} s={s} {mode} (for JAX's {MODES[mode]}): "
                  f"{row['times_us'][mode]['us']:.2f} us (spread "
                  f"{row['times_us'][mode]['spread']:.1%})", flush=True)
        row["times_us"]["flagship"] = timed(flag.fn, X, (bpf, bias))
        print(f"{M}x{K}x{N} s={s} flagship: "
              f"{row['times_us']['flagship']['us']:.2f} us", flush=True)
        out.append(row)
        del W, dep, bpf
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.deposit_study")
    p.add_argument("--bytes-only", action="store_true")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    result = {"device": device_name(dev),
              "bytes_audit": bytes_audit(AUDIT_CONFIGS, device=dev)}
    ok = True
    if not args.bytes_only:
        beta = measure_hbm_bandwidth(device=dev) if dev.type == "cuda" \
            else None
        result["beta_GBps"] = beta / 1e9 if beta else None
        result["ladder"] = time_ladder(LADDER_CONFIGS, dev,
                                       repeats=args.repeats, beta=beta)
        ok = all(all(r["correct"].values()) for r in result["ladder"])
    emit(result, args.out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
