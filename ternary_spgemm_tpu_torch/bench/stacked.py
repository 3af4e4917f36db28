"""Stacked-regime marginal cost — counterpart of
``ternary_spgemm_tpu/bench/stacked.py``.

A served model runs L layers back to back, so the per-layer number that
matters there is the marginal cost of one more layer in the chain:
``(t(L2) - t(L1)) / (L2 - L1)`` cancels every fixed cost of the chain.
Here each chain is a stack of L ``CudaTiledBitplane_i8`` layers with the
glue ``clamp(y[:, :K], -512, 512)`` between them (the integer clip keeps
the next layer's X in the kernel's exact domain); on the card it is timed
as one CUDA graph (``bench.timing.time_cuda_graph``: one replay carries the
whole chain, the counterpart of JAX's one jitted L-layer program), on the
CPU on the host clock. ``bench.headline`` emits the result as the
``stacked_*`` keys of its JSON line.

The JAX function passes ``tns=N`` (full-width tiles) to its Pallas kernel,
which fails for N > 4096 (ROADMAP's reference faults); the CUDA kernels
take no tile argument and run at the container's storage tile.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def make_chain(spec, fmts: Sequence, biases: Sequence, K: int):
    """The chained stack ``x -> y``: layer i runs ``spec`` on ``fmts[i]``
    and ``biases[i]``, and the next layer takes ``clamp(y[:, :K], -512,
    512)`` (the glue between layers; the integer clip keeps X in the i8
    kernels' exact domain). Returns the last layer's y."""
    def fn(x):
        cur, y = x, None
        for fmt, b in zip(fmts, biases):
            y = spec.fn(cur, fmt, b, None)
            cur = torch.clamp(y[:, :K], -512.0, 512.0)
        return y
    return fn


def measure_stacked_marginal(M: int = 32, K: int = 1024, N: int = 4096,
                             s: int = 4, *,
                             kernel: str = "CudaTiledBitplane_i8",
                             depths: Sequence[int] = (8, 16),
                             repeats: int = 3,
                             bandwidth: Optional[float] = None,
                             device="cuda") -> dict:
    """Measure the chained stack marginal at the given config, the weights
    of layer i ``generate_ternary(K, N, s, seed=300 + i)`` as in the JAX
    package. Returns ``{stacked_marginal_seconds, stacked_spread,
    stacked_depths, stacked_gflops, stacked_roofline_fraction,
    stacked_kernel, stacked_rows}``; the roofline fraction divides the
    kernel's own-bytes ideal time by the marginal (None on the CPU, which
    has no device bandwidth to hold it to), and the GFLOP/s are None unless
    the marginal is positive."""
    from ternary_spgemm_tpu_torch.bench.instrument import (
        advertised_hbm_bandwidth, instrument, own_roofline_fraction)
    from ternary_spgemm_tpu_torch.bench.timing import (
        time_cuda_graph, time_wall)
    from ternary_spgemm_tpu_torch.formats import (
        TiledBitplane, generate_bias, generate_ternary, generate_x)
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    spec = all_kernels()[kernel]
    if spec.format_cls is not TiledBitplane:
        raise ValueError("the stacked protocol is defined for the "
                         f"TiledBitplane family, got {kernel}")
    if N < K:
        raise ValueError(f"the chain feeds y[:, :K] on: N={N} < K={K}")
    fmts, biases = [], []
    for i in range(max(depths)):
        fmts.append(TiledBitplane.from_dense(
            generate_ternary(K, N, s, seed=300 + i), device=dev))
        biases.append(torch.from_numpy(generate_bias(N)).to(dev))
    X = torch.from_numpy(generate_x(M, K, seed=1)).to(dev)

    timer = time_cuda_graph if dev.type == "cuda" else time_wall
    rows = {L: timer(make_chain(spec, fmts[:L], biases[:L], K), X,
                     repeats=repeats) for L in depths}
    L1, L2 = min(depths), max(depths)
    marginal = (rows[L2].seconds - rows[L1].seconds) / (L2 - L1)
    # the pairwise difference's spread, propagated conservatively
    spread = (rows[L2].seconds * rows[L2].seconds_spread
              + rows[L1].seconds * rows[L1].seconds_spread) / max(
        rows[L2].seconds - rows[L1].seconds, 1e-30)
    inst = instrument(M, fmts[0], x_bytes=spec.x_bytes)
    beta = bandwidth
    if beta is None and dev.type == "cuda":
        beta = advertised_hbm_bandwidth(dev)
    flops = M * N * (1 + K / s)
    positive = marginal > 0
    return {
        "stacked_marginal_seconds": marginal,
        "stacked_spread": round(float(spread), 4),
        "stacked_depths": [int(L1), int(L2)],
        "stacked_gflops": (round(flops / marginal / 1e9, 3) if positive
                           else None),
        "stacked_roofline_fraction": (
            round(own_roofline_fraction(inst, marginal, beta), 4)
            if positive and beta is not None else None),
        "stacked_kernel": kernel,
        "stacked_rows": {str(L): {"seconds": rows[L].seconds,
                                  "seconds_spread": rows[L].seconds_spread,
                                  "n_estimates": rows[L].n_estimates}
                         for L in depths},
    }
