#!/usr/bin/env python
"""Quickstart: build a ternary container, run a SpMM kernel, verify —
the PyTorch + CUDA port's twin of ``examples/01_spmm_quickstart.py``.

The core operation the framework computes (reference
``cpp_impl/comp.h:37-68``):

    Y[M, N] = X[M, K] @ W[K, N] + b[N],   W in {-1, 0, +1}

Run:  python examples_torch/01_spmm_quickstart.py [--device cpu]
(the card by default; ``--device cpu`` runs the kernels' plain versions).
"""

import argparse
import os
import sys

# location-independent: the examples run against the in-repo package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cuda' (default, the card) or 'cpu'")
args = parser.parse_args()

import torch  # noqa: E402

from ternary_spgemm_tpu_torch import reference  # noqa: E402
from ternary_spgemm_tpu_torch.formats import (  # noqa: E402
    TCSC, TiledBitplane, generate)
from ternary_spgemm_tpu_torch.ops import ternary_spgemm  # noqa: E402
from ternary_spgemm_tpu_torch.utils.device import resolve_device  # noqa: E402

dev = resolve_device(args.device)
M, K, N, s = 32, 1024, 4096, 4          # the reference's north-star config

# 1. A random ternary weight matrix at density 1/s (the reference
#    generator's semantics, sparseUtils.h:26-90; seeded here).
W = torch.from_numpy(generate.generate_ternary(K, N, s, seed=0)).to(dev)
X = torch.from_numpy(generate.generate_x(M, K, seed=1)).to(dev)
b = torch.from_numpy(generate.generate_bias(N)).to(dev)

# 2. Pick a container. TCSC is the reference's central format (TCSC.h:5-50);
#    TiledBitplane is the serving format (2 bits a weight, a tensor-core
#    or streaming decode kernel).
tcsc = TCSC.from_dense(W)
bitp = TiledBitplane.from_dense(W)
print(f"dense W:        {W.numel() / 1e6:.2f} MB (int8)")
print(f"TCSC:           {tcsc.size_bytes() / 1e6:.2f} MB")
print(f"TiledBitplane:  {bitp.size_bytes() / 1e6:.2f} MB")

# 3. Multiply. Dispatch picks a safe exact kernel for the container;
#    kernel= selects one, kernel="auto" measures and memoizes.
y_tcsc = ternary_spgemm(X, tcsc, b)
y_bitp = ternary_spgemm(X, bitp, b, kernel="CudaTiledBitplane_i8")

# 4. Verify against the dense reference (tolerance 1e-5, sparseUtils.h:147).
want = reference.dense_gemm(X, W.to(torch.float32), b)
for name, got in [("TCSC", y_tcsc), ("TiledBitplane", y_bitp)]:
    res = reference.compare_results(got, want)
    print(f"{name:14s} correct={res.ok} max_abs_err={res.max_abs_err:.2e}")
    assert res.ok
