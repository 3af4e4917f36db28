"""The own-bytes model against what one call binds — counterpart of the
repository's ``tools/bytes_validation.py``.

For each kernel and shape:

* **model** — ``Instrumentation.own_bytes`` (``bench/instrument.py``): X at
  the kernel's ``x_bytes`` a element (4 for every CUDA kernel here: each
  reads the f32 X itself), the container, the f32 output and the bias;
* **bound** — what one call binds, measured by ``profiling.
  compiled_memory``: the argument tensors' bytes (X and the container; the
  bias is closed over, as in the JAX tool) plus the output's, and, apart,
  ``temp``: the peak the call allocated above them on the card (the x8 and
  i8 tensor-core branches' pre-pass stages X as int8 into a scratch before
  the product; the decode body's split-K parts sum into an int32 scratch).
  The CPU has no allocator to read: there ``temp`` is None.

The verdict is ``ok`` where ``|bound / (model with X at 4 bytes) - 1|
<= 0.10``, else ``explain``. The JAX tool's third column, XLA's
``bytes accessed`` (``profiling.hlo_cost``), has no counterpart: PyTorch
has no compiler whose cost model could be asked, and ``hlo_cost`` raises,
so every row carries ``hlo_bytes_accessed: null`` and the reason. A row
that raised is recorded with its error, and the tool then exits 1.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.bytes_validation
        [--output PATH] [--kernels a,b] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import datetime
import sys

import torch

#: the port's counterparts of the JAX tool's five kernels
KERNELS = ["CudaTiledBitplane_i8", "CudaTiledBitplane_x8",
           "CudaTiledDense_i8", "CudaTiledBitplane_bf16", "DenseMXU_bf16"]
#: (M, K, N, s): the north star, a large-M layer, the 7B up-projection's
#: widths square
SHAPES = [(32, 1024, 4096, 4), (512, 4096, 4096, 4), (32, 11008, 11008, 4)]
#: why the ``hlo_bytes_accessed`` column is null
NO_HLO = ("no counterpart: XLA's cost analysis of the compiled program; "
          "PyTorch has no such compiler (profiling.hlo_cost raises)")
TOLERANCE = 0.10


def validate(spec, M: int, K: int, N: int, s: int, W, dev) -> dict:
    """One row: ``spec`` at (M, K, N, s) over the dense ``W`` (on
    ``dev``)."""
    from ternary_spgemm_tpu_torch import profiling
    from ternary_spgemm_tpu_torch.bench.instrument import instrument
    from ternary_spgemm_tpu_torch.formats import generate_bias, generate_x

    X = torch.from_numpy(generate_x(M, K, seed=1)).to(dev)
    b = torch.from_numpy(generate_bias(N)).to(dev)
    fmt = spec.format_cls.from_dense(W)
    inst = instrument(M, fmt, x_bytes=spec.x_bytes)
    mem = profiling.compiled_memory(lambda x, f: spec.fn(x, f, b, None),
                                    X, fmt)
    bound = mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
    # the arguments hold the raw f32 X whatever width the kernel reads
    model_bind = inst.own_bytes + int((4 - spec.x_bytes) * M * K)
    ratio = bound / model_bind
    return {"kernel": spec.name, "M": M, "K": K, "N": N, "s": s,
            "model_own_bytes": inst.own_bytes,
            "model_bound_args_bytes": model_bind,
            "compiled_arg_plus_out_bytes": bound,
            "compiled_temp_bytes": mem.get("temp_size_in_bytes"),
            "hlo_bytes_accessed": None,
            "ratio_compiled_over_model": round(ratio, 4),
            "verdict": "ok" if abs(ratio - 1) <= TOLERANCE else "explain"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.bytes_validation")
    p.add_argument("--output", default=None)
    p.add_argument("--kernels", default=",".join(KERNELS))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.formats import generate_ternary
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.tools import card_line, emit, write_json
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    registry = all_kernels()
    rows = []
    for (M, K, N, s) in SHAPES:
        W = torch.from_numpy(generate_ternary(K, N, s, seed=0)).to(dev)
        for name in args.kernels.split(","):
            try:
                rows.append(validate(registry[name], M, K, N, s, W, dev))
            except Exception as e:  # record the row's failure, go on
                rows.append({"kernel": name, "M": M, "K": K, "N": N, "s": s,
                             "error": f"{type(e).__name__}: {e}"})
            print(rows[-1], flush=True)
        del W
    out = {"when": datetime.datetime.now(datetime.timezone.utc).isoformat(),
           "device": device_name(args.device), "card": card_line(dev),
           "hlo_bytes_accessed": NO_HLO,
           "methodology": __doc__.split("Usage:")[0], "rows": rows}
    if args.output:
        write_json(args.output, out)
    bad = [r for r in rows if r.get("verdict") == "explain" or "error" in r]
    emit({"bytes_validation": f"{len(rows) - len(bad)}/{len(rows)} rows "
          f"within {TOLERANCE:.0%}",
          "explain": [f"{r['kernel']} {r['M']}x{r['K']}x{r['N']}: "
                      + (r["error"] if "error" in r else
                         f"ratio {r['ratio_compiled_over_model']}, temp "
                         f"{r['compiled_temp_bytes']}") for r in bad]})
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
