"""nvcc option sets over ``csrc/`` — counterpart of the repository's
``tools/compiler_sweep.py`` (the reference's ``compiler_testing/
test.sh``, which sweeps g++ flag sets; the JAX tool sweeps XLA / libtpu
flags).

Each option set runs in a child process (``--child NAME``) that extends
``ops._build.NVCC_FLAGS`` by the set's flags before the kernel library
first loads. ``_build.library_path`` hashes the flags, so each set builds
and loads its own library under ``build/cuda/`` (the baseline's is the
library every other entry point loads). The child times the headline's
kernel set at the north star (``bench.harness.run_config``; the torch-op
formulations among them are no nvcc's and run as a control) and saves the
output of every hand-written kernel in it, and of the two fused FFNs at
decode and prefill rows, for the parent to hold bitwise against the
baseline set's.

A changed bit in an SpMM kernel's output (integer X: exact sums) fails
the set. The fused FFNs' SiLU, exp and division may change under
``--use_fast_math``: their changed elements are reported as findings, not
failures. ``--device cpu`` runs the plain versions (no nvcc: every set the
same code), for a dry run of the protocol.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.compiler_sweep
        [--sets baseline,maxrregcount_128] [--output PATH]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

#: name -> the nvcc flags added to ``_build.NVCC_FLAGS``
OPTION_SETS = {
    "baseline": [],
    "ptxas_O1": ["-Xptxas", "-O1"],
    "ptxas_O2": ["-Xptxas", "-O2"],
    "maxrregcount_128": ["-maxrregcount=128"],
    "maxrregcount_255": ["-maxrregcount=255"],
    "dlcm_cg": ["-Xptxas", "-dlcm=cg"],
    "fast_math": ["--use_fast_math"],
}
NS = (32, 1024, 4096, 4)
#: the fused FFNs' outputs held across sets: (rows) at the ffn_bench
#: block's widths (1024 -> 4096 -> 1024)
FFN_ROWS = (4, 128)
FFN_WIDTHS = (1024, 4096)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def extra_flags(flags):
    """``_build.NVCC_FLAGS`` extended by ``flags`` inside the block."""
    from ternary_spgemm_tpu_torch.ops import _build

    n = len(_build.NVCC_FLAGS)
    _build.NVCC_FLAGS.extend(flags)
    try:
        yield
    finally:
        del _build.NVCC_FLAGS[n:]


def library_path(name: str) -> str:
    """The library ``name``'s set builds and loads."""
    from ternary_spgemm_tpu_torch.ops import _build

    with extra_flags(OPTION_SETS[name]):
        return _build.library_path()


def child_command(name: str, out_dir: str, device: str) -> list:
    """The command of ``name``'s child process, writing into ``out_dir``."""
    return [sys.executable, "-m", "ternary_spgemm_tpu_torch.tools."
            "compiler_sweep", "--child", name, "--child-dir", out_dir,
            "--device", device]


def outputs(dev) -> dict:
    """name -> output of every hand-written kernel of the headline's set at
    the north star, and of the fused FFNs (``FFN_ROWS`` x ``FFN_WIDTHS``),
    on seeded inputs."""
    from ternary_spgemm_tpu_torch.bench.headline import DEFAULT_KERNELS
    from ternary_spgemm_tpu_torch.formats import (
        TiledBitplane, generate_bias, generate_ternary, generate_x)
    from ternary_spgemm_tpu_torch.ops import all_kernels, fused_ffn

    M, K, N, s = NS
    W = torch.from_numpy(generate_ternary(K, N, s, seed=0)).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=1)).to(dev)
    b = torch.from_numpy(generate_bias(N)).to(dev)
    out, fmts = {}, {}
    for name in DEFAULT_KERNELS:
        spec = all_kernels()[name]
        if not spec.source:
            continue
        if spec.format_cls not in fmts:
            fmts[spec.format_cls] = spec.format_cls.from_dense(W)
        Xk = X if spec.x_absmax is None else X.clamp(-spec.x_absmax,
                                                     spec.x_absmax)
        out[name] = spec.fn(Xk, fmts[spec.format_cls], b, None)
    d, ff = FFN_WIDTHS
    gen = lambda k, n, seed: TiledBitplane.from_dense(
        generate_ternary(k, n, 2, seed=seed), device=dev)
    fg, fu, fd = gen(d, ff, 11), gen(d, ff, 12), gen(ff, d, 13)
    zh, zd = torch.zeros(ff, device=dev), torch.zeros(d, device=dev)
    for rows in FFN_ROWS:
        x = torch.from_numpy(generate_x(rows, d, seed=14)).to(dev)
        xq, sx = fused_ffn.requantize_rows(x)
        out[f"swiglu/{rows}"] = fused_ffn.fused_bitplane_swiglu(
            xq, sx, fg, fu, fd, gamma_gate=0.5, gamma_up=0.5, gamma_down=0.5)
        out[f"prelu_ffn/{rows}"] = fused_ffn.fused_bitplane_ffn(
            x, fg, zh, None, fd, zd)
    return out


def run_set(name: str, out_dir: str, dev) -> dict:
    """In the child: the set's flags on, the headline's kernel set timed at
    the north star, the outputs saved to ``out_dir/<name>.npz``."""
    from ternary_spgemm_tpu_torch.bench import BenchConfig, run_config
    from ternary_spgemm_tpu_torch.bench.headline import DEFAULT_KERNELS
    from ternary_spgemm_tpu_torch.ops import _build

    with extra_flags(OPTION_SETS[name]):
        if dev.type == "cuda":
            _build.load()
        M, K, N, s = NS
        results = run_config(BenchConfig(
            M=M, K=K, N=N, s=s, kernels=DEFAULT_KERNELS, correctness=True,
            repeats=3, min_seconds=0.05, device=dev.type,
            timer="cuda_events" if dev.type == "cuda" else "wall"))
        ys = outputs(dev)
    np.savez(os.path.join(out_dir, f"{name}.npz"),
             **{k: v.detach().cpu().numpy() for k, v in ys.items()})
    return {"library": (os.path.basename(_build.last_build["path"])
                        if dev.type == "cuda" else None),
            "build_seconds": _build.last_build.get("seconds"),
            "built": _build.last_build.get("built"),
            "seconds": {r.name: r.seconds for r in results if not r.error},
            "correct": {r.name: r.correct for r in results},
            "errors": {r.name: r.error for r in results if r.error}}


def compare(base: dict, got: dict) -> dict:
    """Elements of each output that differ from the baseline's: the SpMM
    kernels' (failures) and the fused FFNs' (findings)."""
    flips = {k: int((base[k] != got[k]).sum()) for k in base}
    return {"spmm_flips": {k: v for k, v in flips.items() if "/" not in k
                           and v},
            "ffn_flips": {k: v for k, v in flips.items() if "/" in k}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.compiler_sweep")
    p.add_argument("--sets", default=",".join(OPTION_SETS),
                   help="comma-separated option sets (baseline first)")
    p.add_argument("--output", default=None)
    p.add_argument("--timeout", type=int, default=1800)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    p.add_argument("--child-dir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.tools import card_line, write_json
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.child:
        print("RESULT " + json.dumps(run_set(args.child, args.child_dir,
                                             dev)), flush=True)
        return 0
    names = args.sets.split(",")
    unknown = [n for n in names if n not in OPTION_SETS]
    if unknown or names[0] != "baseline":
        raise ValueError(f"--sets must start with baseline and name sets of "
                         f"{list(OPTION_SETS)}; got {names}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    results, failed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            proc = subprocess.run(child_command(name, tmp, args.device),
                                  capture_output=True, text=True, env=env,
                                  timeout=args.timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"set {name} exited {proc.returncode}:\n"
                                   f"{proc.stdout[-3000:]}"
                                   f"{proc.stderr[-3000:]}")
            (line,) = [ln for ln in proc.stdout.splitlines()
                       if ln.startswith("RESULT ")]
            rec = {"option_set": name, "flags": OPTION_SETS[name],
                   **json.loads(line.split(" ", 1)[1])}
            with np.load(os.path.join(tmp, f"{name}.npz")) as got, \
                    np.load(os.path.join(tmp, "baseline.npz")) as base:
                rec.update(compare(dict(base), dict(got)))
            if rec["spmm_flips"] or rec["errors"] or not all(
                    v is not False for v in rec["correct"].values()):
                failed.append(name)
            results.append(rec)
            print(f"[{name}] {' '.join(OPTION_SETS[name]) or 'defaults'}: "
                  f"library {rec['library']} (built {rec['built']}, "
                  f"{rec['build_seconds']} s), flips "
                  f"{rec['spmm_flips'] or 'none'} / ffn "
                  f"{rec['ffn_flips']}", flush=True)
    hand = {n for n, s in all_kernels().items() if s.source}
    out = {"device": device_name(args.device), "card": card_line(dev),
           "config": dict(zip("MKNs", NS)), "results": results,
           "failed": failed}
    if args.output:
        write_json(args.output, out)
    print(json.dumps({"compiler_sweep": {
        r["option_set"]: {
            "us": {k: round(v * 1e6, 3) for k, v in r["seconds"].items()
                   if k in hand},
            "spmm_flips": sum(r["spmm_flips"].values()),
            "ffn_flips": sum(r["ffn_flips"].values())} for r in results},
        "failed": failed, "device": out["device"], "card": out["card"]}),
        flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
