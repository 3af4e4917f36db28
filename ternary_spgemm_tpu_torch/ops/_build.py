"""Build the package's CUDA kernels on first use and load them with ctypes.

Every ``csrc/*.cu`` file compiles with its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects link into one shared
library with a plain C interface. The library lands in ``build/cuda/``
beside the package (listed in ``.gitignore``), named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
the cached library. No ``--use_fast_math``: the requantize division must
stay IEEE, and ``exp`` accurate, for parity with the plain versions and the
JAX reference.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: (x, M, K, weights, nb, gn, rows a K-block (the bitplane core's byte-rows
#: tkb, the packed core's rows tkq), tile_n, N, bias, alpha, y, stream)
_SPMM = [_P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
#: (x, M, K, dense, N, bias, alpha, y, stream): the DenseTernary (K, N) plane
_DENSE = [_P, _I, _I, _P, _I, _P, _P, _P, _P]
#: (x, M, K, weights, nb, gn, tile_kq, tile_n, factor, N, bias, alpha, y,
#: stream)
_PACKED = [_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
#: (x, M, K, pos, neg, cap_pos, cap_neg, nb, gn, rows_pos, rows_neg, slab_n,
#: cap_tile, ncaps, block_k, N, bias, alpha, y, stream)
_ELL = [_P, _I, _I, _P, _P, _P, _P, *[_I] * 9, _P, _P, _P, _P]
#: (xq, sx, M, K, gate, up, nb1, gn1, tkb1, tile_n1, N1, down, nb2, gn2,
#: tkb2, tile_n2, N2, gamma_gate, gamma_up, gamma_down, h, rmax, y, stream)
_SWIGLU = [_P, _P, _I, _I, _P, _P, *[_I] * 5, _P, *[_I] * 5, _F, _F, _F, _P,
           _P, _P, _P]
#: argtypes of every C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    #: _SPMM, then the split-K parts' int32 scratch, the tiles' counters
    #: and the parts
    "ternary_bitplane_x8": [*_SPMM, _P, _P, _I],
    #: _SPMM, then the int8 scratch for the rounded X
    "ternary_bitplane_x8_mma": [*_SPMM, _P],
    #: as ternary_bitplane_x8
    "ternary_bitplane_i8": [*_SPMM, _P, _P, _I],
    #: _SPMM, then the int8 scratch for the hi and lo planes of X
    "ternary_bitplane_i8_mma": [*_SPMM, _P],
    "ternary_bitplane_bf16": _SPMM,
    "ternary_nibblepair_i8": _SPMM,
    "ternary_tiled_dense_i8": _SPMM,
    "ternary_tiled_dense_x8": _SPMM,
    "ternary_dense_f32": _DENSE,
    "ternary_dense_bf16": _DENSE,
    "ternary_dense_i8": _SPMM,
    "ternary_blockpacked_i8": _PACKED,
    "ternary_packed_f32": _PACKED,
    "ternary_tiled_ell_f32": _ELL,
    "ternary_ell_deposit_i8": _ELL,
    "ternary_blocked_ell_f32": _ELL,
    #: _SWIGLU, then the int32 scratch of the split walks' sums and the
    #: parts of phase 1 and phase 2
    "ternary_swiglu": [*_SWIGLU, _P, _I, _I],
    #: _SWIGLU, then the int8 scratches for xq and for the requantized h
    "ternary_swiglu_mma": [*_SWIGLU, _P, _P],
    #: (x, M, K, plane1, nb1, gn1, tkb1, tile_n1, N1, b1/gamma1, alpha1,
    #: plane2, nb2, gn2, tkb2, tile_n2, N2, b2, alpha2, gamma1*gamma2, h,
    #: rmax, y, stream), then the split-K parts' int32 scratch, the tiles'
    #: counters and the parts of phase 1 and phase 2
    "ternary_prelu_ffn": [_P, _I, _I, _P, *[_I] * 5, _P, _P, _P, *[_I] * 5,
                          _P, _P, _F, _P, _P, _P, _P, _P, _P, _I, _I],
    #: (array, gk, gn, tk, tn, layout, sms, scratch, replicas, out, stream)
    "ternary_stream_rate": [_P, *[_I] * 6, _P, _I, _P, _P],
    #: (plane, tkb, tns, x, reps, blocks, out, stream)
    "ternary_decode_rate": [_P, _I, _I, _P, _I, _I, _P, _P],
    #: (x, M, K, pos, neg, cap_pos, cap_neg, nsb, gn, rows, tile_n,
    #: static_pos, static_neg, N, bias, y, mode, stream)
    "ternary_deposit_variant": [_P, _I, _I, _P, _P, _P, _P, *[_I] * 7, _P,
                                _P, _I, _P],
    #: (entries, n, tile, stream)
    "ternary_scalar_deposit": [_P, _I, _P, _P],
    #: (x, w, bias, y, buf, flags, ranks, mc, K, N, blocks_out, stream)
    "ternary_ring_spgemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}

_LOADED = {}
#: what the last :func:`load` did: ``{"path", "seconds", "built", "log"}``
last_build: dict = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the GPU (CUDA toolkit required)")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libternary_kernels_{h.hexdigest()[:16]}.so")


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _compile(nvcc: str, out: str) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link into
    ``out``; returns the compilers' output. Every process is waited for
    (and killed first if another one failed)."""
    srcs = [p for p in _sources() if p.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs, failed = [], []
        try:
            for cmd, p in zip(cmds, procs):
                text = p.communicate()[0]
                logs.append(text)
                if p.returncode != 0:
                    failed.append(f"{' '.join(cmd)}\n{text}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", out, *objs]))
    return "".join(logs)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process
    (the sources are hashed once, at the first call)."""
    if "lib" in _LOADED:
        return _LOADED["lib"]
    t0 = time.perf_counter()
    path = library_path()
    built, log = False, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        log = _compile(_nvcc(), tmp)
        os.replace(tmp, path)
        built = True
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED["lib"] = lib
    last_build.update(path=path, seconds=time.perf_counter() - t0,
                      built=built, log=log)
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
