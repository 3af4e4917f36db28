"""What two trees' CUDA sources compile to, function by function: whether a
change left a kernel body's machine code as it was, and each kernel's
registers, spills and shared memory.

Each ``*.cu`` of both ``csrc`` directories is compiled for Hopper with the
package's own flags (``ops/_build.py``) to a cubin, all at once, and
disassembled with ``cuobjdump -sass``. A function's body is its instruction
text with the addresses and encodings left out, hashed, so that a body
that moved or changed its name (a template argument) still matches. For
each source the tool prints how many of the change's functions have a
parent body byte for byte, and names the new or changed ones and the
parent's bodies that are gone. With ``--ptxas``, it also compiles those
sources of the change with ``-Xptxas -v`` and prints each kernel's
registers, spill stores and loads, and shared memory.

Usage (on a machine with the CUDA toolkit; no card needed)::

    python -m ternary_spgemm_tpu_torch.tools.sass_compare PARENT_CSRC \\
        [CHANGE_CSRC] [--ptxas bitplane.cu ...] [--out PATH]

``CHANGE_CSRC`` defaults to this package's ``csrc``. Prints the rows and
one JSON object (``emit``).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from ternary_spgemm_tpu_torch.tools import emit

_FUNC = re.compile(r"\s*Function : (\S+)")
_INSN = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def functions(sass: str) -> dict:
    """``cuobjdump -sass`` text -> {function: (hash of its body's
    instructions, instruction count)}: each instruction line's text
    between its ``/*address*/`` column and its ``;``."""
    bodies, name = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            bodies[name] = []
            continue
        m = _INSN.match(line)
        if m and name is not None:
            bodies[name].append(m.group(1))
    return {n: (hashlib.sha1("\n".join(b).encode()).hexdigest()[:12], len(b))
            for n, b in bodies.items()}


def compare(parent: dict, change: dict) -> dict:
    """Two sources' :func:`functions` -> ``{"same": [...], "new": [...],
    "gone": [...]}``: the change's functions whose body some parent
    function has, the change's others, the parent's bodies no function of
    the change has (names sorted)."""
    parent_hashes = {h for h, _ in parent.values()}
    change_hashes = {h for h, _ in change.values()}
    return {"same": sorted(n for n, (h, _) in change.items()
                           if h in parent_hashes),
            "new": sorted(n for n, (h, _) in change.items()
                          if h not in parent_hashes),
            "gone": sorted(n for n, (h, _) in parent.items()
                           if h not in change_hashes)}


def ptxas_report(text: str) -> list:
    """``nvcc -Xptxas -v`` output -> one dict a compiled entry function:
    name, registers, spill stores and loads (bytes), static shared memory
    (bytes)."""
    rows, cur = [], None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"function": m.group(1), "registers": None,
                   "spill_stores": 0, "spill_loads": 0, "smem": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = (int(m.group(2)),
                                                       int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            m = _SMEM.search(line)
            cur["smem"] = int(m.group(1)) if m else 0
    return rows


def _tool(name: str) -> str:
    from ternary_spgemm_tpu_torch.ops import _build

    path = os.path.join(os.path.dirname(_build._nvcc()), name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found beside nvcc ({path})")
    return path


def _flags() -> list:
    from ternary_spgemm_tpu_torch.ops import _build

    return [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]


def sass_of(src: str, tmp: str) -> str:
    """``src`` compiled to a cubin in ``tmp`` and disassembled."""
    cubin = os.path.join(tmp, hashlib.sha1(src.encode()).hexdigest()[:12]
                         + ".cubin")
    subprocess.run([_tool("nvcc"), *_flags(), "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, text=True)
    return subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout


def main(argv=None) -> int:
    from ternary_spgemm_tpu_torch.ops import _build

    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.sass_compare")
    p.add_argument("parent", help="the parent tree's csrc directory")
    p.add_argument("change", nargs="?", default=_build.CSRC_DIR,
                   help="the change's csrc directory (default: this one)")
    p.add_argument("--ptxas", nargs="*", default=[],
                   help="sources of the change to report -Xptxas -v for")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    srcs = sorted(f for f in os.listdir(args.change) if f.endswith(".cu"))
    jobs = [(tag, tree, f) for f in srcs
            for tag, tree in (("parent", args.parent), ("change", args.change))
            if os.path.exists(os.path.join(tree, f))]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as ex:
        sass = list(ex.map(
            lambda j: functions(sass_of(os.path.join(j[1], j[2]), tmp)), jobs))
        ptx = [r.stdout + r.stderr for r in ex.map(lambda f: subprocess.run(
            [_tool("nvcc"), *_flags(), "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, f + ".o"), os.path.join(args.change, f)],
            check=True, capture_output=True, text=True), args.ptxas)]
    got = {(tag, f): fn for (tag, _, f), fn in zip(jobs, sass)}
    result = {"sources": {}, "ptxas": {}}
    for f in srcs:
        c = compare(got.get(("parent", f), {}), got[("change", f)])
        result["sources"][f] = c
        print(f"{f}: {len(got[('change', f)])} functions, {len(c['same'])} "
              f"with a parent body byte for byte, {len(c['new'])} new or "
              f"changed, {len(c['gone'])} parent bodies gone", flush=True)
        for n in c["new"]:
            print(f"   new or changed: {n}", flush=True)
        for n in c["gone"]:
            print(f"   parent only: {n}", flush=True)
    for f, text in zip(args.ptxas, ptx):
        result["ptxas"][f] = ptxas_report(text)
        for r in result["ptxas"][f]:
            print(f"{f} {r['function']}: {r['registers']} registers, "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes of spill "
                  f"stores / loads, {r['smem']} bytes smem", flush=True)
    emit(result, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
