"""``tools.sass_compare``'s parsers, on the CPU: a kernel body's hash
leaves out its addresses and encodings and follows it across a change of
name; the comparison sorts a change's functions into kept, new or changed,
and the parent's bodies gone; the ``-Xptxas -v`` report reads registers,
spills and shared memory. The tool itself compiles with nvcc, on the
machine with the CUDA toolkit."""

import pytest

from ternary_spgemm_tpu_torch.tools import sass_compare as sc


def _sass(funcs: dict, base: int = 0) -> str:
    """cuobjdump -sass text for {name: [instructions]}, with addresses from
    ``base`` and encodings on the following lines."""
    lines = []
    for name, body in funcs.items():
        lines.append(f"\t\tFunction : {name}")
        lines.append("\t.headerflags\t@\"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\"")
        for i, ins in enumerate(body):
            lines.append(f"        /*{base + 16 * i:04x}*/                   {ins} ;"
                         f"                /* 0x000fe20000000f00 */")
            lines.append("                                                  "
                         "/* 0x000fc00000000000 */")
    return "\n".join(lines)


K1 = ["MOV R1, c[0x0][0x28]", "S2R R0, SR_TID.X", "EXIT", "BRA 0x30"]
K2 = ["MOV R1, c[0x0][0x28]", "IDP.4A.S8.S8 R4, R2, R3, R4", "EXIT"]


def test_functions_hash_the_instruction_text():
    a = sc.functions(_sass({"_Z1kILi4EEvv": K1, "_Z2k2v": K2}))
    b = sc.functions(_sass({"_Z1kILi8EEvv": K1}, base=0x400))
    assert set(a) == {"_Z1kILi4EEvv", "_Z2k2v"}
    assert a["_Z1kILi4EEvv"][1] == 4 and a["_Z2k2v"][1] == 3
    # another name and other addresses: the same body
    assert a["_Z1kILi4EEvv"][0] == b["_Z1kILi8EEvv"][0]
    assert a["_Z1kILi4EEvv"][0] != a["_Z2k2v"][0]


@pytest.mark.parametrize("change,same,new,gone", [
    ({"a": K1, "b": K2}, ["a", "b"], [], []),
    ({"a": K1, "c": K2 + ["NOP"]}, ["a"], ["c"], ["b"]),
    ({"renamed": K2}, ["renamed"], [], ["a"]),
])
def test_compare_sorts_the_functions(change, same, new, gone):
    parent = sc.functions(_sass({"a": K1, "b": K2}))
    got = sc.compare(parent, sc.functions(_sass(change)))
    assert got == {"same": same, "new": new, "gone": gone}


def test_ptxas_report():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN7ternary4gemv11gemv_kernelILi4ELi0ELb1EEEvNS0_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN7ternary4gemv11gemv_kernelILi4ELi0ELb1EEEvNS0_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers, 32784 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3fooPi' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPi
    24 bytes stack frame, 44 bytes spill stores, 320 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 24 bytes cumulative stack size, 400 bytes cmem[0]
"""
    rows = sc.ptxas_report(text)
    assert rows == [
        {"function": "_ZN7ternary4gemv11gemv_kernelILi4ELi0ELb1EEEvNS0_4ArgsE",
         "registers": 63, "spill_stores": 0, "spill_loads": 0, "smem": 32784},
        {"function": "_Z3fooPi", "registers": 64, "spill_stores": 44,
         "spill_loads": 320, "smem": 0}]
