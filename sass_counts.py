#!/usr/bin/env python3
"""Static SASS instruction counts of the port's dropout kernels, by opcode
and by the pipe each opcode issues on, from ``cuobjdump -sass`` of the
kernel library built from ``simple_tensorflow_tpu_torch/csrc/``.

    python3 sass_counts.py

Builds the library with ``nvcc`` for ``sm_90a`` if it is not built yet
(the CUDA toolkit must be installed; no card is needed) and prints one
line a kernel: all its instructions, those up to its last ``EXIT`` (the
subroutines after it, such as the division's slow path, run only on rare
inputs), and of those the ALU-only ones and the FMA pipe's, each also
over the elements a thread takes an iteration.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# SASS opcodes by the pipe they issue on: ALU-only integer and logic ops,
# and what runs on the FMA pipe (integer multiply-adds and f32 math)
SASS_ALU = ("SHF", "LOP3", "ISETP", "IADD3", "SEL", "PRMT", "LEA", "SHL",
            "SHR", "IABS", "IMNMX", "FSEL", "FSETP", "P2R", "R2P", "PLOP3")
SASS_FMA = ("IMAD", "FFMA", "FMUL", "FADD")
# the main path's dropout kernels and the elements a thread takes an
# iteration (K4: 4 vectors a lane of 8 bf16)
SASS_KERNELS = {"dropout_vec_kernel<bf16>": 8,
                "dropout_bwd_vec_kernel<bf16>": 8,
                "dropout_residual_vec_kernel<bf16, 4, 1, 0>": 32,
                "dropout_residual_vec_kernel<bf16, 4, 0, 0>": 32}


def functions(sass: str) -> dict:
    """``{mangled name: (opcodes, count up to the last EXIT)}`` of a
    ``cuobjdump -sass`` listing."""
    funcs, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = [[], 0]
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if name and m:
            op = m.group(1).split(".")[0]
            funcs[name][0].append(op)
            if op == "EXIT":
                funcs[name][1] = len(funcs[name][0])
    return funcs


def label(sym: str):
    """``dropout...kernel<dtype, template ints>`` of a mangled dropout
    kernel, else None."""
    k = re.search(r"\d(dropout\w*?kernel)I(\w*?)EE", sym)
    if not k:
        return None
    dt = "bf16" if "bfloat16" in k.group(2) else "f32"
    targs = re.findall(r"L[ib](\d+)", k.group(2))
    return f"{k.group(1)}<{', '.join([dt] + targs)}>"


def main():
    sys.path.insert(0, ROOT)
    from simple_tensorflow_tpu_torch.ops.kernels import _build

    _build.library()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    lib = _build.BUILD_DIR / f"libstf_kernels_{_build._key()}.so"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    seen = set()
    for sym, (ops, body) in sorted(functions(sass).items()):
        name = label(sym)
        per = SASS_KERNELS.get(name)
        if per is None:
            continue
        seen.add(name)
        seq = ops[:body]
        alu = sum(op in SASS_ALU for op in seq)
        fma = sum(op in SASS_FMA for op in seq)
        counts = {op: seq.count(op) for op in set(seq)}
        top = ", ".join(f"{op} {v}" for op, v in sorted(
            counts.items(), key=lambda kv: -kv[1])[:12])
        print(f"sass {name}: {len(ops)} instructions, {len(seq)} before the "
              f"last EXIT ({len(seq) / per:.1f} an element): ALU-only {alu} "
              f"({alu / per:.1f}), FMA pipe {fma} ({fma / per:.1f}), other "
              f"{len(seq) - alu - fma}; {top}", flush=True)
    missing = sorted(set(SASS_KERNELS) - seen)
    if missing:
        sys.exit(f"sass_counts: not in the library: {missing}")


if __name__ == "__main__":
    main()
