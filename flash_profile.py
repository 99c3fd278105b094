#!/usr/bin/env python3
"""Profile the port's bf16 flash kernels at the long-context shape (8 heads
of S = 32768, D = 128, causal, rate 0) on the card, for one or more
checkouts of the repository.

    python3 flash_profile.py [TREE ...]

TREE is a directory holding ``simple_tensorflow_tpu_torch/`` (default: this
checkout); to hold a change against its parent, unpack the parent with
``git archive`` into a git-ignored directory and name both. Each tree runs
in a process of its own (the two packages share a name): it builds that
tree's kernels and prints the card's name and power limit, each D = 128
flash kernel's ``ptxas`` registers and spills (``chip_smoke.kernel_props``)
beside its SASS instruction mix from ``cuobjdump`` (tensor-core ops, their
operand loads, barriers, the exp unit, and the highest register it names),
and, from ``torch.profiler``, the device time of each kernel by name over
the forward, dK/dV and dQ with the TFLOP/s it reaches against the dense
bf16 peak (``chip_smoke``'s FLOP a pair and peak). The times sit beside
CUDA-event times of the same calls. Needs one card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
BH, D = 8, 128
# SASS opcode classes: (label, opcodes)
SASS_CLASSES = (("wgmma", ("HGMMA",)), ("mma.sync", ("HMMA",)),
                ("ldmatrix", ("LDSM",)), ("cp.async", ("LDGSTS",)),
                ("tma", ("UTMALDG",)), ("bar", ("BAR",)),
                ("mbarrier", ("SYNCS",)), ("ex2", ("MUFU",)),
                ("f32 fma/mul/add", ("FFMA", "FMUL", "FADD")))


def at_d128(name):
    """A flash kernel this script profiles: the sm90 ones and the
    ``mma.sync`` instantiations at D = 128."""
    return name is not None and ("sm90" in name or "<128" in name)


def sass_mix(sass, demangled_kernel):
    """``{kernel: (class counts, highest register)}`` of the D = 128 flash
    kernels in a ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = demangled_kernel(m.group(1), "flash")
            if at_d128(name):
                out[name] = [{c: 0 for c, _ in SASS_CLASSES}, 0]
            else:
                name = None
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)",
            ln)
        if name and m:
            op = m.group(1).split(".")[0]
            for c, ops in SASS_CLASSES:
                if op in ops:
                    out[name][0][c] += 1
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", m.group(2))]
            if regs:
                out[name][1] = max(out[name][1], max(regs))
    return out


def one(tree: str):
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("flash_profile: needs a card (torch.cuda.is_available() "
                 "is False)")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    from simple_tensorflow_tpu_torch.ops import kernels as K
    from simple_tensorflow_tpu_torch.ops.kernels import _build

    print(f"== {tree}: {cs.card_line()}", flush=True)
    _build.library()
    log = _build.build_log or (_build.BUILD_DIR / "build.log").read_text()
    lib = _build.BUILD_DIR / f"libstf_kernels_{_build._key()}.so"
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    mix = sass_mix(sass, cs.demangled_kernel)
    for name, props in cs.kernel_props(log, "flash"):
        if at_d128(name):
            counts, top = mix.get(name, ({}, 0))
            print(f"  {name}: {props}; highest register named R{top}; SASS "
                  + ", ".join(f"{c} {v}" for c, v in counts.items() if v),
                  flush=True)

    S = cs.LC_S
    pairs = BH * (S * (S + 1) // 2)
    flop = {p: n * D * pairs for p, n in cs.FLASH_FLOP_PER_PAIR.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    args = dict(heads=BH, sm_scale=D ** -0.5, causal=True)
    q, k, v, do = (torch.randn((BH, S, D), generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    o, lse = K.flash_attention_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    parts = {"fwd": lambda: K.flash_attention_fwd(q, k, v, **args),
             "dkdv": lambda: K.flash_attention_dkdv(q, k, v, do, lse, delta,
                                                    **args),
             "dq": lambda: K.flash_attention_dq(q, k, v, do, lse, delta,
                                                **args)}
    reps = 3
    for part, fn in parts.items():
        ev = cs.event_ms(fn, reps=reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "flash" in e.name:
                m = re.search(r"(flash\w*kernel<[^>]*>)", e.name)
                name = m.group(1) if m else e.name
                by.setdefault(name, []).append(e.device_time_total / 1e3)
        for name, ts in by.items():
            ms = sum(ts) / len(ts)
            print(f"  {part}: {name} {ms:.5f} ms a launch ({len(ts)} "
                  f"launches traced; CUDA events {ev:.5f} ms a call), "
                  f"{flop[part] / ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * flop[part] / ms / 1e-3 / cs.BF16_PEAK:.1f}% of "
                  "the dense bf16 peak", flush=True)
        if not by:
            print(f"  {part}: the trace holds no device record; CUDA events "
                  f"{ev:.5f} ms a call", flush=True)
        time.sleep(0.5)


def main():
    if sys.argv[1:2] == ["--one"]:
        one(os.path.abspath(sys.argv[2]))
        return
    trees = sys.argv[1:] or [ROOT]
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], timeout=1800).returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
