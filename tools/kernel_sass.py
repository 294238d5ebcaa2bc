#!/usr/bin/env python3
"""Instruction counts of the port's CUDA kernels, read from their SASS.

    python tools/kernel_sass.py [--match distortion]

Run from the root of a checkout on a machine with the CUDA toolkit and a
card. It builds the kernel library from `csrc/` (as the wrappers do),
disassembles it with `cuobjdump -sass` and prints one line of JSON: for
each kernel whose mangled name contains `--match`, its instruction count
and opcode counts, whole and for each loop (the instructions from a
backward branch's target to the branch), with nvcc's ptxas lines and the
card's name, power limit and maximum SM clock (`nvidia-smi`). It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FUNC = re.compile(r"^\s*Function : (\S+)")
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")
BRA_TARGET = re.compile(r"0x([0-9a-f]+)")


def functions(text: str) -> dict:
    """{kernel: [(address, opcode, operands)]} from cuobjdump -sass."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def opcodes(insns) -> dict:
    return dict(collections.Counter(op for _, op, _ in insns).most_common())


def loops(insns) -> list:
    out = []
    for addr, op, args in insns:
        m = BRA_TARGET.search(args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            body = [i for i in insns if int(m.group(1), 16) <= i[0] <= addr]
            out.append({"from": m.group(0), "to": hex(addr),
                        "instructions": len(body), "opcodes": opcodes(body)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--match", default="distortion")
    args = ap.parse_args()
    from leaffliction_tpu_torch.kernels import build

    build.load()
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    kernels = {name: {"instructions": len(insns), "opcodes": opcodes(insns),
                      "loops": loops(insns)}
               for name, insns in functions(text).items()
               if args.match in name}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log = build.build_log.splitlines()
    ptxas = [ln.strip() for i, ln in enumerate(log)
             if any(args.match in x for x in log[max(0, i - 2):i + 1])]
    print(json.dumps({"kernels": kernels, "ptxas": ptxas,
                      "nvidia_smi": smi}))
    return 0 if kernels else 1


if __name__ == "__main__":
    sys.exit(main())
