#!/usr/bin/env python3
"""The atomic instructions in the SASS of the port's CUDA kernels.

    python3 scripts/sass_atomics.py [SOURCE ...]     # default: count_sketch

builds each named library of ``src/repro_torch/kernels/csrc`` as the port
builds it (``kernels/build.py``), disassembles it with ``cuobjdump -sass``
and prints, for every kernel function, the count of each atomic opcode
(``ATOMS`` on shared memory, ``ATOM`` / ``ATOMG`` / ``RED`` on global) and
whether a compare-and-swap is among them (a float add done as a CAS
loop).  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.
"""
import collections
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build  # noqa: E402

ATOMIC = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*)")
FUNC = re.compile(r"Function : (\S+)")


def sass_atomics(name):
    """{kernel function: Counter of atomic opcodes} of library ``name``."""
    build.build((name,))
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out, func = {}, None
    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            func = m.group(1)
            out[func] = collections.Counter()
            continue
        if func is not None:
            for op in ATOMIC.findall(line):
                out[func][op] += 1
    return out


def main(names):
    for name in names or ("count_sketch",):
        atomics = sass_atomics(name)
        for line in build.LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")
        for func, ops in atomics.items():
            cas = any("CAS" in op for op in ops)
            print(f"{name} {func}: "
                  + (", ".join(f"{op} x{k}" for op, k in sorted(ops.items()))
                     or "no atomics")
                  + (" (compare-and-swap loop)" if cas else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
