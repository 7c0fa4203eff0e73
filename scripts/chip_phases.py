#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on one CUDA card.

    python3 scripts/chip_phases.py topology_phase llama_star_phase
    python3 scripts/chip_phases.py --src build/parent/src count_sketch_phase

builds the kernels, applies the script's determinism settings and runs
each named phase function of ``chip_smoke.py`` in turn (default: the
mesh topologies' ``topology_phase``, ``llama_star_phase`` and
``nccl_cli_phase``), printing each phase's seconds and the kernel
launches counted in it.  No ``kernels`` or ``ok`` line: the whole script
is the smoke run.

``--src DIR`` runs the phases on the port under ``DIR`` (default: this
checkout's ``src``), e.g. a ``git archive`` of a parent commit unpacked
into ``build/parent``, whose kernels then build into
``build/parent/build/kernels``.  Timing two trees in one call, in turns
(parent, change, change, parent), keeps them on one card:

    for t in build/parent/src src src build/parent/src; do
        python3 scripts/chip_phases.py --src $t count_sketch_phase; done
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

import chip_smoke as CS  # noqa: E402
import torch  # noqa: E402

DEFAULT = ("topology_phase", "llama_star_phase", "nccl_cli_phase")


def main(argv):
    src = CS.SRC
    if argv[:1] == ["--src"]:
        src, argv = os.path.abspath(argv[1]), argv[2:]
    names = argv or DEFAULT
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    print(f"{CS.card_line()}; source tree {src}", flush=True)
    print(f"kernel build {build.build():.1f}s", flush=True)
    dev = torch.device("cuda", 0)
    t00 = time.perf_counter()
    for phase in [getattr(CS, n) for n in names]:
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        phase(dev)
        print(f"phase done in {time.perf_counter() - t0:.1f}s launches "
              f"{dict(build.LAUNCHES)}", flush=True)
    print(f"total {time.perf_counter() - t00:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
