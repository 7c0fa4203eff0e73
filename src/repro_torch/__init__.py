"""repro_torch — the PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (``configs/``, ``kernels/``,
``compress/``, ``models/``, ``core/``, ``data/``, ``launch/``, ``obs/``,
``checkpoint/``) so each counterpart is found by path.  It imports
``torch`` and never ``jax`` or ``repro``; the differential tests under
``tests/test_torch_*.py`` are the only code that imports both.

The port runs the reference's one-card round engines: the synchronous
``sim`` round (dense, or over a streaming ``ClientPopulation`` whose
per-client pipeline state lives in a bounded ``ResidualStore``) and the
virtual-clock ``async`` FedBuff / FedAsync engine, with the survey's
client and server algorithms (FedProx, SCAFFOLD, FedDANE, CMFL, FedAvgM,
FedAdam, FedYogi), client selection, the scenario's client dynamics,
every uplink stage the reference registers (top-k, QSGD, STC and
ternary, the count sketch, SBC, RandMask, HSQ, UVeQ, chains of them,
``@fused`` packed wires, the ``secagg`` and ``dpnoise`` privacy stages)
under error feedback or DGC, and an LFL downlink, on every arch of
``configs/`` (dense, MoE, Mamba-2, the Jamba hybrid, Whisper's
encoder-decoder and the VLM prefix).  ``obs/`` is the flight recorder (``RoundStats``
telemetry, the JSONL tracer, its report) and ``checkpoint/`` saves params
in the reference's npz format.  Serving decodes from KV (bf16 or int8)
and SSM caches (``models/``, ``launch/serve.py``); ``configs/shapes.py``
holds the reference's input shapes and ``optim/`` its SGD and AdamW.  The compression kernels are hand-written
CUDA for ``sm_90a`` (``kernels/csrc``); on a CPU tensor each wrapper runs
its plain PyTorch version instead.  Knobs of ``repro`` that the port does
not run (the mesh topologies) raise
``NotImplementedError`` naming the JAX module that has them.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
