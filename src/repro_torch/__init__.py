"""repro_torch — the PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (``configs/``, ``kernels/``,
``compress/``, ``models/``, ``core/``, ``data/``, ``launch/``) so each
counterpart is found by path.  It imports ``torch`` and never ``jax`` or
``repro``; the differential tests under ``tests/test_torch_*.py`` are the
only code that imports both.

The port runs the synchronous FedAvg round of the ``sim`` topology with a
``topk:<f>>>qsgd:<b>`` or STC (``stc``, ``stc:<f>@fused``,
``topk>>ternary``) uplink under error feedback or DGC, and an optional
LFL (``lfl8``) downlink.  Its compression kernels are hand-written CUDA
for ``sm_90a`` (``kernels/csrc``); on a CPU tensor each wrapper runs its
plain PyTorch version instead.  Knobs of ``repro`` that this slice does not port raise
``NotImplementedError`` naming the JAX module that has them.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
