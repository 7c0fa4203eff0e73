"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  With no
CUDA device and no such request they raise: nothing falls back to the CPU
silently, so a run that reports a time or a launch count really ran on the
card."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def not_ported(what: str, module: str) -> NotImplementedError:
    """The error every knob outside this slice raises."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; the JAX reference has it "
        f"in {module}")
