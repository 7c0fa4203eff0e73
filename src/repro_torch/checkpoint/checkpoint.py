"""Flat-npz checkpoints of the port's params (port of
``repro.checkpoint``, in its file format).

One ``np.savez`` whose keys are the reference's pytree paths joined by
``/``: the port's dotted leaf names (``layers.b0.mixer.wq``) are those
paths joined by ``.``, so ``layers/b0/mixer/wq``.  A bfloat16 leaf is
written as its raw 16-bit pattern with numpy dtype ``V2``, which is how
numpy stores the reference's ``ml_dtypes`` bfloat16 arrays, and a ``V2``
array reads back as ``torch.bfloat16``: files cross between the two
packages both ways, and no ``ml_dtypes`` is needed.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_SEP = "/"


def _key(name: str) -> str:
    return _SEP.join(name.split("."))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save(path: str, params: dict) -> None:
    """Write ``params`` (leaf name -> tensor) to ``path`` (``np.savez``
    appends ``.npz`` when the path lacks it, as in the reference)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{_key(n): _to_numpy(t) for n, t in params.items()})


def restore(path: str, target: dict) -> dict:
    """The params saved at ``path``, for each leaf of ``target`` (leaf
    name -> tensor): its shape checked (a mismatch raises ValueError),
    then put on the target's device and dtype."""
    with np.load(path) as data:
        flat = dict(data)
    out = {}
    for name, leaf in target.items():
        key = _key(name)
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                             f"the target's {tuple(leaf.shape)}")
        out[name] = _to_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    return out
