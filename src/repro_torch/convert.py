"""Parameter conversion between the JAX reference and the port.

``params_from_jax`` takes the reference's parameter pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the port's flat
``dict[str, Tensor]`` in ``jax.tree.leaves`` order; ``params_to_jax`` is
its inverse (nested dicts of numpy arrays).  bfloat16 arrays arrive as
``ml_dtypes`` numpy arrays and cross as their raw 16-bit patterns.

``state_from_jax`` carries pipeline state (EF residuals, DGC momentum and
accumulators, the warm-up round counter) across: it fills the port's state
structure with the reference's arrays, given in ``jax.tree.leaves`` order
(tuples in order, dict keys sorted).  ``hash_params_from_jax`` takes the
reference's count-sketch hash parameters (uint32 arrays) in the port's
int64 form.  No function here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, device="cpu") -> dict:
    """Nested dict of arrays -> flat ``{dotted path: Tensor}`` (sorted keys
    at every level, which is ``jax.tree.leaves`` order)."""
    out = {}

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = _to_tensor(v).to(device)
    walk(tree, "")
    return out


def params_to_jax(params: dict) -> dict:
    """Flat ``{dotted path: Tensor}`` -> nested dict of numpy arrays."""
    out: dict = {}
    for key, t in params.items():
        node = out
        *heads, last = key.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = _to_numpy(t)
    return out


def state_from_jax(template, leaves, device="cpu"):
    """The port's state ``template`` (e.g. ``engine.comm_state_init``'s)
    with each tensor replaced by the next array of ``leaves``, walked in
    ``jax.tree.leaves`` order.  Shapes and dtypes must agree."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, torch.Tensor):
            t = _to_tensor(next(it)).to(device)
            if t.shape != node.shape or t.dtype != node.dtype:
                raise ValueError(f"state leaf {tuple(t.shape)} {t.dtype} "
                                 f"does not fit {tuple(node.shape)} "
                                 f"{node.dtype}")
            return t
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if isinstance(node, tuple):
            return tuple(fill(v) for v in node)
        return node

    out = fill(template)
    if next(it, None) is not None:
        raise ValueError("more state leaves than the template holds")
    return out


def hash_params_from_jax(a, b):
    """The reference's ``hash_params`` arrays (uint32, numpy) as the port's
    (a, b): int64 CPU tensors holding the uint32 values."""
    return tuple(torch.from_numpy(np.asarray(v, dtype=np.uint32)
                                  .astype(np.int64)) for v in (a, b))
