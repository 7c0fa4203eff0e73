"""Minimal client / centralized optimizers (port of ``repro.optim.sgd``):
plain functions on dicts of tensors, the state in f32."""
from __future__ import annotations

import torch


def _zeros_f32(params):
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def sgd(lr: float, momentum: float = 0.0):
    """``(init, update)``: ``update(grads, state, params)`` returns (the
    f32 update ``-lr * g``, or ``-lr * m`` with ``m = momentum * m + g``,
    and the new state)."""
    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": _zeros_f32(params)}

    def update(grads, state, params):
        if momentum == 0.0:
            upd = {k: -lr * g.to(torch.float32) for k, g in grads.items()}
            return upd, state
        m = {k: momentum * state["m"][k] + g.to(torch.float32)
             for k, g in grads.items()}
        return {k: -lr * m_ for k, m_ in m.items()}, {"m": m}

    return init, update


def apply_updates(params, updates):
    """``params + updates`` in f32, cast back to each param's dtype."""
    return {k: (p.to(torch.float32) + updates[k]).to(p.dtype)
            for k, p in params.items()}
