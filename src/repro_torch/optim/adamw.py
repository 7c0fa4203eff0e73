"""AdamW (port of ``repro.optim.adamw``): the centralized baseline's
optimizer, on dicts of tensors with f32 moments and an int32 step."""
from __future__ import annotations

import torch

from repro_torch.optim.sgd import _zeros_f32


def adamw(lr: float, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    """``(init, update)``; the bias correction divides by ``1 - b ** t``
    with ``t`` the int32 step count."""
    def init(params):
        device = next(iter(params.values())).device
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = {k: b1 * state["m"][k] + (1 - b1) * g.to(torch.float32)
             for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2)
             * torch.square(g.to(torch.float32)) for k, g in grads.items()}
        c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
        upd = {k: -lr * (m[k] / c1 / (torch.sqrt(v[k] / c2) + eps)
                         + weight_decay * params[k].to(torch.float32))
               for k in grads}
        return upd, {"m": m, "v": v, "t": t}

    return init, update
