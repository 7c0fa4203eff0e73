"""Server-side optimizers (port of ``repro.core.server_opt``): ``fedavg``
only; the FedOpt family (fedavgm / fedadam / fedyogi) is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.core.types import FLConfig
from repro_torch.device import not_ported


def check(name: str):
    if name != "fedavg":
        raise not_ported(f"server_opt={name!r}", "repro.core.server_opt")


def init_state(name: str, params):
    check(name)
    return {}


def apply(cfg: FLConfig, params, delta, state):
    """One server step: ``params + server_lr * delta``, the add in f32 and
    cast back to each parameter's dtype."""
    check(cfg.server_opt)
    lr = cfg.server_lr
    new = {}
    for name, p in params.items():
        upd = delta[name] * lr
        new[name] = (p.to(torch.float32) + upd).to(p.dtype)
    return new, state
