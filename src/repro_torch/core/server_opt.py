"""Server-side optimizers applied to the aggregated client delta (port of
``repro.core.server_opt``): ``fedavg`` and the FedOpt family (FedAvgM,
FedAdam, FedYogi — Reddi et al., "Adaptive Federated Optimization").

``delta`` is the weighted-mean client improvement (a pseudo-gradient of
-delta).  With a ``staleness`` tau the moment innovations are scaled by
``s = (1 + tau)^(-staleness_alpha)``:

    m <- b1 * m + (1 - b1) * s * delta
    v <- b2 * v + (1 - b2) * s * delta^2                  (FedAdam)
    v <- v - (1 - b2) * s * delta^2 * sign(v - delta^2)   (FedYogi)
    m <- b1 * m + s * delta                               (FedAvgM)

and the parameter update keeps its form; without one (the synchronous
round) the update is the classical one, op for op.

Every update runs leaf by leaf: a leaf's new ``m`` and ``v`` and its new
parameter are made before the next leaf's, so the temporaries are one
leaf's and the new state is the only second copy of the moments.
Python-float constants enter as 0-dim tensors of the operand's dtype
(:func:`scalar_like`), as JAX's weakly typed scalars do.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import FLConfig
from repro_torch.models.layers import scalar_like

_STATE_KEYS = {"fedavg": [], "fedavgm": ["m"],
               "fedadam": ["m", "v"], "fedyogi": ["m", "v"]}


def state_keys(name: str):
    return list(_STATE_KEYS[name])


def init_state(name: str, params):
    """Zero f32 moments shaped like ``params`` (a flat dict of tensors)."""
    if name not in _STATE_KEYS:
        raise ValueError(name)
    return {k: {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()} for k in _STATE_KEYS[name]}


def staleness_scale(cfg: FLConfig, staleness, alpha=None) -> torch.Tensor:
    """The moment-innovation scale s = (1 + tau)^(-alpha) in f32.
    ``alpha`` defaults to ``cfg.staleness_alpha``."""
    tau = torch.as_tensor(staleness, dtype=torch.float32)
    a = cfg.staleness_alpha if alpha is None else alpha
    return torch.pow(1.0 + tau, torch.tensor(-a, dtype=torch.float32,
                                             device=tau.device))


def _sqrt(v):
    """f32 sqrt, correctly rounded as the reference's: PyTorch's
    vectorized CPU sqrt is not (one ULP off on about 0.6% of inputs); a
    sqrt in f64 rounded once to f32 is (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(v.to(torch.float64)).to(torch.float32)


def _add(p, u):
    return (p.to(torch.float32) + u).to(p.dtype)


def apply(cfg: FLConfig, params, delta, state, staleness=None,
          staleness_alpha=None):
    """One server step: ``params + f(delta)`` per ``cfg.server_opt``.
    Returns ``(new params, new state)``.  ``staleness`` (optional f32
    scalar, the aggregated delta's mean staleness) scales the adaptive
    moment innovations and never touches plain ``fedavg``;
    ``staleness_alpha`` overrides ``cfg.staleness_alpha``."""
    opt, lr = cfg.server_opt, cfg.server_lr
    if opt not in _STATE_KEYS:
        raise ValueError(opt)
    if opt == "fedavg":
        return {n: _add(p, delta[n] * lr) for n, p in params.items()}, state

    s = None
    if staleness is not None:
        s = staleness_scale(cfg, staleness, staleness_alpha)
    _s = (lambda x: x) if s is None else (lambda x: s.to(x.device) * x)
    c = scalar_like
    new_params, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        d, m_ = delta[n], state["m"][n]
        if opt == "fedavgm":
            m = c(cfg.server_beta1, m_) * m_ + _s(d)
            new_m[n] = m
            new_params[n] = _add(p, c(lr, m) * m)
            continue
        b1, b2, eps = cfg.server_beta1, cfg.server_beta2, cfg.server_eps
        v_ = state["v"][n]
        m = c(b1, m_) * m_ + c(1 - b1, d) * _s(d)
        d2 = d * d
        if opt == "fedadam":
            v = c(b2, v_) * v_ + c(1 - b2, d) * _s(d2)
        else:                                               # fedyogi
            v = v_ - c(1 - b2, d) * _s(d2) * torch.sign(v_ - d2)
        new_m[n], new_v[n] = m, v
        new_params[n] = _add(p, c(lr, m) * m / (_sqrt(v) + c(eps, v)))
    if opt == "fedavgm":
        return new_params, {"m": new_m}
    return new_params, {"m": new_m, "v": new_v}
