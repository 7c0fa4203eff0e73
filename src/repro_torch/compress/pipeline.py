"""Pipeline combinators (port of ``repro.compress.pipeline``, DESIGN.md §2).

``chain(a, b, ...)`` composes stages along each stage's *carrier*: stage
i's ``payload[carrier_key]`` is re-encoded by stage i+1, and stage i gets
the key ``rng.fold_in(i)``.  ``ErrorFeedback`` wraps a pipeline with the
EF-SGD residual, ``MomentumCorrection`` with DGC's momentum correction and
its warm-up sparsity schedule.  ``stage_sequence`` and
``stage_input_lens`` give the flight recorder its per-stage byte axis.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.compress.api import CommTransform, Identity, zeros_state
from repro_torch.device import resolve_device

__all__ = ["Chain", "chain", "ErrorFeedback", "error_feedback",
           "MomentumCorrection", "momentum_correction", "stage_sequence",
           "stage_input_lens"]


class Chain(CommTransform):
    """Sequential composition of stages along their carriers."""

    carrier_key = None

    def __init__(self, *stages: CommTransform):
        assert len(stages) >= 2, "use chain(...) — it handles 0/1 stages"
        for s in stages[:-1]:
            if s.carrier_key is None:
                raise ValueError(
                    f"stage {s.name!r} is terminal (no carrier) and cannot "
                    f"be followed by another stage")
        self.stages: Tuple[CommTransform, ...] = tuple(stages)
        self.name = ">>".join(s.name for s in stages)

    @property
    def biased(self):
        return any(s.biased for s in self.stages)

    @property
    def kernel_capable(self):
        return all(s.kernel_capable for s in self.stages)

    def _lens(self, n):
        """Input length seen by each stage: n, then the carrier lengths."""
        ms = [n]
        for s in self.stages[:-1]:
            ms.append(s.carrier_len(ms[-1]))
        return ms

    def init(self, shape, device=None):
        n = int(np.prod(shape))
        ms = self._lens(n)
        return tuple(s.init(tuple(shape) if i == 0 else (ms[i],), device)
                     for i, s in enumerate(self.stages))

    def encode(self, state, rng, x):
        payload, new_states, cur = {}, [], x
        last = len(self.stages) - 1
        for i, s in enumerate(self.stages):
            p, st = s.encode(state[i], rng.fold_in(i), cur)
            new_states.append(st)
            if i < last:
                p = dict(p)
                cur = p.pop(s.carrier_key)
            payload[f"s{i}"] = p
        return payload, tuple(new_states)

    def decode(self, payload, n):
        ms = self._lens(n)
        last = len(self.stages) - 1
        cur = self.stages[last].decode(payload[f"s{last}"], ms[last])
        for i in range(last - 1, -1, -1):
            p = dict(payload[f"s{i}"])
            p[self.stages[i].carrier_key] = cur
            cur = self.stages[i].decode(p, ms[i])
        return cur

    def carrier_len(self, n):
        return self.stages[-1].carrier_len(self._lens(n)[-1])

    def meta_bits(self, n):
        return sum(s.meta_bits(m) for s, m in zip(self.stages, self._lens(n)))

    def dp_rho_per_round(self):
        return sum(s.dp_rho_per_round() for s in self.stages)

    def meta_entropy_bits(self, n):
        # carrier-conditional composition (DESIGN.md §1)
        total, hint = 0.0, None
        for s, m in zip(self.stages, self._lens(n)):
            total += s.meta_entropy_bits_given(m, hint)
            hint = s.carrier_hint(m)
        return total


def stage_sequence(pipe: CommTransform) -> Tuple[CommTransform, ...]:
    """The carrier stage sequence under any wrappers: the flight
    recorder's per-stage attribution axis (:mod:`repro_torch.obs
    .telemetry`).  The wrappers (EF, DGC momentum, SecAgg, DPNoise) bill
    through ``.inner`` and carry nothing of their own, so unwrapping them
    and decomposing the innermost chain reproduces the wrapped pipeline's
    ``wire_bits``."""
    while hasattr(pipe, "inner"):
        pipe = pipe.inner
    return tuple(pipe.stages) if isinstance(pipe, Chain) else (pipe,)


def stage_input_lens(stages, n):
    """Input length each stage of a carrier sequence sees for an n-length
    leaf: ``n``, then the preceding carrier lengths (``Chain._lens``)."""
    ms = [n]
    for s in stages[:-1]:
        ms.append(s.carrier_len(ms[-1]))
    return ms


def chain(*transforms: CommTransform) -> CommTransform:
    """Compose transforms; Identity is the unit, a single stage is itself."""
    flat = []
    for t in transforms:
        if isinstance(t, Chain):
            flat.extend(t.stages)
        elif t.is_identity:
            continue
        else:
            flat.append(t)
    if not flat:
        return Identity()
    if len(flat) == 1:
        return flat[0]
    return Chain(*flat)


class _Wrapper(CommTransform):
    """Decode and byte accounting delegate to the inner pipeline."""

    biased = False
    carrier_key = None

    def __init__(self, inner: CommTransform):
        self.inner = inner

    def decode(self, payload, n):
        return self.inner.decode(payload, n)

    def meta_bits(self, n):
        return self.inner.wire_bits(n)

    def meta_entropy_bits(self, n):
        return self.inner.entropy_bits(n)

    def dp_rho_per_round(self):
        return self.inner.dp_rho_per_round()


class ErrorFeedback(_Wrapper):
    """EF-SGD: encode x + e, keep e' = (x + e) − decode(encode(x + e))."""

    def __init__(self, inner: CommTransform, decay: float = 1.0):
        super().__init__(inner)
        self.decay = decay
        self.name = f"ef({inner.name})"

    def init(self, shape, device=None):
        return {"residual": zeros_state(shape, device),
                "inner": self.inner.init(shape, device)}

    def encode(self, state, rng, x):
        y = x + self.decay * state["residual"].reshape(x.shape)
        payload, ist = self.inner.encode(state["inner"], rng, y)
        y_hat = self.inner.decode(payload, y.shape[0])
        res = (y - y_hat).reshape(state["residual"].shape)
        return payload, {"residual": res, "inner": ist}


class MomentumCorrection(_Wrapper):
    """DGC (Lin et al. 2018) momentum correction + gradient accumulation:
    u <- m·u + x; v <- v + u; transmit encode(v); the unsent part of v
    stays local and the momentum of *sent* coordinates is cleared.

    Warm-up (DGC §3.3): with ``warmup_rounds = W`` and ``final_fraction =
    f``, round r transmits the top ``f^((r+1)/(W+1))`` fraction.  The inner
    pipeline is sized for the widest (first) round and later rounds mask v
    down to the annealed support before encoding, so the wire payload and
    ``wire_bits`` stay constant while the effective sparsity anneals."""

    def __init__(self, inner: CommTransform, momentum: float = 0.9,
                 warmup_rounds: int = 0, final_fraction: float = 0.0):
        super().__init__(inner)
        self.momentum = momentum
        self.warmup_rounds = int(warmup_rounds)
        self.final_fraction = final_fraction
        self.name = f"mc{momentum:g}({inner.name})"
        if self.warmup_rounds:
            if not 0.0 < final_fraction <= 1.0:
                raise ValueError("the warm-up schedule needs the target "
                                 f"(final) fraction in (0, 1], got "
                                 f"{final_fraction}")
            self.name += f"@warmup{self.warmup_rounds}"

    def init(self, shape, device=None):
        st = {"u": zeros_state(shape, device),
              "v": zeros_state(shape, device),
              "inner": self.inner.init(shape, device)}
        if self.warmup_rounds:
            st["round"] = torch.zeros(
                (), dtype=torch.int32,
                device=resolve_device() if device is None else device)
        return st

    def _anneal_mask(self, v, rounds):
        """Zero all but the top-k_eff coordinates of v, where the effective
        fraction f_r = final^((r+1)/(W+1)) anneals down to final.  f_r is
        computed in f32 on the device as in the reference, and its order
        statistic read from the descending prefix of the schedule's static
        widest k (the round-0 fraction): ``ops._stc_threshold``'s
        construction."""
        from repro_torch.kernels.ops import _stc_threshold
        w1 = self.warmup_rounds + 1
        expo = torch.clamp(rounds + 1, max=w1).to(torch.float32) / \
            torch.tensor(float(w1), dtype=torch.float32, device=v.device)
        log_f = torch.log(torch.tensor(self.final_fraction,
                                       dtype=torch.float32, device=v.device))
        thr = _stc_threshold(v, torch.exp(expo * log_f),
                             max_fraction=self.final_fraction ** (1.0 / w1))
        return torch.where(v.abs() >= thr, v, torch.zeros_like(v))

    def encode(self, state, rng, x):
        m = torch.tensor(self.momentum, dtype=torch.float32, device=x.device)
        u = m * state["u"].reshape(x.shape) + x
        v = state["v"].reshape(x.shape) + u
        v_enc = self._anneal_mask(v, state["round"]) if self.warmup_rounds \
            else v
        payload, ist = self.inner.encode(state["inner"], rng, v_enc)
        v_hat = self.inner.decode(payload, v.shape[0])
        sent = v_hat != 0.0
        new_state = {"u": torch.where(sent, torch.zeros_like(u), u)
                     .reshape(state["u"].shape),
                     "v": (v - v_hat).reshape(state["v"].shape),
                     "inner": ist}
        if self.warmup_rounds:
            new_state["round"] = state["round"] + 1
        return payload, new_state


def error_feedback(inner: CommTransform, decay: float = 1.0) -> CommTransform:
    return ErrorFeedback(inner, decay)


def momentum_correction(inner: CommTransform, momentum: float = 0.9,
                        warmup_rounds: int = 0,
                        final_fraction: float = 0.0) -> CommTransform:
    return MomentumCorrection(inner, momentum, warmup_rounds, final_fraction)
