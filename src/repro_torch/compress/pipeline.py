"""Pipeline combinators (port of ``repro.compress.pipeline``, DESIGN.md §2).

``chain(a, b, ...)`` composes stages along each stage's *carrier*: stage
i's ``payload[carrier_key]`` is re-encoded by stage i+1, and stage i gets
the key ``rng.fold_in(i)``.  ``ErrorFeedback`` wraps a pipeline with the
EF-SGD residual.  ``MomentumCorrection`` (DGC) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.compress.api import CommTransform, Identity, zeros_state
from repro_torch.device import not_ported

__all__ = ["Chain", "chain", "ErrorFeedback", "error_feedback",
           "momentum_correction"]


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


def error_feedback(inner: CommTransform, decay: float = 1.0) -> CommTransform:
    return ErrorFeedback(inner, decay)


def momentum_correction(inner, momentum=0.9, warmup_rounds=0,
                        final_fraction=0.0):
    raise not_ported("momentum_correction (DGC)", "repro.compress.pipeline")
