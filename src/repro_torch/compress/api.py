"""CommTransform protocol and the spec-string grammar (port of
``repro.compress.api``).

    init(leaf_shape, device)  -> state          (pipeline-owned, per leaf)
    encode(state, rng, x)     -> (payload, state')
    decode(payload, n)        -> x_hat: f32[n]

on flattened f32 leaves, with the reference's byte accounting
(``meta_bits``, ``carrier_len``, ``wire_bits``, ``entropy_bits``) as plain
Python floats — the same arithmetic, so the ledgers agree exactly.

The grammar is the reference's: ``stage (">>" stage)*``, a stage being
``name[:arg,...][@suffix]*`` with suffixes ``jax`` / ``kernel`` (backend)
and ``fused`` (packed wire format).  In the port the ``jax`` backend names
the plain PyTorch path and ``kernel`` the CUDA kernels, so spec strings
stay interchangeable between the two packages.  ``rng`` is a
:class:`repro_torch.core.rng.Key` (or any object with its methods).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.compress.wire_format import WIRE_FORMATS
from repro_torch.device import not_ported, resolve_device


def _has_tensor(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return True
    if isinstance(tree, dict):
        return any(_has_tensor(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_has_tensor(v) for v in tree)
    return False


class CommTransform:
    """One stage of the communication pipeline."""

    name: str = "base"
    biased: bool = False
    carrier_key: Optional[str] = None
    backend: str = "jax"
    kernel_capable: bool = False
    wire: str = "staged"

    def init(self, shape: Sequence[int], device=None):
        """Zero-initialised per-leaf state on ``device``; stateless stages
        return ``()``."""
        return ()

    @property
    def stateful(self) -> bool:
        return _has_tensor(self.init((1,), device="meta"))

    @property
    def is_identity(self) -> bool:
        return False

    def encode(self, state, rng, x):
        raise NotImplementedError

    def decode(self, payload, n: int):
        raise NotImplementedError

    def carrier_len(self, n: int) -> int:
        return 0

    def meta_bits(self, n: int) -> float:
        raise NotImplementedError

    def meta_entropy_bits(self, n: int) -> float:
        return self.meta_bits(n)

    def carrier_hint(self, n: int):
        return None

    def meta_entropy_bits_given(self, n: int, hint=None) -> float:
        return self.meta_entropy_bits(n)

    def wire_bits(self, n: int) -> float:
        return self.meta_bits(n) + 32.0 * self.carrier_len(n)

    def entropy_bits(self, n: int) -> float:
        return self.meta_entropy_bits(n) + 32.0 * self.carrier_len(n)

    def dp_rho_per_round(self) -> float:
        return 0.0

    # stateless conveniences (the downlink hop's roundtrip)
    def compress(self, rng, x):
        payload, _ = self.encode(self.init(x.shape, device=x.device), rng, x)
        return payload

    def decompress(self, payload, n: int):
        return self.decode(payload, n)

    def roundtrip(self, rng, x):
        return self.decode(self.compress(rng, x), x.shape[0])


class Identity(CommTransform):
    """No compression — the FedAvg baseline (f32 on the wire)."""
    name = "none"
    carrier_key = "x"

    def encode(self, state, rng, x):
        return {"x": x.to(torch.float32)}, state

    def decode(self, payload, n):
        return payload["x"]

    def carrier_len(self, n):
        return n

    def meta_bits(self, n):
        return 0.0

    @property
    def is_identity(self):
        return True


BACKENDS = ("jax", "kernel")

_REGISTRY: Dict[str, Callable[..., CommTransform]] = {}
_STAGES: Dict[str, Callable[..., CommTransform]] = {}

# stage names the JAX reference registers that the port has not ported
_NOT_PORTED = {
    "sbc": "repro.compress.sparsification",
    "randmask": "repro.compress.sparsification",
    "sketch": "repro.compress.sketch",
    "hsq": "repro.compress.quantization",
    "uveq": "repro.compress.quantization",
    "secagg": "repro.compress.secure_agg",
    "dpnoise": "repro.compress.secure_agg",
}


def register(name: str):
    """Register a legacy-name factory (kwargs-driven, e.g. ``qsgd8``)."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def register_stage(name: str):
    """Register a stage factory for the spec grammar (``qsgd`` for
    ``"qsgd:8"``)."""
    def deco(fn):
        _STAGES[name] = fn
        return fn
    return deco


def _num(tok: str):
    tok = tok.strip()
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def _make_stage(token: str, **kw) -> CommTransform:
    parts = [p.strip() for p in token.strip().split("@")]
    token, suffixes = parts[0], parts[1:]
    explicit_backend = explicit_wire = None
    for s in suffixes:
        if s == "fused":
            explicit_wire = "packed"
        elif s in BACKENDS:
            explicit_backend = s
        else:
            raise ValueError(
                f"unknown backend {s!r}; have {BACKENDS} (or 'fused' for "
                f"the packed wire format)")
    backend = explicit_backend or kw.get("backend", "jax")
    wire = explicit_wire or kw.get("wire_format", "staged")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; have {WIRE_FORMATS}")
    kw = dict(kw, backend=backend, wire=wire)
    if token in ("none", "identity", ""):
        stage = Identity()
    else:
        name, _, argstr = token.partition(":")
        name = name.strip()
        if not argstr and name in _REGISTRY:
            stage = _REGISTRY[name](**kw)
        elif name in _NOT_PORTED:
            raise not_ported(f"compressor stage {name!r}", _NOT_PORTED[name])
        elif name not in _STAGES:
            known = sorted(set(_REGISTRY) | set(_STAGES))
            raise KeyError(f"unknown compressor stage {token!r}; have {known}")
        else:
            args = ([_num(a) for a in argstr.split(",") if a.strip()]
                    if argstr else [])
            stage = _STAGES[name](*args, **kw)
    if explicit_backend == "kernel" and not stage.kernel_capable:
        raise ValueError(
            f"stage {token!r} has no kernel backend (kernel-capable stages: "
            f"topk, qsgd, ternary, sketch — see DESIGN.md §6)")
    if explicit_wire == "packed" and stage.wire != "packed":
        raise ValueError(
            f"stage {token!r} has no packed wire format (packable stages: "
            f"ternary, qsgd with bits <= 4, stc — see DESIGN.md §10)")
    return stage


def make_compressor(spec: Optional[str], **kw) -> CommTransform:
    """Build a pipeline from a registry name or spec string, e.g.
    ``make_compressor("topk:0.05>>qsgd:8", backend="kernel")``."""
    if spec in ("none", None, ""):
        return Identity()
    from repro_torch.compress.pipeline import chain   # late import (cycle)
    return chain(*[_make_stage(tok, **kw) for tok in spec.split(">>")])


def zeros_state(shape, device):
    """A zero f32 state array (the init contract), on ``device`` (``None``
    means the default CUDA device)."""
    return torch.zeros(tuple(shape), dtype=torch.float32,
                       device=resolve_device() if device is None else device)


register("none")(lambda **kw: Identity())
register_stage("none")(lambda **kw: Identity())
register_stage("identity")(lambda **kw: Identity())
