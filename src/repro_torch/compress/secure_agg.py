"""Privacy stages for the wire stack (port of ``repro.compress.secure_agg``,
DESIGN.md §11).

Two wrapping ``CommTransform``s ride the spec grammar, the ledger and the
state threading, as in the reference:

``secagg`` masks every integer plane of a quantizing pipeline's payload
(int8 QSGD levels, uint8 packed bytes, int32 top-k indices) with a
pairwise ring mask over Z_{2^w} (w the plane's bit width):

    m_i = g(i) - g((i-1) mod C),   g(e) = bits(fold_in(mask_key, e))

so the masks of a full cohort telescope to 0 mod 2^w and the sum of the
masked planes equals the sum of the clear planes bit for bit.  The
reference adds in the plane's own dtype and relies on XLA's
two's-complement wrap; the port computes every mask and masked plane in
int64, reduces it mod 2^w and converts the result to the plane's dtype
value for value (a signed plane takes the two's-complement value), so
no op relies on signed overflow and no uint16/uint32 arithmetic is
needed.  The mask context (key, ring index, cohort) sits in the comm
state; each wire hop injects its own with :func:`inject_mask_ctx` before
encoding, and the payload carries it (``secagg_ctx``) so that decode
re-derives and subtracts the mask per client.  The context is not billed
(``CTX_BITS`` per leaf ride out of band).  ``secagg`` refuses float
carriers: an f32 plane has no modular group to cancel in.

``dpnoise:<sigma>[,<clip>]`` clips each of the model's L leaves to
``clip / sqrt(L)`` (so the whole update's L2 norm is at most ``clip``)
and adds N(0, (sigma * clip)^2) noise, drawn from ``rng.fold_in(DP_TAG)``,
before the inner pipeline encodes; the inner rng stream is passed on
untouched, so ``sigma=0, clip=inf`` is a bit-exact no-op.  rho = 1 /
(2 sigma^2) per client per round rides the ledger (``dp_rho``).  The
leaf's L2 norm reduces in another order than XLA's, so a clipped leaf is
within ULPs of the reference's, not bit-equal.

Keys are :class:`repro_torch.core.rng.Key` objects (or any object with
their methods); the mask draws use ``Key.bits``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compress.api import CommTransform
from repro_torch.device import resolve_device

__all__ = ["SecAgg", "DPNoise", "PRIVACY_STAGES", "make_privacy_stage",
           "has_mask_ctx", "inject_mask_ctx", "drop_mask_ctx", "ring_mask",
           "mask_payload", "dropout_correction", "zcdp_epsilon",
           "bind_n_leaves", "MASK_TAG", "DP_TAG", "CTX_BITS"]

PRIVACY_STAGES = ("secagg", "dpnoise")

MASK_TAG = 0x5eca66      # folds the round key into the shared mask-key stream
DP_TAG = 0xd9015e        # folds the per-client rng into the DP noise stream
CTX_BITS = 128           # per-leaf secagg_ctx: key u32[2] + idx i32 + cohort i32

_PROBE_N = 4096          # carrier probe length for the construction-time guard


# ---------------------------------------------------------------------------
# Mask algebra over Z_{2^w}
# ---------------------------------------------------------------------------

def _is_int_plane(t) -> bool:
    return (isinstance(t, torch.Tensor) and not t.dtype.is_floating_point
            and not t.dtype.is_complex and t.dtype != torch.bool)


def _wrap(v: torch.Tensor, dtype) -> torch.Tensor:
    """int64 ``v`` reduced mod 2^w, as ``dtype``'s value (two's complement
    for a signed dtype)."""
    w = torch.iinfo(dtype).bits
    v = torch.bitwise_and(v, (1 << w) - 1)          # in [0, 2^w)
    if dtype.is_signed:
        v = torch.where(v >= (1 << (w - 1)), v - (1 << w), v)
    return v.to(dtype)


def _mask64(key, idx, cohort, ref, plane=None):
    """Client ``idx``'s ring mask in [0, 2^w) as int64 (from
    ``key.fold_in(plane)`` when a plane id is given), or None when the
    cohort is below 2 (the uninjected zero context: no mask, no key)."""
    coh = max(int(cohort), 1)
    if coh < 2:
        return None
    if plane is not None:
        key = key.fold_in(plane)
    w = torch.iinfo(ref.dtype).bits
    if w > 32:
        raise ValueError(f"secagg masks planes of at most 32 bits, got "
                         f"{ref.dtype}")
    i = int(idx) % coh
    prev = (i + coh - 1) % coh
    return (key.fold_in(i).bits(ref.shape, w, ref.device)
            - key.fold_in(prev).bits(ref.shape, w, ref.device))


def ring_mask(key, idx, cohort, ref):
    """Client ``idx``'s pairwise mask m_i = g(i) - g((i-1) mod C) in the
    dtype of ``ref``.  The sum over idx = 0..C-1 telescopes to 0 mod 2^w;
    ``cohort < 2`` gives a zero mask."""
    m = _mask64(key, idx, cohort, ref)
    if m is None:
        return torch.zeros_like(ref)
    return _wrap(m, ref.dtype)


def _map_int_leaves(tree, fn):
    """Apply ``fn(plane_id, leaf)`` to every integer tensor of ``tree``;
    the plane id counts the tensors in ``jax.tree.leaves`` order (dict keys
    sorted, tuples in order), the id both sides of the wire agree on."""
    count = [0]

    def walk(node):
        if isinstance(node, torch.Tensor):
            i = count[0]
            count[0] += 1
            return fn(i, node) if _is_int_plane(node) else node
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(tree)


def mask_payload(body, key, idx, cohort, sign):
    """Add (sign=+1) or subtract (sign=-1) the ring mask on every integer
    plane of a payload tree, in int64 reduced mod 2^w.  Float side info
    (scales, mu) stays clear."""
    def one(i, leaf):
        m = _mask64(key, idx, cohort, leaf, plane=i)
        if m is None:
            return leaf
        v = leaf.to(torch.int64)
        return _wrap(v + m if sign > 0 else v - m, leaf.dtype)
    return _map_int_leaves(body, one)


def dropout_correction(key, drop_idx, cohort, template):
    """The dropped client's mask tree m_d over ``template``'s integer
    planes: a code-plane sum over a cohort missing client d equals the
    clear sum minus m_d, so adding this tree back restores it exactly."""
    def one(i, leaf):
        m = _mask64(key, drop_idx, cohort, leaf, plane=i)
        return torch.zeros_like(leaf) if m is None else _wrap(m, leaf.dtype)
    return _map_int_leaves(template, one)


def zcdp_epsilon(rho, delta=1e-5):
    """Convert cumulative zCDP rho to (epsilon, delta)-DP."""
    rho = float(rho)
    if rho <= 0.0:
        return 0.0
    if not math.isfinite(rho):
        return float("inf")
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))


# ---------------------------------------------------------------------------
# Mask-context threading helpers (used by the engine wire hops)
# ---------------------------------------------------------------------------

def has_mask_ctx(pipe) -> bool:
    """True if the pipeline contains a SecAgg stage anywhere (so a wire hop
    must inject (key, idx, cohort) into the comm state before encoding)."""
    if isinstance(pipe, SecAgg):
        return True
    stages = getattr(pipe, "stages", None)
    if stages is not None:
        return any(has_mask_ctx(s) for s in stages)
    inner = getattr(pipe, "inner", None)
    return has_mask_ctx(inner) if inner is not None else False


def bind_n_leaves(pipe, n_leaves: int) -> int:
    """Tell every DPNoise stage inside ``pipe`` how many parameter leaves
    the model it encodes has (the per-leaf clip share ``clip/sqrt(L)``);
    returns the number of stages bound."""
    n_leaves = int(n_leaves)
    if n_leaves < 1:
        raise ValueError(f"n_leaves must be >= 1, got {n_leaves}")
    if isinstance(pipe, DPNoise):
        pipe.n_leaves = n_leaves
        return 1 + bind_n_leaves(pipe.inner, n_leaves)
    bound = 0
    stages = getattr(pipe, "stages", None)
    if stages is not None:
        bound += sum(bind_n_leaves(s, n_leaves) for s in stages)
    inner = getattr(pipe, "inner", None)
    if inner is not None:
        bound += bind_n_leaves(inner, n_leaves)
    return bound


def inject_mask_ctx(state, key, idx, cohort):
    """Rewrite every SecAgg mask context in a comm-state tree with (key,
    ring index, cohort); states without a context pass through."""
    if isinstance(state, dict):
        out = {k: inject_mask_ctx(v, key, idx, cohort)
               for k, v in state.items()}
        if "mask_key" in out:
            out.update(mask_key=key, mask_idx=idx, mask_cohort=cohort)
        return out
    if isinstance(state, (tuple, list)):
        return type(state)(inject_mask_ctx(v, key, idx, cohort)
                           for v in state)
    return state


def drop_mask_ctx(state):
    """Strip SecAgg context entries from a comm-state tree, recovering the
    tree an unmasked pipeline would hold."""
    if isinstance(state, dict):
        if "mask_key" in state:
            return drop_mask_ctx(state["inner"])
        return {k: drop_mask_ctx(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(drop_mask_ctx(v) for v in state)
    return state


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------

class SecAgg(CommTransform):
    """Pairwise-mask the integer code planes of ``inner``'s payload.

    The state is ``{"mask_key": key or None, "mask_idx": () int32,
    "mask_cohort": () int32, "inner": ...}``; the zero context (cohort 0)
    leaves the payload clear.  Byte accounting is the inner pipeline's;
    ``entropy_bits`` collapses to ``wire_bits`` (masked codes are
    uniform)."""

    carrier_key = None        # wrapping transform, not a chainable stage

    def __init__(self, inner: CommTransform):
        if has_mask_ctx(inner):
            raise ValueError("secagg is already in this pipeline; "
                             "masks are applied once, at the outermost "
                             "integer code domain")
        if inner.carrier_len(_PROBE_N) > 0:
            raise ValueError(
                f"secagg masks integer code domains, but {inner.name!r} "
                f"leaves a float32 carrier on the wire — chain a quantizing "
                f"carrier before secagg (e.g. 'qsgd:4>>secagg', "
                f"'topk:0.05>>qsgd:4>>secagg', 'ternary>>secagg')")
        self.inner = inner
        self.name = f"{inner.name}>>secagg"

    @property
    def biased(self):
        return self.inner.biased

    @property
    def kernel_capable(self):
        return self.inner.kernel_capable

    @property
    def wire(self):
        return self.inner.wire

    @property
    def backend(self):
        return self.inner.backend

    def init(self, shape, device=None):
        dev = resolve_device() if device is None else device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        return {"mask_key": None, "mask_idx": zero(), "mask_cohort": zero(),
                "inner": self.inner.init(shape, device)}

    def encode(self, state, rng, x):
        # the inner pipeline sees the rng stream unmodified: masked and
        # clear runs draw the same quantization randomness
        payload, ist = self.inner.encode(state["inner"], rng, x)
        key = state["mask_key"]
        idx, coh = int(state["mask_idx"]), int(state["mask_cohort"])
        out = dict(mask_payload(payload, key, idx, coh, +1))
        out["secagg_ctx"] = {"key": key, "idx": idx, "cohort": coh}
        ctx = lambda v: torch.full((), v, dtype=torch.int32, device=x.device)
        return out, dict(state, mask_idx=ctx(idx), mask_cohort=ctx(coh),
                         inner=ist)

    def decode(self, payload, n: int):
        p = dict(payload)
        ctx = p.pop("secagg_ctx")
        body = mask_payload(p, ctx["key"], ctx["idx"], ctx["cohort"], -1)
        return self.inner.decode(body, n)

    def meta_bits(self, n):
        return self.inner.wire_bits(n)

    def meta_entropy_bits(self, n):
        return self.inner.wire_bits(n)   # masked planes are incompressible

    def dp_rho_per_round(self):
        return self.inner.dp_rho_per_round()


class DPNoise(CommTransform):
    """Client-level clip + Gaussian noise ahead of ``inner``'s encode.

    ``clip`` bounds the L2 norm of the whole per-client update: each of
    ``n_leaves`` leaves (bound by the engine with :func:`bind_n_leaves`)
    is clipped to ``clip / sqrt(n_leaves)`` and perturbed with std
    ``sigma * clip``.  State, decode and byte accounting are the inner
    pipeline's; with ``sigma == 0`` and an infinite clip the stage is a
    bit-exact no-op."""

    carrier_key = None

    def __init__(self, inner: CommTransform, sigma: float, clip: float = 1.0):
        sigma, clip = float(sigma), float(clip)
        if sigma < 0.0:
            raise ValueError(f"dpnoise sigma must be >= 0, got {sigma}")
        if clip <= 0.0:
            raise ValueError(f"dpnoise clip must be > 0 (use inf to disable "
                             f"clipping), got {clip}")
        if sigma > 0.0 and not math.isfinite(clip):
            raise ValueError("dpnoise with sigma > 0 needs a finite clip — "
                             "unbounded sensitivity has no DP guarantee")
        self.inner = inner
        self.sigma = sigma
        self.clip = clip
        self.n_leaves = 1            # rebound per model via bind_n_leaves
        self.name = f"{inner.name}>>dpnoise:{sigma:g}" + \
            (f",{clip:g}" if clip != 1.0 else "")

    @property
    def biased(self):
        return self.inner.biased

    @property
    def kernel_capable(self):
        return self.inner.kernel_capable

    @property
    def wire(self):
        return self.inner.wire

    @property
    def backend(self):
        return self.inner.backend

    def init(self, shape, device=None):
        return self.inner.init(shape, device)

    def encode(self, state, rng, x):
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
        y = x
        if math.isfinite(self.clip):
            # this leaf's equal share of the joint L2 budget
            leaf_clip = self.clip / math.sqrt(self.n_leaves)
            nrm = torch.linalg.vector_norm(y)
            y = y * torch.minimum(
                f32(1.0), f32(leaf_clip) / torch.maximum(nrm, f32(1e-12)))
        if self.sigma > 0.0:
            # std is sigma x the joint sensitivity (clip, not leaf_clip)
            z = rng.fold_in(DP_TAG).normal(tuple(y.shape), y.device)
            y = y + f32(self.sigma * self.clip) * z
        return self.inner.encode(state, rng, y)

    def decode(self, payload, n):
        return self.inner.decode(payload, n)

    def meta_bits(self, n):
        return self.inner.wire_bits(n)

    def meta_entropy_bits(self, n):
        return self.inner.entropy_bits(n)

    def dp_rho_per_round(self):
        if self.sigma == 0.0:
            return self.inner.dp_rho_per_round()
        return 0.5 / (self.sigma * self.sigma) + \
            self.inner.dp_rho_per_round()


# ---------------------------------------------------------------------------
# Spec-grammar hook (consumed by api.make_compressor)
# ---------------------------------------------------------------------------

def make_privacy_stage(token: str, inner: CommTransform,
                       **kw) -> CommTransform:
    """Wrap ``inner`` with the privacy stage named by a spec token
    (``"secagg"``, ``"dpnoise:0.8"``, ``"dpnoise:0.8,1.0"``; a second ``:``
    is accepted as the clip separator)."""
    token = token.strip()
    if "@" in token:
        raise ValueError(
            f"privacy stage {token!r} takes no @suffix — put @kernel/@fused "
            f"on the carrier stages (e.g. 'ternary@fused>>secagg')")
    name, _, argstr = token.partition(":")
    name = name.strip()
    args = [float(a) for a in argstr.replace(":", ",").split(",")
            if a.strip()] if argstr else []
    if name == "secagg":
        if args:
            raise ValueError(f"secagg takes no args, got {token!r}")
        return SecAgg(inner)
    if name == "dpnoise":
        if not args:
            raise ValueError("dpnoise needs a sigma: 'dpnoise:<sigma>"
                             "[,<clip>]' (clip defaults to 1.0)")
        clip = args[1] if len(args) > 1 else float(kw.get("dp_clip", 1.0))
        return DPNoise(inner, args[0], clip)
    raise KeyError(f"unknown privacy stage {token!r}; have {PRIVACY_STAGES}")
