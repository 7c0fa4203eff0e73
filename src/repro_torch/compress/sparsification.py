"""Sparsification stages (port of ``repro.compress.sparsification``).

  * ``topk``    — magnitude top-k with a (values, indices) wire format;
  * ``ternary`` — STC's quantizer as a chainable stage: sign(x)·mean(|x|),
    int8 signs or 2-bit packed (``@fused``);
  * ``stc``     — the legacy name for ``chain(topk, ternary)``, or under
    ``@fused`` the dense packed :class:`FusedSTC` stage.

``sbc`` and ``randmask`` raise ``NotImplementedError`` from the spec
grammar.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compress.api import CommTransform, register, register_stage


def _k(n, fraction):
    return max(1, int(round(n * fraction)))


def top_k_indices(x, k):
    """Indices of the k largest |x|, magnitude descending, ties broken by
    ascending index — ``lax.top_k``'s order, which the reference relies on.
    Returns (indices int64 (k,), the k-th largest |x| as a (1,) tensor)."""
    order = torch.sort(-x.abs(), stable=True)
    return order.indices[:k], -order.values[k - 1:k]


class TopK(CommTransform):
    """Magnitude top-k with a (values, indices) wire format.

    ``backend="kernel"``: the dense masking pass runs through the fused
    ``threshold_sparsify`` CUDA kernel, the threshold staying on the device;
    the payload values are gathered from its masked vector (``kept[idx] ==
    x[idx]`` bit for bit).  Like the reference, the kernel's residual is
    not used: ``ErrorFeedback`` recomputes it from the decode."""
    biased = True
    carrier_key = "vals"
    kernel_capable = True

    def __init__(self, fraction=0.01, backend="jax"):
        self.fraction = fraction
        self.backend = backend
        self.name = f"topk{fraction:g}" + \
            ("@kernel" if backend == "kernel" else "")

    def encode(self, state, rng, x):
        k = _k(x.shape[0], self.fraction)
        idx, thresh = top_k_indices(x, k)
        if self.backend == "kernel":
            from repro_torch.kernels import ops
            kept, _ = ops.threshold_sparsify(x, thresh)
            return {"vals": kept[idx], "idx": idx.to(torch.int32)}, state
        return {"vals": x[idx], "idx": idx.to(torch.int32)}, state

    def decode(self, payload, n):
        vals = payload["vals"]
        out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
        out[payload["idx"].long()] = vals.to(torch.float32)
        return out

    def carrier_len(self, n):
        return _k(n, self.fraction)

    def meta_bits(self, n):
        return _k(n, self.fraction) * 32.0       # int32 indices

    def meta_entropy_bits(self, n):
        k = _k(n, self.fraction)
        idx_bits = math.log2(max(n / k, 2.0)) + 2      # Golomb-coded gaps
        return k * idx_bits

    def carrier_hint(self, n):
        return {"kind": "top_tail", "fraction": _k(n, self.fraction) / n}


class Ternary(CommTransform):
    """Ternarization to ±mean(|x|), STC's quantizer as a chainable stage.

    ``backend="kernel"``: the signs and the |x| partial sums come from one
    ternarize pass at threshold 0 (``ops.ternarize_signs``); mu divides by
    the *logical* n, since pad lanes pass a zero threshold too.  Signs are
    exact; mu differs from the plain path's mean by summation order only
    (bounded-ULP, DESIGN.md §6).

    ``wire="packed"`` (``@fused``): the payload is the 2-bit packed sign
    vector, ``8*ceil(n/4) + 32`` wire bits instead of ``8n + 32``; the
    kernel path packs inside the ternarize pass."""
    biased = True
    kernel_capable = True

    def __init__(self, block=2048, backend="jax", wire="staged"):
        self.block = block
        self.backend = backend
        self.wire = wire
        self.name = ("ternary" + ("@kernel" if backend == "kernel" else "")
                     + ("@fused" if wire == "packed" else ""))

    def encode(self, state, rng, x):
        n = x.shape[0]
        if self.backend == "kernel":
            from repro_torch.kernels import ops
            # divide by a tensor: on CUDA a division by a Python scalar is a
            # multiplication by its reciprocal
            count = torch.tensor(float(n), dtype=torch.float32,
                                 device=x.device)
            if self.wire == "packed":
                packed, abs_sum = ops.ternarize_signs_packed(x, self.block)
                return {"mu": abs_sum / count, "sign2": packed}, state
            sign, abs_sum = ops.ternarize_signs(x, self.block)
            return {"mu": abs_sum / count, "sign": sign}, state
        mu = x.abs().mean()
        sign = torch.sign(x).to(torch.int8)
        if self.wire == "packed":
            from repro_torch.compress.wire_format import pack2
            return {"mu": mu, "sign2": pack2(sign)}, state
        return {"mu": mu, "sign": sign}, state

    def decode(self, payload, n):
        if self.wire == "packed":
            from repro_torch.compress.wire_format import unpack2
            sign = unpack2(payload["sign2"], n)
        else:
            sign = payload["sign"]
        return sign.to(torch.float32) * payload["mu"]

    def meta_bits(self, n):
        if self.wire == "packed":
            return 8.0 * (-(-n // 4)) + 32.0     # 2-bit packed signs + mu
        return 8.0 * n + 32.0                    # int8 signs + f32 mu

    def meta_entropy_bits(self, n):
        return 1.0 * n + 32.0                    # 1 bit/sign after packing


class FusedSTC(CommTransform):
    """``stc@fused``: the dense packed STC wire format (DESIGN.md §10).

    2-bit ternary codes over the FULL length and one f32 mu, no indices:
    ``8*ceil(n/4) + 32`` bits.  The kernel path is one top-k for the
    threshold, then ONE ternarize + pack pass
    (``ops.stc_ternarize_packed``).

    Support: every |x| >= the k-th magnitude is kept, so exact magnitude
    ties may keep more than k coordinates (the staged chain keeps exactly
    k, by index order)."""
    biased = True
    kernel_capable = True
    wire = "packed"

    def __init__(self, fraction=0.01, block=2048, backend="jax"):
        self.fraction = fraction
        self.block = block
        self.backend = backend
        self.name = (f"stc{fraction:g}"
                     + ("@kernel" if backend == "kernel" else "") + "@fused")

    def encode(self, state, rng, x):
        n = x.shape[0]
        if self.backend == "kernel":
            from repro_torch.kernels import ops
            packed, mu = ops.stc_ternarize_packed(x, self.fraction,
                                                  self.block)
            return {"mu": mu, "code2": packed}, state
        from repro_torch.compress.wire_format import pack2
        mag = x.abs()
        thresh = torch.topk(mag, _k(n, self.fraction), sorted=False) \
            .values.min()
        keep = mag >= thresh
        code = (torch.sign(x) * keep).to(torch.int8)
        kept = torch.where(keep, mag, torch.zeros((), dtype=mag.dtype,
                                                  device=mag.device))
        mu = kept.sum() / torch.clamp(keep.sum(), min=1)
        return {"mu": mu, "code2": pack2(code)}, state

    def decode(self, payload, n):
        from repro_torch.compress.wire_format import unpack2
        return unpack2(payload["code2"], n).to(torch.float32) * \
            payload["mu"]

    def meta_bits(self, n):
        return 8.0 * (-(-n // 4)) + 32.0         # 2-bit packed codes + mu

    def meta_entropy_bits(self, n):
        # k gap-coded positions + 1 sign bit each, never more than the
        # packed wire itself
        k = _k(n, self.fraction)
        idx_bits = math.log2(max(n / k, 2.0)) + 2
        return min(k * (idx_bits + 1.0) + 32.0, self.meta_bits(n))


def _stc(fraction=0.01, block=2048, backend="jax", wire="staged"):
    if wire == "packed":
        return FusedSTC(fraction, block, backend)
    from repro_torch.compress.pipeline import chain
    return chain(TopK(fraction, backend), Ternary(block, backend))


register("topk")(lambda fraction=0.01, backend="jax", **kw:
                 TopK(fraction, backend))
register("stc")(lambda fraction=0.01, block=2048, backend="jax",
                wire="staged", **kw: _stc(fraction, block, backend, wire))
register_stage("topk")(lambda frac=None, fraction=0.01, backend="jax", **kw:
                       TopK(float(frac if frac is not None else fraction),
                            backend))
register_stage("ternary")(lambda block=2048, backend="jax", wire="staged",
                          **kw: Ternary(int(block), backend, wire))
register_stage("stc")(lambda frac=None, fraction=0.01, block=2048,
                      backend="jax", wire="staged", **kw:
                      _stc(float(frac if frac is not None else fraction),
                           int(block), backend, wire))
