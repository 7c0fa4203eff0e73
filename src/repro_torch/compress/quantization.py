"""Quantization stages (port of ``repro.compress.quantization``).

  * ``qsgd:<bits>`` (and the legacy ``qsgd8`` / ``qsgd4`` / ``lfl8``) —
    stochastic uniform quantization with a per-block scale;
  * ``hsq``  — 1-bit sign with a per-block mean magnitude (biased);
  * ``uveq`` — subtractive-dither uniform quantization (unbiased).

The entropy model ``_tail_elias_bits_per_coord`` is a copy of the
reference's host arithmetic, so ``entropy_bits`` agrees exactly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.compress.api import CommTransform, register, register_stage
from repro_torch.kernels.ref import blocked, to_int8


def _norm_ppf(p: float) -> float:
    """Standard-normal quantile via bisection on math.erf."""
    lo, hi = 0.0, 12.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if 0.5 * (1.0 + math.erf(mid / math.sqrt(2.0))) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _tail_elias_bits_per_coord(levels: int, f: float, n: int,
                               block: int) -> float:
    """Expected Elias-gamma bits per coordinate when the quantizer input is
    the top-``f`` |x| tail of a Gaussian (a top-k carrier)."""
    t = _norm_ppf(1.0 - f / 2.0)
    bl = max(1, min(block, n))
    scale = _norm_ppf(1.0 - f / (2.0 * bl))
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    xs = np.linspace(t, scale, 513)
    dens = np.exp(-xs * xs / 2.0)
    lev = np.minimum(levels * xs / scale, float(levels))
    bits = 2.0 * np.log2(2.0 * lev + 1.0)
    z = trapezoid(dens, xs)
    return float(trapezoid(bits * dens, xs) / z) if z > 0 else 2.0 * math.log2(
        2.0 * levels + 1.0)


class QSGD(CommTransform):
    """Stochastic uniform quantization, per-block max-abs scale, int8 wire.

    The block adapts to ``min(block, n)`` (a short chain carrier ships one
    short row).  The uniforms are drawn in the blocked (nb, blk) layout
    from ``rng.uniform`` on both backends, so the kernel path is bit-exact
    against the plain path.  ``wire="packed"`` (``@fused``, ``bits <= 4``)
    nibble-packs the flat code vector; the kernel path fuses the pack."""
    kernel_capable = True

    def __init__(self, bits=8, block=2048, backend="jax", wire="staged"):
        assert 2 <= bits <= 8
        if wire == "packed" and bits > 4:
            raise ValueError(
                f"qsgd:{bits} has no packed wire format — the nibble holds "
                f"levels in [-8, 7], use bits <= 4 for '@fused' "
                f"(DESIGN.md §10)")
        self.bits = bits
        self.block = block
        self.levels = 2 ** (bits - 1) - 1
        self.backend = backend
        self.wire = wire
        self.name = (f"qsgd{bits}"
                     + ("@kernel" if backend == "kernel" else "")
                     + ("@fused" if wire == "packed" else ""))

    def _blk(self, n):
        return max(1, min(self.block, n))

    def encode(self, state, rng, x):
        n = x.shape[0]
        x = x.to(torch.float32)
        blk = self._blk(n)
        nb = -(-n // blk)
        u = rng.uniform((nb, blk), x.device)
        if self.backend == "kernel":
            from repro_torch.kernels import ops
            uf = u.reshape(-1)[:n]
            if self.wire == "packed":
                q4, scale = ops.qsgd_quantize_packed(x, uf, self.bits, blk)
                return {"q4": q4, "scale": scale}, state
            q, scale = ops.qsgd_quantize(x, uf, self.bits, blk)
            return {"q": q, "scale": scale}, state
        xb = blocked(x, blk)
        scale = xb.abs().amax(dim=1, keepdim=True)
        y = xb / torch.clamp(scale, min=1e-30) * self.levels
        q = to_int8(torch.floor(y + u))
        if self.wire == "packed":
            from repro_torch.compress.wire_format import pack4
            return {"q4": pack4(q.reshape(-1)[:n]), "scale": scale[:, 0]}, state
        return {"q": q, "scale": scale[:, 0]}, state

    def decode(self, payload, n):
        if self.wire == "packed":
            from repro_torch.compress.wire_format import unpack4
            blk = self._blk(n)
            q = blocked(unpack4(payload["q4"], n), blk)
        else:
            q = payload["q"].to(torch.float32)
        scale = payload["scale"][:, None]
        # divide by a device tensor: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal, which is not IEEE division
        levels = torch.tensor(float(self.levels), dtype=torch.float32,
                              device=q.device)
        x = q / levels * scale
        return x.reshape(-1)[:n]

    def meta_bits(self, n):
        nb = -(-n // self.block)
        if self.wire == "packed":
            return 8.0 * (-(-n // 2)) + 32.0 * nb   # nibbles + f32 scales
        return 8.0 * n + 32.0 * nb               # int8 storage + f32 scales

    def meta_entropy_bits(self, n):
        nb = -(-n // self.block)
        est = min(float(self.bits + 1), 8.0) * n + 32.0 * nb
        return min(est, self.meta_bits(n)) if self.wire == "packed" else est

    def meta_entropy_bits_given(self, n, hint=None):
        if not hint or hint.get("kind") != "top_tail":
            return self.meta_entropy_bits(n)
        nb = -(-n // self.block)
        bpc = _tail_elias_bits_per_coord(self.levels, float(hint["fraction"]),
                                         n, self.block)
        est = bpc * n + 32.0 * nb
        return min(est, self.meta_bits(n)) if self.wire == "packed" else est


def _adapted_blocked(x, block):
    """Flat (n,) -> (nb, blk) f32 with the block adapted to short inputs,
    ``blk = min(block, n)``, as the reference's ``_blocked``."""
    return blocked(x, max(1, min(block, x.shape[0])))


class UVeQ(CommTransform):
    """Subtractive-dither uniform quantization (UVeQFed-style, unbiased).

    The dither is ``jax.random.uniform(key, shape, f32, -0.5, 0.5)``'s own
    construction from the key's [0, 1) uniforms, ``max(-0.5, u * 1.0 +
    (-0.5))`` (the product is exact), so a key with the reference's bits
    gives its dither bit for bit.  The key travels in the payload
    (``"useed"``) and the receiver redraws the dither from it."""

    def __init__(self, bits=4, block=2048):
        self.bits = bits
        self.block = block
        self.name = f"uveq{bits}"

    def _delta(self, scale):
        levels = torch.tensor(float(2 ** (self.bits - 1) - 1),
                              dtype=torch.float32, device=scale.device)
        return torch.clamp(scale, min=1e-30) / levels

    @staticmethod
    def _dither(key, shape, device):
        return torch.clamp(key.uniform(shape, device) - 0.5, min=-0.5)

    def encode(self, state, rng, x):
        xb = _adapted_blocked(x, self.block)
        scale = xb.abs().amax(dim=1, keepdim=True)
        delta = self._delta(scale)
        u = self._dither(rng, xb.shape, x.device) * delta
        q = to_int8(torch.round((xb + u) / delta))
        return {"q": q, "scale": scale[:, 0], "useed": rng}, state

    def decode(self, payload, n):
        delta = self._delta(payload["scale"][:, None])
        xb = payload["q"].to(torch.float32) * delta
        u = self._dither(payload["useed"], xb.shape, xb.device) * delta
        return (xb - u).reshape(-1)[:n]

    def meta_bits(self, n):
        nb = -(-n // self.block)
        return 8.0 * n + 32.0 * nb + 32.0

    def meta_entropy_bits(self, n):
        nb = -(-n // self.block)
        return float(self.bits) * n + 32.0 * nb + 32.0


class HSQ(CommTransform):
    """1-bit sign with a per-block mean magnitude (HSQ's codebook reduced
    to the sign hypersphere, as in the reference).  The mean runs over the
    whole adapted block, the last block's zero pad lanes included."""
    biased = True

    def __init__(self, block=2048):
        self.block = block
        self.name = "hsq"

    def encode(self, state, rng, x):
        xb = _adapted_blocked(x, self.block)
        return {"sign": torch.sign(xb).to(torch.int8),
                "mu": xb.abs().mean(dim=1)}, state

    def decode(self, payload, n):
        xb = payload["sign"].to(torch.float32) * payload["mu"][:, None]
        return xb.reshape(-1)[:n]

    def meta_bits(self, n):
        nb = -(-n // self.block)
        return 8.0 * n + 32.0 * nb               # int8-stored signs

    def meta_entropy_bits(self, n):
        nb = -(-n // self.block)
        return 1.0 * n + 32.0 * nb               # 1 bit/sign after packing


register("qsgd8")(lambda block=2048, backend="jax", **kw:
                  QSGD(8, block, backend))
register("qsgd4")(lambda block=2048, backend="jax", **kw:
                  QSGD(4, block, backend))
register("lfl8")(lambda block=2048, backend="jax", **kw:
                 QSGD(8, block, backend))
register("uveq")(lambda block=2048, **kw: UVeQ(4, block))
register("hsq")(lambda block=2048, **kw: HSQ(block))

# a global wire_format="packed" degrades gracefully on qsgd:>4 (stays
# staged); the explicit "@fused" suffix on it still fails in _make_stage
register_stage("qsgd")(lambda bits=8, blk=None, block=2048, backend="jax",
                       wire="staged", **kw:
                       QSGD(int(bits), int(blk or block), backend,
                            wire if int(bits) <= 4 else "staged"))
register_stage("uveq")(lambda bits=4, blk=None, block=2048, **kw:
                       UVeQ(int(bits), int(blk or block)))
register_stage("hsq")(lambda blk=None, block=2048, **kw: HSQ(int(blk or block)))
