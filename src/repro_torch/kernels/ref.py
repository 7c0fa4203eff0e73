"""Plain PyTorch oracles of the ported kernels (port of ``repro.kernels.ref``).

Each ``ref_*`` takes the reference's blocked inputs and returns what its
kernel returns, bit for bit.  Two details carry the bit-exactness:

  * ``q / s * L + u`` runs as separate IEEE operations, each divisor a
    tensor (PyTorch turns a CUDA division by a Python scalar into a
    multiplication by its reciprocal);
  * the float -> int8 conversion saturates to [-128, 127] like XLA's
    convert (a plain ``.to(torch.int8)`` wraps around).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def blocked(x, block):
    """Flat (n,) -> zero-padded (ceil(n/block), block) f32."""
    n = x.shape[0]
    nb = -(-n // block)
    return F.pad(x.to(torch.float32), (0, nb * block - n)).reshape(nb, block)


def to_int8(q):
    return q.clamp(-128, 127).to(torch.int8)


def pack_nibbles(u):
    """uint8 nibbles (rows, block) -> bytes (rows, block // 2), low nibble
    first (``repro.kernels.bitpack._pack_lanes`` at 4 bits)."""
    return u[:, 0::2] | (u[:, 1::2] << 4)


def ref_qsgd_quantize_blocked(xb, u, bits=8):
    levels = 2 ** (bits - 1) - 1
    scale = xb.abs().amax(dim=1, keepdim=True)
    y = xb / torch.clamp(scale, min=1e-30) * levels
    q = to_int8(torch.floor(y + u))
    return q, scale[:, 0]


def ref_qsgd_pack_blocked(xb, u, bits=4):
    q, scale = ref_qsgd_quantize_blocked(xb, u, bits)
    return pack_nibbles((q & 15).to(torch.uint8)), scale


def ref_threshold_sparsify_blocked(xb, thresh):
    keep = xb.abs() >= thresh
    kept = torch.where(keep, xb, torch.zeros((), dtype=xb.dtype,
                                             device=xb.device))
    return kept, xb - kept
