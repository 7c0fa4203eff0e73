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


def pack_lanes(u, bits):
    """uint8 fields (rows, block) -> packed bytes (rows, block*bits//8),
    little-endian within the byte (``repro.kernels.bitpack._pack_lanes``)."""
    per = 8 // bits
    out = u[:, 0::per]
    for j in range(1, per):
        out = out | (u[:, j::per] << (j * bits))
    return out


def unpack_lanes(p, bits):
    """packed bytes (rows, pblock) -> int8 codes (rows, pblock*8//bits),
    sign-extended from the ``bits``-bit field as ``((u + off) & mask) -
    off`` (``repro.kernels.bitpack._unpack_lanes``)."""
    per = 8 // bits
    mask, off = (1 << bits) - 1, 1 << (bits - 1)
    shifts = torch.arange(0, 8, bits, dtype=torch.int16, device=p.device)
    u = (p.to(torch.int16)[:, :, None] >> shifts) & mask
    return (((u + off) & mask) - off).reshape(p.shape[0], -1).to(torch.int8)


def ref_qsgd_quantize_blocked(xb, u, bits=8):
    levels = 2 ** (bits - 1) - 1
    scale = xb.abs().amax(dim=1, keepdim=True)
    y = xb / torch.clamp(scale, min=1e-30) * levels
    q = to_int8(torch.floor(y + u))
    return q, scale[:, 0]


def ref_qsgd_pack_blocked(xb, u, bits=4):
    q, scale = ref_qsgd_quantize_blocked(xb, u, bits)
    return pack_lanes((q & 15).to(torch.uint8), 4), scale


def ref_ternarize_blocked(xb, thresh):
    """code = sign(x)·(|x| >= t) int8, per-row psum = Σ|x|·keep and
    pcnt = Σkeep (f32).  ``sign(-0.0)`` is 0, so a negative zero codes 0."""
    mag = xb.abs()
    keep = mag >= thresh
    code = (torch.sign(xb) * keep).to(torch.int8)
    psum = torch.where(keep, mag, torch.zeros((), dtype=mag.dtype,
                                              device=mag.device)).sum(dim=1)
    pcnt = keep.sum(dim=1).to(torch.float32)
    return code, psum, pcnt


def ref_ternarize_pack_blocked(xb, thresh):
    """``ref_ternarize_blocked`` with the codes 2-bit packed (``code & 3``,
    4 per byte): (packed uint8 (rows, block // 4), psum, pcnt)."""
    code, psum, pcnt = ref_ternarize_blocked(xb, thresh)
    return pack_lanes((code & 3).to(torch.uint8), 2), psum, pcnt


def ref_pack_codes_blocked(cb, bits=2):
    """int8 codes (rows, block) -> packed uint8 (rows, block*bits//8)."""
    return pack_lanes((cb & ((1 << bits) - 1)).to(torch.uint8), bits)


def ref_unpack_codes_blocked(pb, bits=2):
    """packed uint8 (rows, pblock) -> int8 codes (rows, pblock*8//bits)."""
    return unpack_lanes(pb, bits)


def ref_threshold_sparsify_blocked(xb, thresh):
    keep = xb.abs() >= thresh
    kept = torch.where(keep, xb, torch.zeros((), dtype=xb.dtype,
                                             device=xb.device))
    return kept, xb - kept


def ref_count_sketch(x, a, b, rows, cols):
    """Count sketch of flat x (n,) with the rows' hash parameters a, b
    (uint32 values in int64): ``S[j, h_j(i)] += s_j(i) * x_i``, (rows,
    cols) f32.  One ``index_add_`` per chunk of the flat index
    (``compress.sketch.CHUNK``), over the flattened S, so each bucket adds
    its terms in index order."""
    from repro_torch.compress.sketch import _chunks, bucket_and_sign
    x = x.to(torch.float32)
    S = torch.zeros((rows * cols,), dtype=torch.float32, device=x.device)
    offs = torch.arange(rows, dtype=torch.int64, device=x.device)[:, None] \
        * cols
    for lo, hi in _chunks(x.shape[0]):
        i = torch.arange(lo, hi, dtype=torch.int64, device=x.device)
        h, s = bucket_and_sign(i, a, b, cols)
        S.index_add_(0, (h + offs).reshape(-1),
                     (s * x[lo:hi][None, :]).reshape(-1))
    return S.reshape(rows, cols)
