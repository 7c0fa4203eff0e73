"""Packed wire formats (port of ``repro.compress.wire_format``, DESIGN.md §10).

Byte layouts, little-endian within the byte:

  * ``pack2`` — 2-bit two's-complement codes, 4 per byte,
    ``byte = c0 | c1<<2 | c2<<4 | c3<<6``; code -1 -> 0b11, 0 -> 0b00,
    +1 -> 0b01.  Length ``ceil(n/4)``, the tail byte's unused fields zero.
  * ``pack4`` — 4-bit two's-complement codes (range [-8, 7]), 2 per byte,
    ``byte = c0 | c1<<4``.  Length ``ceil(n/2)``.

Both pack the FLAT code vector, so the row-wise fused pack kernels
(``kernels/bitpack``) emit the same bytes for any block divisible by the
codes per byte.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.rng import Key

WIRE_FORMATS = ("staged", "packed")


def packed_len(n: int, bits: int) -> int:
    """Bytes needed for n codes at ``bits`` bits per code (2 or 4)."""
    per = 8 // bits
    return -(-n // per)


def _pack(codes, bits):
    per = 8 // bits
    n = codes.shape[0]
    u = (F.pad(codes.to(torch.int16), (0, (-n) % per))
         & ((1 << bits) - 1)).to(torch.uint8).reshape(-1, per)
    out = u[:, 0]
    for j in range(1, per):
        out = out | (u[:, j] << (j * bits))
    return out


def _unpack(packed, n, bits):
    per = 8 // bits
    mask, off = (1 << bits) - 1, 1 << (bits - 1)
    shifts = torch.arange(0, 8, bits, dtype=torch.int16, device=packed.device)
    u = (packed.to(torch.int16)[:, None] >> shifts) & mask
    return (((u + off) & mask) - off).reshape(-1)[:n].to(torch.int8)


def pack2(codes):
    """int8 ternary codes (n,) in {-1, 0, +1} -> uint8 (ceil(n/4),)."""
    return _pack(codes, 2)


def unpack2(packed, n: int):
    """uint8 (ceil(n/4),) -> int8 codes (n,) (2-bit sign extension)."""
    return _unpack(packed, n, 2)


def pack4(codes):
    """int8 codes (n,) in [-8, 7] -> uint8 (ceil(n/2),), low nibble first."""
    return _pack(codes, 4)


def unpack4(packed, n: int):
    """uint8 (ceil(n/2),) -> int8 codes (n,) (4-bit sign extension)."""
    return _unpack(packed, n, 4)


def payload_planes(payload) -> list:
    """The tensors of an encoded payload in ``jax.tree.leaves`` order (dict
    keys sorted, tuples in order): what a collective moves.  A SecAgg
    payload's ``secagg_ctx`` (mask key, ring index, cohort) rides out of
    band, unbilled (``secure_agg.CTX_BITS``), and is not among them."""
    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                if k != "secagg_ctx":
                    walk(node[k])
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
    walk(payload)
    return out


def payload_nbytes(pipe, n: int, device="cpu") -> int:
    """Exact bytes of ``pipe``'s encoded payload for a length-n leaf: one
    encode of zeros on ``device`` (its shapes and dtypes do not depend on
    the values).  This is what the aggregation collective gathers per
    client; for packable specs the ledger's ``wire_bits(n)`` equals
    ``8 * payload_nbytes``."""
    x = torch.zeros((n,), dtype=torch.float32, device=device)
    payload, _ = pipe.encode(pipe.init((n,), device=device), Key(0), x)
    return sum(t.numel() * t.element_size() for t in payload_planes(payload))
