"""Packed wire formats (port of ``repro.compress.wire_format``, DESIGN.md §10).

``pack4`` packs 4-bit two's-complement codes (range [-8, 7]) two per byte,
``byte = c0 | c1<<4``, length ``ceil(n/2)``, the tail byte's unused field
zero.  It packs the FLAT code vector, so the row-wise fused pack kernel
(``kernels/bitpack``) emits the same bytes for any even block.  The 2-bit
``pack2`` / ``unpack2`` of the ternary stages are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

WIRE_FORMATS = ("staged", "packed")


def packed_len(n: int, bits: int) -> int:
    """Bytes needed for n codes at ``bits`` bits per code (2 or 4)."""
    per = 8 // bits
    return -(-n // per)


def pack4(codes):
    """int8 codes (n,) in [-8, 7] -> uint8 (ceil(n/2),), low nibble first."""
    n = codes.shape[0]
    u = (F.pad(codes.to(torch.int16), (0, n % 2)) & 15).to(torch.uint8)
    u = u.reshape(-1, 2)
    return u[:, 0] | (u[:, 1] << 4)


def unpack4(packed, n: int):
    """uint8 (ceil(n/2),) -> int8 codes (n,) (4-bit sign extension)."""
    shifts = torch.tensor([0, 4], dtype=torch.int16, device=packed.device)
    u = (packed.to(torch.int16)[:, None] >> shifts) & 15
    return (((u + 8) & 15) - 8).reshape(-1)[:n].to(torch.int8)
