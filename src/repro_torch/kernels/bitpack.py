"""The bit-packing kernels and their plain PyTorch versions.

  * ``qsgd_pack``      — QSGD quantize + nibble pack (``bits <= 4``): the
    codes of ``repro_torch.kernels.qsgd`` two per byte, low nibble first,
    per logical row of ``block`` (even) elements, plus the per-row scale.
  * ``ternarize_pack`` — the ternarize pass of ``repro_torch.kernels
    .ternary`` with its codes packed four per byte (``code & 3``), plus the
    per-row psum and pcnt; ``block`` a multiple of 4.
  * ``pack_codes`` / ``unpack_codes`` — an int8 code matrix (nb, block) to
    2- or 4-bit fields (nb, block * bits / 8) and back, sign-extending each
    field as ``((u + off) & mask) - off``.

Byte layout is ``repro_torch.compress.wire_format``'s: pad lanes pack as 0,
so the flat bytes of the packed rows equal ``pack2`` / ``pack4`` of the flat
codes.  Replaces the TPU kernels ``qsgd_pack_blocked``,
``ternarize_pack_blocked``, ``pack_codes_blocked`` and
``unpack_codes_blocked`` of ``repro/kernels/bitpack.py``; the CUDA source
is ``csrc/bitpack.cu``.  All bound by bytes: about 8.5, 4.25, and 1.25
(2 bits) or 1.5 (4 bits) B per element.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.qsgd import check_row_inputs
from repro_torch.kernels.ref import (blocked, ref_pack_codes_blocked,
                                     ref_qsgd_pack_blocked,
                                     ref_ternarize_pack_blocked,
                                     ref_unpack_codes_blocked)
from repro_torch.kernels.ternary import check_row_thresh


def _check_bits_block(bits, block):
    if not 2 <= bits <= 4:
        raise ValueError(f"the nibble pack holds bits <= 4, got {bits}")
    if block % 2:
        raise ValueError(f"block must be even to nibble-pack, got {block}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def qsgd_pack_plain(x, u, bits=4, block=2048):
    """Flat f32 x (n,), u (n,) -> (packed uint8 (nb, block // 2),
    scale f32 (nb,))."""
    _check_bits_block(bits, block)
    return ref_qsgd_pack_blocked(blocked(x, block), blocked(u, block), bits)


def qsgd_pack_cuda(x, u, bits=4, block=2048):
    """The CUDA kernel; same interface as :func:`qsgd_pack_plain`."""
    _check_bits_block(bits, block)
    n = check_row_inputs(x, u, block)
    fn = build.function("bitpack", "repro_qsgd_pack",
                        [ctypes.c_void_p] * 4
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p])
    nb = -(-n // block)
    packed = torch.empty((nb, block // 2), dtype=torch.uint8, device=x.device)
    scale = torch.empty((nb,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), u.data_ptr(), packed.data_ptr(),
                 scale.data_ptr(), n, block, 2 ** (bits - 1) - 1, _stream(x))
    build.LAUNCHES["qsgd_pack"] += 1
    build.check(err, "qsgd_pack")
    return packed, scale


def _check_quad_block(block):
    if block % 4:
        raise ValueError(f"block must be a multiple of 4 to 2-bit pack, got "
                         f"{block}")


def ternarize_pack_plain(x, thresh, block=2048):
    """Flat f32 x (n,) + threshold -> (packed uint8 (nb, block // 4),
    psum f32 (nb,), pcnt f32 (nb,))."""
    _check_quad_block(block)
    return ref_ternarize_pack_blocked(blocked(x, block), thresh)


def ternarize_pack_cuda(x, thresh, block=2048):
    """The CUDA kernel; same interface as :func:`ternarize_pack_plain`."""
    _check_quad_block(block)
    n, t = check_row_thresh(x, thresh, block)
    fn = build.function("bitpack", "repro_ternarize_pack",
                        [ctypes.c_void_p] * 5
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    nb = -(-n // block)
    packed = torch.empty((nb, block // 4), dtype=torch.uint8, device=x.device)
    psum = torch.empty((nb,), dtype=torch.float32, device=x.device)
    pcnt = torch.empty((nb,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), t.data_ptr(), packed.data_ptr(),
                 psum.data_ptr(), pcnt.data_ptr(), n, block, _stream(x))
    build.LAUNCHES["ternarize_pack"] += 1
    build.check(err, "ternarize_pack")
    return packed, psum, pcnt


def _check_codes(t, dtype, bits, name):
    if bits not in (2, 4):
        raise ValueError(f"codes pack into 2 or 4 bits, got {bits}")
    if t.dtype != dtype or t.dim() != 2:
        raise ValueError(f"{name} must be a 2-D {dtype} matrix, got "
                         f"{t.dtype} {tuple(t.shape)}")


def pack_codes_plain(cb, bits=2):
    """int8 codes (nb, block) -> packed uint8 (nb, block * bits // 8)."""
    _check_codes(cb, torch.int8, bits, "codes")
    if cb.shape[1] % (8 // bits):
        raise ValueError(f"block {cb.shape[1]} is not a multiple of "
                         f"{8 // bits} codes per byte")
    return ref_pack_codes_blocked(cb, bits)


def pack_codes_cuda(cb, bits=2):
    """The CUDA kernel; same interface as :func:`pack_codes_plain`."""
    _check_codes(cb, torch.int8, bits, "codes")
    per = 8 // bits
    if cb.device.type != "cuda" or not cb.is_contiguous() \
            or cb.shape[1] % per:
        raise ValueError("codes must be a contiguous CUDA matrix whose rows "
                         f"are a multiple of {per} codes")
    fn = build.function("bitpack", "repro_pack_codes",
                        [ctypes.c_void_p] * 2
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    packed = torch.empty((cb.shape[0], cb.shape[1] // per),
                         dtype=torch.uint8, device=cb.device)
    with torch.cuda.device(cb.device):
        err = fn(cb.data_ptr(), packed.data_ptr(), packed.numel(), bits,
                 _stream(cb))
    build.LAUNCHES["pack_codes"] += 1
    build.check(err, "pack_codes")
    return packed


def unpack_codes_plain(pb, bits=2):
    """packed uint8 (nb, pblock) -> int8 codes (nb, pblock * 8 // bits)."""
    _check_codes(pb, torch.uint8, bits, "packed")
    return ref_unpack_codes_blocked(pb, bits)


def unpack_codes_cuda(pb, bits=2):
    """The CUDA kernel; same interface as :func:`unpack_codes_plain`."""
    _check_codes(pb, torch.uint8, bits, "packed")
    if pb.device.type != "cuda" or not pb.is_contiguous():
        raise ValueError("packed must be a contiguous CUDA matrix")
    fn = build.function("bitpack", "repro_unpack_codes",
                        [ctypes.c_void_p] * 2
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    codes = torch.empty((pb.shape[0], pb.shape[1] * (8 // bits)),
                        dtype=torch.int8, device=pb.device)
    with torch.cuda.device(pb.device):
        err = fn(pb.data_ptr(), codes.data_ptr(), pb.numel(), bits,
                 _stream(pb))
    build.LAUNCHES["unpack_codes"] += 1
    build.check(err, "unpack_codes")
    return codes
