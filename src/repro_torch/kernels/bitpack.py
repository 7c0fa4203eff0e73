"""Fused QSGD quantize + nibble pack (``bits <= 4``): CUDA kernel and its
plain PyTorch version.

The codes of ``repro_torch.kernels.qsgd`` packed two per byte, low nibble
first, per logical row of ``block`` (even) elements; pad lanes pack as 0,
so the flat bytes equal ``wire_format.pack4`` of the staged codes.

Replaces the TPU kernel ``repro/kernels/bitpack.py`` ``qsgd_pack_blocked``;
the CUDA source is ``csrc/bitpack.cu``.  Bound by bytes: about 8.5 B per
element.  The reference's other bitpack kernels (``ternarize_pack_blocked``,
``pack_codes_blocked``, ``unpack_codes_blocked``) are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.qsgd import check_row_inputs
from repro_torch.kernels.ref import blocked, ref_qsgd_pack_blocked

launches = 0        # CUDA launches through qsgd_pack_cuda


def _check_bits_block(bits, block):
    if not 2 <= bits <= 4:
        raise ValueError(f"the nibble pack holds bits <= 4, got {bits}")
    if block % 2:
        raise ValueError(f"block must be even to nibble-pack, got {block}")


def qsgd_pack_plain(x, u, bits=4, block=2048):
    """Flat f32 x (n,), u (n,) -> (packed uint8 (nb, block // 2),
    scale f32 (nb,))."""
    _check_bits_block(bits, block)
    return ref_qsgd_pack_blocked(blocked(x, block), blocked(u, block), bits)


def qsgd_pack_cuda(x, u, bits=4, block=2048):
    """The CUDA kernel; same interface as :func:`qsgd_pack_plain`."""
    global launches
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
                 scale.data_ptr(), n, block, 2 ** (bits - 1) - 1,
                 torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    build.check(err, "qsgd_pack")
    return packed, scale
