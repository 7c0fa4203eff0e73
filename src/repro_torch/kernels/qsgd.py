"""QSGD stochastic uniform quantization: CUDA kernel and its plain PyTorch
version.

Per logical row r of ``block`` elements of the flat vector,
``scale_r = max|x|`` and ``q = floor(x / max(scale_r, 1e-30) * L + u)`` as
int8, ``L = 2^(bits-1) - 1``.  The uniforms ``u`` are an input, so the
kernel is bit-reproducible against the plain version and the reference.

Replaces the TPU kernel ``repro/kernels/qsgd.py`` ``qsgd_quantize_blocked``;
the CUDA source is ``csrc/qsgd.cu`` (one block per row).  Bound by bytes:
about 9 B per element.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import blocked, ref_qsgd_quantize_blocked

# one CUDA block per row keeps the row's reduction in shared memory
MAX_BLOCK = 1 << 16


def qsgd_quantize_plain(x, u, bits=8, block=2048):
    """Flat f32 x (n,), u (n,) -> (q int8 (nb, block), scale f32 (nb,)),
    nb = ceil(n / block); pad lanes are code 0."""
    return ref_qsgd_quantize_blocked(blocked(x, block), blocked(u, block),
                                     bits)


def qsgd_quantize_cuda(x, u, bits=8, block=2048):
    """The CUDA kernel; same interface as :func:`qsgd_quantize_plain`."""
    n = check_row_inputs(x, u, block)
    fn = build.function("qsgd", "repro_qsgd_quantize",
                        [ctypes.c_void_p] * 4
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p])
    nb = -(-n // block)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((nb,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), u.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 n, block, 2 ** (bits - 1) - 1,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.LAUNCHES["qsgd_quantize"] += 1
    build.check(err, "qsgd_quantize")
    return q, scale


def check_row_inputs(x, u, block):
    """Shared argument checks of the row kernels; returns n."""
    for name, t in (("x", x), ("u", u)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on x's device")
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D f32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    n = x.shape[0]
    if u.shape[0] != n or n == 0:
        raise ValueError(f"x and u must have the same nonzero length, got "
                         f"{n} and {u.shape[0]}")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be in [1, {MAX_BLOCK}], got {block}")
    return n
