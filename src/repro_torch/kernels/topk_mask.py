"""Fused threshold-sparsify + error-feedback residual: CUDA kernel and its
plain PyTorch version.

    kept  = x * (|x| >= t)        (the update that goes on the wire)
    resid = x - kept              (the error-feedback memory)

Replaces the TPU kernel ``repro/kernels/topk_mask.py``
``threshold_sparsify_blocked``; the CUDA source is ``csrc/topk_mask.cu``.
Bound by bytes: 12 B per element.  The index extraction (the stable sort
that picks the top-k) stays a PyTorch call, as it stays in XLA on the TPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_threshold_sparsify_blocked

launches = 0        # CUDA launches through threshold_sparsify_cuda


def threshold_sparsify_plain(x, thresh):
    """Flat f32 (n,) + threshold -> (kept, resid) flat (n,)."""
    kept, resid = ref_threshold_sparsify_blocked(x.reshape(1, -1), thresh)
    return kept.reshape(-1), resid.reshape(-1)


def threshold_sparsify_cuda(x, thresh):
    """The CUDA kernel on a contiguous f32 CUDA vector; ``thresh`` is a
    one-element f32 tensor on the same device (no host sync)."""
    global launches
    _check_vec(x, "x")
    t = thresh.reshape(-1)
    if t.numel() != 1 or t.dtype != torch.float32 or t.device != x.device:
        raise ValueError("thresh must be one f32 value on x's device")
    t = t.contiguous()
    fn = build.function("topk_mask", "repro_threshold_sparsify",
                        [ctypes.c_void_p] * 4
                        + [ctypes.c_longlong, ctypes.c_void_p])
    kept = torch.empty_like(x)
    resid = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), t.data_ptr(), kept.data_ptr(),
                 resid.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    build.check(err, "threshold_sparsify")
    return kept, resid


def _check_vec(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D f32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
