"""STC ternarization with the partial sums of mu: CUDA kernel and its plain
PyTorch version.

Per logical row r of ``block`` elements of the flat vector,

    code    = sign(x) * (|x| >= t)        int8, pad lanes 0
    psum[r] = sum |x| * (|x| >= t)        f32
    pcnt[r] = sum (|x| >= t)              f32

and the caller finishes mu = sum(psum) / sum(pcnt).  Pad lanes are x = 0,
so they count in pcnt when t <= 0, as in the reference.  Codes and pcnt
are exact; psum is summed in another order than the reference's
(bounded-ULP, DESIGN.md §6).

Replaces the TPU kernel ``repro/kernels/ternary.py`` ``ternarize_blocked``;
the CUDA source is ``csrc/ternary.cu`` (one warp per row).  Bound by bytes:
about 5 B per element.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.qsgd import MAX_BLOCK
from repro_torch.kernels.ref import blocked, ref_ternarize_blocked
from repro_torch.kernels.topk_mask import check_thresh, check_vec


def ternarize_plain(x, thresh, block=2048):
    """Flat f32 x (n,) + threshold -> (code int8 (nb, block), psum f32
    (nb,), pcnt f32 (nb,)), nb = ceil(n / block)."""
    return ref_ternarize_blocked(blocked(x, block), thresh)


def ternarize_cuda(x, thresh, block=2048):
    """The CUDA kernel; same interface as :func:`ternarize_plain`, with
    ``thresh`` one f32 value on x's device."""
    n, t = check_row_thresh(x, thresh, block)
    fn = build.function("ternary", "repro_ternarize",
                        [ctypes.c_void_p] * 5
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    nb = -(-n // block)
    code = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    psum = torch.empty((nb,), dtype=torch.float32, device=x.device)
    pcnt = torch.empty((nb,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), t.data_ptr(), code.data_ptr(),
                 psum.data_ptr(), pcnt.data_ptr(), n, block,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.LAUNCHES["ternarize"] += 1
    build.check(err, "ternarize")
    return code, psum, pcnt


def check_row_thresh(x, thresh, block):
    """Argument checks of the ternarize kernels; returns (n, thresh)."""
    check_vec(x, "x")
    if x.shape[0] == 0:
        raise ValueError("x must be nonempty")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be in [1, {MAX_BLOCK}], got {block}")
    return x.shape[0], check_thresh(thresh, x)
