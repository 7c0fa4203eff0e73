"""Count sketch: CUDA kernel and its plain PyTorch version.

    S[j, h_j(i)] += s_j(i) * x_i,   ab = a_j * i + b_j mod 2^32,
    h_j(i) = ab % cols,  s_j(i) = +1 if (ab // cols) is even else -1,

for every row j of the (rows, cols) f32 sketch and every element i of the
flat f32 vector x, i being the element's flat index.

Replaces the TPU kernel ``repro/kernels/count_sketch.py`` ``count_sketch``
(a one-hot matmul per row and 1024-element chunk); the CUDA source is
``csrc/count_sketch.cu``: one pass over x for all rows, a partial sketch
per CTA in shared memory, the partials summed in CTA order.  The bucket
sums are added in another order than the plain version's, so S agrees
with it to a bounded number of ULPs.  Bound by the rows' integer hash
work at the default 5 rows; by bytes (4 B per element) at fewer rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_count_sketch
from repro_torch.kernels.topk_mask import check_vec


def count_sketch_plain(x, a, b, rows, cols):
    """Flat f32 x (n,) and the rows' hash parameters a, b (uint32 values in
    int64 tensors) -> S (rows, cols) f32."""
    return ref_count_sketch(x, a, b, rows, cols)


def _words(v, rows, name):
    vals = [int(t) for t in (v.tolist() if isinstance(v, torch.Tensor)
                             else v)]
    if len(vals) != rows or not all(0 <= t < 1 << 32 for t in vals):
        raise ValueError(f"{name} must hold {rows} uint32 hash parameters")
    return (ctypes.c_uint32 * rows)(*vals)


def count_sketch_cuda(x, a, b, rows, cols):
    """The CUDA kernel; same interface as :func:`count_sketch_plain`, with
    a and b on the host (they travel as kernel arguments)."""
    check_vec(x, "x")
    n = x.shape[0]
    if not 0 < n < 1 << 31:
        raise ValueError(f"x must have 1 to 2^31 - 1 elements, got {n}")
    if rows < 1 or cols < 1:
        raise ValueError(f"rows and cols must be positive, got {rows}, "
                         f"{cols}")
    av, bv = _words(a, rows, "a"), _words(b, rows, "b")
    u32p = ctypes.POINTER(ctypes.c_uint32)
    plan = build.function("count_sketch", "repro_count_sketch_scratch",
                          [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_longlong)])
    fn = build.function("count_sketch", "repro_count_sketch",
                        [ctypes.c_void_p, u32p, u32p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
    with torch.cuda.device(x.device):
        floats = ctypes.c_longlong(0)
        build.check(plan(n, rows, cols, ctypes.byref(floats)),
                    "count_sketch plan")
        S = torch.empty((rows, cols), dtype=torch.float32, device=x.device)
        scratch = torch.empty((max(1, floats.value),), dtype=torch.float32,
                              device=x.device)
        err = fn(x.data_ptr(), av, bv, S.data_ptr(), scratch.data_ptr(),
                 floats.value, n, rows, cols,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.LAUNCHES["count_sketch"] += 1
    build.check(err, "count_sketch")
    return S
