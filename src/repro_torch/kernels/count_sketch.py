"""Count sketch: CUDA kernel and its plain PyTorch version.

    S[j, h_j(i)] += s_j(i) * x_i,   ab = a_j * i + b_j mod 2^32,
    h_j(i) = ab % cols,  s_j(i) = +1 if (ab // cols) is even else -1,

for every row j of the (rows, cols) f32 sketch and every element i of the
flat f32 vector x, i being the element's flat index.

Replaces the TPU kernel ``repro/kernels/count_sketch.py`` ``count_sketch``
(a one-hot matmul per row and 1024-element chunk); the CUDA source is
``csrc/count_sketch.cu``, with two paths:

* a power-of-two width (:func:`fold_path`) takes the fold path.  There a
  bucket and its sign depend only on ``i mod 2*cols``, so the kernel sums
  x as rows of ``2*cols`` floats (one coalesced read, no hashing, no
  atomics) and writes ``S[j, h] = y[p+] - y[p-]`` from the two residues
  that land in bucket h (:func:`preimages`).  Bound by bytes; two
  launches on one input are bit-identical;
* any other width takes the scatter path: one pass over x for all rows, a
  partial sketch per CTA in shared memory, the partials summed in CTA
  order.  Bound by the rows' integer hash work at 5 rows.

Either path adds the bucket sums in another order than the plain
version's, so S agrees with it to a bounded number of ULPs.
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


def fold_path(cols):
    """Whether a sketch ``cols`` wide takes the kernel's fold path (a power
    of two) rather than its scatter path."""
    return cols >= 1 and cols & (cols - 1) == 0


def _ints(v):
    return [int(t) for t in (v.tolist() if isinstance(v, torch.Tensor)
                             else v)]


def inverses(a):
    """The multipliers' inverses mod 2^32, which the fold path needs; raises
    ``ValueError`` on an even multiplier (it has none, and the residues of
    its row do not pair up)."""
    vals = _ints(a)
    if any(t % 2 == 0 for t in vals):
        raise ValueError(f"the fold path needs odd hash multipliers, got "
                         f"{vals}")
    return [pow(t, -1, 1 << 32) for t in vals]


def preimages(a, b, cols):
    """The fold path's gather for a power-of-two ``cols``: (p_plus, p_minus),
    each (rows, cols) int64, the residues mod ``2*cols`` whose elements land
    in bucket h of row j with sign +1 and -1, ``p_plus = a_j^-1 (h - b_j)
    mod 2*cols`` and ``p_minus = p_plus ^ cols``, as the kernel computes
    them."""
    if not fold_path(cols):
        raise ValueError(f"the fold path needs a power-of-two width, got "
                         f"{cols}")
    P = 2 * cols
    ainv = torch.tensor(inverses(a), dtype=torch.int64)[:, None]
    b = torch.tensor(_ints(b), dtype=torch.int64)[:, None]
    h = torch.arange(cols, dtype=torch.int64)[None, :]
    p_plus = (ainv % P) * ((h - b) % P) % P
    return p_plus, p_plus ^ cols


def _words(vals, rows, name):
    if len(vals) != rows or not all(0 <= t < 1 << 32 for t in vals):
        raise ValueError(f"{name} must hold {rows} uint32 hash parameters")
    return (ctypes.c_uint32 * rows)(*vals)


def count_sketch_cuda(x, a, b, rows, cols, min_span=0):
    """The CUDA kernel; same interface as :func:`count_sketch_plain`, with
    a and b on the host (they travel as kernel arguments).  ``min_span``
    sets the scatter path's least elements per CTA, for measuring its grid
    rule (0: the built-in rule)."""
    check_vec(x, "x")
    n = x.shape[0]
    if not 0 < n < 1 << 31:
        raise ValueError(f"x must have 1 to 2^31 - 1 elements, got {n}")
    if rows < 1 or cols < 1:
        raise ValueError(f"rows and cols must be positive, got {rows}, "
                         f"{cols}")
    a, b = _ints(a), _ints(b)
    av, bv = _words(a, rows, "a"), _words(b, rows, "b")
    iv = _words(inverses(a), rows, "a^-1") if fold_path(cols) else av
    u32p = ctypes.POINTER(ctypes.c_uint32)
    plan = build.function("count_sketch", "repro_count_sketch_scratch",
                          [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong,
                           ctypes.POINTER(ctypes.c_longlong),
                           ctypes.POINTER(ctypes.c_int)])
    fn = build.function("count_sketch", "repro_count_sketch",
                        [ctypes.c_void_p, u32p, u32p, u32p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        floats, fold = ctypes.c_longlong(0), ctypes.c_int(0)
        build.check(plan(n, rows, cols, min_span, ctypes.byref(floats),
                         ctypes.byref(fold)), "count_sketch plan")
        S = torch.empty((rows, cols), dtype=torch.float32, device=x.device)
        scratch = torch.empty((max(1, floats.value),), dtype=torch.float32,
                              device=x.device)
        err = fn(x.data_ptr(), av, bv, iv, S.data_ptr(), scratch.data_ptr(),
                 floats.value, n, rows, cols, min_span,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.LAUNCHES["count_sketch"] += 1
    build.LAUNCHES["count_sketch/fold" if fold.value
                   else "count_sketch/scatter"] += 1
    build.check(err, "count_sketch")
    return S
