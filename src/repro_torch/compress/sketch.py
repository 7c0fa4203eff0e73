"""Count-sketch compression, FetchSGD's uplink (port of
``repro.compress.sketch``).

The sketch S is a (rows, cols) array: coordinate i of the input lands in
bucket ``h_j(i)`` of every row j with sign ``s_j(i)``, both from a
multiplicative hash over Z/2^32.  Unsketching estimates x_i as the median
over rows of ``s_j(i) * S[j, h_j(i)]``, and the decode keeps the top-k
estimates by magnitude.  The sketch is linear, so client sketches add.

The hash runs in int64 with the uint32 wrap-around made explicit
(``& 0xFFFFFFFF`` after the multiply and after the add), so buckets and
signs equal the reference's bit for bit.  The median is ``jnp.median``'s
midpoint rule, ``(v[(r-1)//2] + v[r//2]) * 0.5`` of the sorted rows, which
is exact for odd and even row counts (``torch.median`` returns the lower
middle value).  Encode and decode walk the flat index in chunks of
``CHUNK`` coordinates, so an llama-sized leaf never materialises its
(rows, n) buckets at once; the result is the same element for element.

``backend="kernel"``: the sketch runs in the ``count_sketch`` CUDA kernel
(``kernels/count_sketch.py``: a fold of x at power-of-two widths, a
scatter otherwise); its bucket sums are added in another order, so S
agrees with the plain path to a bounded number of ULPs (DESIGN.md §6).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compress.api import CommTransform, register, register_stage
from repro_torch.compress.sparsification import _k, top_k_indices

CHUNK = 1 << 22
_U32 = 0xFFFFFFFF


def hash_params(rows: int, seed: int = 17):
    """The rows' hash parameters: odd multipliers ``a`` in [3, 2^31) and
    offsets ``b`` in [0, 2^30), uint32 values held in int64 CPU tensors.

    Drawn from ``numpy.random.default_rng(seed)`` with the reference's
    ranges; these are not ``jax.random``'s bits, so a test that needs the
    reference's sketch replaces this function with the reference's values.
    It is the only place that draws them."""
    g = np.random.default_rng(seed)
    a = g.integers(1, 1 << 30, size=rows, dtype=np.int64) * 2 + 1
    b = g.integers(0, 1 << 30, size=rows, dtype=np.int64)
    return torch.from_numpy(a), torch.from_numpy(b)


def bucket_and_sign(i, a, b, cols):
    """i: (m,) int64 indices; a, b: (rows,) uint32 values in int64.
    Returns the buckets h (rows, m) int64 and the signs s (rows, m) f32:
    ``ab = a*i + b mod 2^32``, ``h = ab % cols``, ``s = +1`` where
    ``(ab // cols)`` is even, else -1."""
    dev = i.device
    a = a.to(device=dev, dtype=torch.int64)[:, None]
    b = b.to(device=dev, dtype=torch.int64)[:, None]
    ab = ((a * (i.to(torch.int64) & _U32)[None, :]) & _U32) + b
    ab = ab & _U32
    h = ab % cols
    s = torch.where((ab // cols) % 2 == 0, 1.0, -1.0).to(torch.float32)
    return h, s


def _chunks(n):
    for lo in range(0, n, CHUNK):
        yield lo, min(n, lo + CHUNK)


def sketch(x, rows, cols, seed=17):
    """The plain count sketch of flat x (n,): S (rows, cols) f32."""
    from repro_torch.kernels.ref import ref_count_sketch
    a, b = hash_params(rows, seed)
    return ref_count_sketch(x, a, b, rows, cols)


def _midpoint_median(v):
    """``jnp.median`` over dim 0: the midpoint of the two middle values of
    the sorted rows (the same value twice for an odd row count)."""
    r = v.shape[0]
    v = torch.sort(v, dim=0).values
    return (v[(r - 1) // 2] + v[r // 2]) * 0.5


def unsketch(S, n, seed=17):
    """Median-of-rows estimate of every coordinate: f32 (n,)."""
    rows, cols = S.shape
    a, b = hash_params(rows, seed)
    est = torch.empty((n,), dtype=torch.float32, device=S.device)
    for lo, hi in _chunks(n):
        i = torch.arange(lo, hi, dtype=torch.int64, device=S.device)
        h, s = bucket_and_sign(i, a, b, cols)
        est[lo:hi] = _midpoint_median(s * torch.gather(S, 1, h))
    return est


class CountSketch(CommTransform):
    """FetchSGD-style sketch; the top-k heavy hitters are recovered on
    decode.

    The sketch width adapts to the leaf, ``rows * cols <= n / 2`` (at
    least 8 columns), so the wire always beats dense f32.  The flattened
    sketch is the carrier: ``"sketch>>qsgd:8"`` puts int8 buckets on the
    wire, QSGD's block adapted to ``min(2048, rows * cols)``."""
    biased = True
    carrier_key = "S"
    kernel_capable = True

    def __init__(self, rows=5, cols=4096, topk_fraction=0.01, seed=17,
                 backend="jax"):
        self.rows, self.cols, self.seed = rows, cols, seed
        self.topk_fraction = topk_fraction
        self.backend = backend
        self.name = f"sketch{rows}x{cols}" + \
            ("@kernel" if backend == "kernel" else "")

    def _cols(self, n):
        return int(min(self.cols, max(8, n // (2 * self.rows))))

    def encode(self, state, rng, x):
        cols = self._cols(x.shape[0])
        if self.backend == "kernel":
            from repro_torch.kernels import ops
            S = ops.sketch(x, self.rows, cols, self.seed)
        else:
            S = sketch(x, self.rows, cols, self.seed)
        return {"S": S.reshape(-1)}, state

    def decode(self, payload, n):
        S = payload["S"].reshape(self.rows, self._cols(n))
        est = unsketch(S, n, self.seed)
        idx, _ = top_k_indices(est, _k(n, self.topk_fraction))
        out = torch.zeros((n,), dtype=torch.float32, device=est.device)
        out[idx] = est[idx]
        return out

    def carrier_len(self, n):
        return self.rows * self._cols(n)

    def meta_bits(self, n):
        return 0.0


register("sketch")(lambda rows=5, cols=4096, fraction=0.01, backend="jax",
                   **kw: CountSketch(rows, cols, fraction, backend=backend))
register_stage("sketch")(lambda r=None, c=None, rows=5, cols=4096,
                         fraction=0.01, backend="jax", **kw:
                         CountSketch(int(r or rows), int(c or cols), fraction,
                                     backend=backend))
