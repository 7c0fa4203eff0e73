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
* any other width takes the scatter path, one launch of thread-block
  clusters as :func:`scatter_plan` cuts it (16 CTAs a cluster where the
  card holds one at the launch's shared memory, else 8; one cluster for
  every n below 65,536, so every paper_lm leaf).  Each CTA hashes its
  range of x into every row of its own partial sketch in shared memory,
  dividing by the width with a multiply-high (:func:`divisor_magic`,
  :func:`fast_divmod`), and CTA rank r sums column slice r of the
  cluster's partials in rank order through distributed shared memory,
  straight into S (several clusters: into scratch that a second launch
  sums in cluster order).  Bound by the rows' integer hash work, about 6
  INT32 operations a (row, element).

Either path adds the bucket sums in another order than the plain
version's, so S agrees with it to a bounded number of ULPs.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
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


# the scatter path's limits: its CTAs' shared memory on an H100 (the
# opt-in, bytes), the hash rows of one launch (kMaxRows in the CUDA
# source) and the elements one cluster takes at most
SMEM_OPTIN = 232_448
SCATTER_MAX_ROWS = 8
CLUSTER_ELEMS = 65_536


def divisor_magic(cols):
    """Granlund and Montgomery's constants for ``ab // cols`` over every
    uint32 ``ab`` ("Division by invariant integers using multiplication",
    PLDI 1994, Fig. 4.1): ``(m, sh1, sh2)`` with ``l = ceil(log2 cols)``,
    ``m = floor(2^32 (2^l - cols) / cols) + 1`` (below 2^32),
    ``sh1 = min(l, 1)`` and ``sh2 = max(l - 1, 0)``."""
    if not 1 <= cols < 1 << 32:
        raise ValueError(f"cols must be in [1, 2^32), got {cols}")
    ell = (cols - 1).bit_length()
    m = ((1 << 32) * ((1 << ell) - cols)) // cols + 1
    return m, min(ell, 1), max(ell - 1, 0)


def fast_divmod(ab, cols, magic=None):
    """``(ab // cols, ab % cols)`` as the scatter kernel computes them, for
    uint32 values ``ab`` in numpy uint64 (``m ab`` stays below 2^64):
    ``t = (m ab) >> 32``, ``q = (t + ((ab - t) >> sh1)) >> sh2``, ``h = ab
    - q cols``.  ``magic`` defaults to ``divisor_magic(cols)``."""
    ab = np.asarray(ab, np.uint64)
    m, sh1, sh2, cols = (np.asarray(v, np.uint64) for v in
                         (*(magic or divisor_magic(cols)), cols))
    t = (m * ab) >> np.uint64(32)
    q = (t + ((ab - t) >> sh1)) >> sh2
    return q, ab - q * cols


def merge_slices(width, cluster):
    """The columns ``[c0, c1)`` of a ``width``-column tile that each CTA rank
    of a cluster sums from the cluster's partials: ``sc = ceil(width /
    cluster)`` a rank, the last ranks' slices possibly empty."""
    sc = -(-width // cluster)
    return [(min(width, r * sc), min(width, (r + 1) * sc))
            for r in range(cluster)]


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """How the scatter path cuts an (n, rows, cols) sketch: row groups of
    ``rg`` rows and column tiles of ``cw`` columns (the last of each
    possibly narrower), each one launch of ``clusters`` clusters of
    ``cluster`` CTAs (plus a reduce launch when ``clusters > 1``), CTA g
    hashing elements ``[g span, min(n, (g + 1) span))``."""
    n: int
    rows: int
    cols: int
    rg: int
    cw: int
    cluster: int
    clusters: int
    span: int
    magic: tuple

    @property
    def ctas(self):
        return self.clusters * self.cluster

    @property
    def smem(self):
        """Shared memory a CTA of the widest launch takes, bytes."""
        return self.rg * self.cw * 4

    def groups(self):
        """(first row, rows) of each row group."""
        return [(r0, min(self.rg, self.rows - r0))
                for r0 in range(0, self.rows, self.rg)]

    def tiles(self):
        """(first column, columns) of each column tile."""
        return [(c0, min(self.cw, self.cols - c0))
                for c0 in range(0, self.cols, self.cw)]

    @property
    def launches(self):
        """Kernel launches a call."""
        return len(self.groups()) * len(self.tiles()) * \
            (2 if self.clusters > 1 else 1)

    @property
    def scratch_floats(self):
        return self.clusters * self.rg * self.cw if self.clusters > 1 else 0

    def cta_range(self, g):
        lo = g * self.span
        return min(lo, self.n), min(lo + self.span, self.n)


def scatter_tile(rows, cols, smem_limit=SMEM_OPTIN):
    """(rg, cw): the rows and columns one scatter launch takes.  A launch
    takes up to ``SCATTER_MAX_ROWS`` rows, and as few equal column tiles as
    keep a CTA's partial (rg, cw) f32 within ``smem_limit`` bytes."""
    floats = smem_limit // 4
    rg = min(SCATTER_MAX_ROWS, rows)
    tiles = -(-rg * cols // floats)
    while rg * -(-cols // tiles) > floats:
        tiles += 1
    return rg, -(-cols // tiles)


def scatter_plan(n, rows, cols, cluster, active=0, smem_limit=SMEM_OPTIN):
    """The scatter path's plan for ``cluster``-CTA clusters: one cluster for
    every ``CLUSTER_ELEMS`` elements, at most ``active`` (the clusters the
    card holds at once; 0: no cap), the elements split evenly over the
    CTAs in spans of a multiple of 4."""
    if not 0 < n < 1 << 31 or rows < 1 or cols < 1:
        raise ValueError(f"bad scatter shape n={n} rows={rows} cols={cols}")
    if cluster not in (8, 16):
        raise ValueError(f"cluster must be 8 or 16, got {cluster}")
    rg, cw = scatter_tile(rows, cols, smem_limit)
    clusters = -(-n // CLUSTER_ELEMS)
    if active:
        clusters = min(clusters, active)
    span = -(-n // (clusters * cluster))
    span = -(-span // 4) * 4
    return ScatterPlan(n, rows, cols, rg, cw, cluster, clusters, span,
                       divisor_magic(cols))


# the C entries of csrc/count_sketch.cu and their arguments
_U32P = ctypes.POINTER(ctypes.c_uint32)
_INTP = ctypes.POINTER(ctypes.c_int)
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ENTRIES = {
    "repro_count_sketch_fold_scratch": [_LL, _I,
                                        ctypes.POINTER(ctypes.c_longlong)],
    "repro_count_sketch_fold": [_P, _U32P, _U32P, _P, _P, _LL, _LL, _I, _I,
                                _P],
    "repro_count_sketch_setup": [_INTP],
    "repro_count_sketch_cluster": [_I, _I, _INTP, _INTP],
    "repro_count_sketch_scatter": [_P, _U32P, _U32P, _P, _P, _LL, _I, _I, _I,
                                   _I, _LL, _I, _I, ctypes.c_uint32, _I, _I,
                                   _P],
}


def _entry(name):
    return build.function("count_sketch", name, _ENTRIES[name])


# per device index: the opt-in shared memory (read once the kernels'
# attributes are set), the (cluster, active) answer by (shared memory,
# tiled), the scatter plans by (n, rows, cols)
_OPTIN: dict = {}
_CLUSTER: dict = {}
_PLANS: dict = {}


def _device_cluster(dev, smem, tiled):
    key = (dev, smem, tiled)
    if key not in _CLUSTER:
        cluster, active = ctypes.c_int(0), ctypes.c_int(0)
        build.check(_entry("repro_count_sketch_cluster")(
            smem, int(tiled), ctypes.byref(cluster), ctypes.byref(active)),
            "count_sketch cluster query")
        _CLUSTER[key] = (cluster.value, active.value)
    return _CLUSTER[key]


def device_plan(dev, n, rows, cols):
    """The scatter plan on CUDA device index ``dev``, cached per (device,
    n, rows, cols): the cluster size from the card (16 where it holds a
    cluster of 16 at the plan's shared memory, else 8) and the clusters it
    holds at once."""
    key = (dev, n, rows, cols)
    if key not in _PLANS:
        setup = _entry("repro_count_sketch_setup")
        with torch.cuda.device(dev):
            if dev not in _OPTIN:
                optin = ctypes.c_int(0)
                build.check(setup(ctypes.byref(optin)), "count_sketch setup")
                _OPTIN[dev] = optin.value
            rg, cw = scatter_tile(rows, cols, _OPTIN[dev])
            cluster, active = _device_cluster(dev, rg * cw * 4, cw < cols)
        _PLANS[key] = scatter_plan(n, rows, cols, cluster, active,
                                   _OPTIN[dev])
    return _PLANS[key]


def _words(vals, rows, name):
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
    a, b = _ints(a), _ints(b)
    bv = _words(b, rows, "b")
    fold = fold_path(cols)
    if fold:
        iv = _words(inverses(a), rows, "a^-1")
        size, fn = (_entry("repro_count_sketch_fold_scratch"),
                    _entry("repro_count_sketch_fold"))
    else:
        av = _words(a, rows, "a")
        fn = _entry("repro_count_sketch_scatter")
        plan = device_plan(x.device.index, n, rows, cols)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        S = torch.empty((rows, cols), dtype=torch.float32, device=x.device)
        if fold:
            floats = ctypes.c_longlong(0)
            build.check(size(n, cols, ctypes.byref(floats)),
                        "count_sketch fold plan")
            scratch = torch.empty((max(1, floats.value),),
                                  dtype=torch.float32, device=x.device)
            err = fn(x.data_ptr(), bv, iv, S.data_ptr(), scratch.data_ptr(),
                     floats.value, n, rows, cols, stream)
        else:
            # one cluster (every paper_lm leaf) writes S directly: no scratch
            scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32,
                                  device=x.device) \
                if plan.scratch_floats else None
            err = fn(x.data_ptr(), av, bv, S.data_ptr(),
                     None if scratch is None else scratch.data_ptr(), n,
                     rows, cols, plan.rg, plan.cw, plan.span, plan.cluster,
                     plan.clusters, *plan.magic, stream)
    build.LAUNCHES["count_sketch"] += 1
    build.LAUNCHES["count_sketch/fold" if fold
                   else "count_sketch/scatter"] += 1
    build.check(err, "count_sketch")
    return S
