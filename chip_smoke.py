#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure (the exit code is non-zero and no result
line is printed):

  1. the card (``nvidia-smi`` name and power limit) and the versions;
  2. the kernel build: every ``kernels/csrc/*.cu`` compiled in parallel;
  3. each CUDA kernel against its plain PyTorch version at the shapes of
     the main paths (the paper_lm leaves and top-k carriers, odd, short
     and unaligned ones included, and the largest llama3_2_1b leaf,
     ``w_up`` at 268,435,456 elements), with the kernel's, the plain
     version's and the bound's times.  Codes, packed bytes, scales and
     counts are bit-equal; the ternarize kernels' per-row ``psum`` is a sum
     in another order, held at a relative error of 1e-6; the count
     sketch's buckets are sums in another order, held at
     ``|S - S_plain| <= 1e-4 * M`` (M the bucket's absolute mass) at every
     paper_lm leaf size with its adapted width (rows 3 and 5), on both of
     its paths.  The fold path (power-of-two widths, bound by bytes) also
     runs at an unaligned view (n = 65,536), n = 300,000 (ragged), n =
     5,000 below 2 * 4,096, n = 80 at 8 columns, 10 rows in one fold (n =
     100,000), 131,072 columns and w_up (5 x 4096), and two launches on
     one input must be bit-identical there.  The scatter path (other
     widths, bound by its INT32 hash work) runs at n = 3001, an unaligned
     view, 10 rows (two row groups) and rows of 70,000 columns (column
     tiles), and its grid rule is timed both ways (one CTA per paper_lm
     leaf, or a CTA per 4096 elements);
  4. slice 1's path: paper_lm at full width, 8 clients, 3 sim rounds of
     EF ``topk:0.05>>qsgd:8`` and ``topk:0.05>>qsgd:4@fused``, each with
     ``backend="kernel"`` and with the plain backend on the card — params,
     EF residuals and ledgers must be bit-identical between the two;
  4b. slice 2's path: paper_lm at full width, 8 clients, on both backends,
     of EF ``stc`` (0.01) with an ``lfl8`` downlink, EF ``stc:0.1@fused``,
     EF ``topk:0.1>>ternary@fused`` and DGC ``topk`` (0.01, momentum 0.9).
     First, outside the counted phases, round 1 from one state gives
     identical codes, supports, downlinked params and ledger on both
     backends, mu within rtol 1e-5 (DGC: identical rows); then 3
     free-running rounds of each, whose losses are printed with their
     largest relative gap (DGC: bit-identical runs);
  4c. slice 3's path: paper_lm at full width, 8 clients, E=2, lr 0.1, on
     both backends, of the reference's FetchSGD runs: EF ``sketch``
     (top-k fraction 0.1) and EF ``sketch>>qsgd:8``.  First, outside the
     counted phases, round 1 from one state gives identical deltas,
     losses and ledger on both backends and every client's sketch within
     phase 3's tolerance, and prints the overlap of the decoded supports;
     then 3 free-running rounds of each, whose losses may differ by a
     relative 1e-3 at most;
  4d. the kernel-less stages on paper_lm, one round each on the card's
     plain ops: EF ``sbc`` (0.01), ``randmask:0.05``, EF ``hsq`` and
     ``uveq``, each with a finite loss and the ledger equal to its static
     terms;
  5. llama3_2_1b at full width and depth (bf16), 2 clients, 2 rounds of
     ``topk:0.05>>qsgd:4@fused`` through the kernels;
  5b. the same of EF ``stc:0.1@fused`` with an ``lfl8`` downlink;
  5c. the same of EF ``sketch>>qsgd:8``.  Phases 5-5c need a finite loss
     and the ledger equal to its static terms, and print the peak memory.
     The kernel runs of phases 4-5c go under ``torch.profiler``, which
     prints the device's busy share and device time by launching operator;
  6. the ``kernels`` JSON line: launch counts are those of the main-path
     phases (4, 4b, 4c, 4d, 5, 5b, 5c), each counted from 0 just before its
     phase (the count sketch's by path too, each of which must launch);
     the pack and unpack kernels are on no path and count their phase-3
     calls;
  7. last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""
import json
import os
import re
import subprocess
import sys
import time

# cuBLAS needs this before its first handle for deterministic GEMMs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.utils.deterministic  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
# H100 SXM INT32: 64 INT32 lanes per SM (Hopper white paper) on 132 SMs at
# the 1.98 GHz boost clock that the f32 peak above also assumes
INT32_OPS_PER_S = 132 * 64 * 1.98e9

PAPER_LM_CLIENTS, PAPER_LM_SEQ, PAPER_LM_BATCH, PAPER_LM_ROUNDS = 8, 32, 2, 3
LLAMA_CLIENTS, LLAMA_SEQ, LLAMA_BATCH, LLAMA_ROUNDS = 2, 128, 1, 2
LLAMA_W_UP = 268_435_456
CHAINS = ("topk:0.05>>qsgd:8", "topk:0.05>>qsgd:4@fused")
# slice 2's path: (label, FLConfig knobs, kernels the kernel backend runs)
STC_RUNS = (
    ("EF stc 0.01 + lfl8", dict(uplink_compressor="stc", topk_fraction=0.01,
                                downlink_compressor="lfl8"),
     ("threshold_sparsify", "ternarize", "qsgd_quantize")),
    ("EF stc:0.1@fused", dict(uplink_compressor="stc:0.1@fused"),
     ("ternarize_pack",)),
    ("EF topk:0.1>>ternary@fused",
     dict(uplink_compressor="topk:0.1>>ternary@fused"),
     ("threshold_sparsify", "ternarize_pack")),
    ("DGC topk 0.01 m0.9", dict(uplink_compressor="topk", topk_fraction=0.01,
                                dgc_momentum=0.9),
     ("threshold_sparsify",)),
)
LLAMA_STC = dict(uplink_compressor="stc:0.1@fused", downlink_compressor="lfl8")
# slice 3's path: the reference's FetchSGD runs (benchmarks/run.py
# bench_bytes_to_loss "sketch" and bench_combined "sketch+qsgd8"), E=2,
# lr 0.1, EF on (the sketch is biased)
SKETCH_RUNS = (
    ("EF sketch f0.1", dict(uplink_compressor="sketch", topk_fraction=0.1),
     ("count_sketch",)),
    ("EF sketch>>qsgd:8", dict(uplink_compressor="sketch>>qsgd:8"),
     ("count_sketch", "qsgd_quantize")),
)
SKETCH_LR = 0.1
# the kernel-less stages, one round each on the card's plain ops
PLAIN_STAGES = (("EF sbc 0.01", dict(uplink_compressor="sbc",
                                     topk_fraction=0.01)),
                ("randmask:0.05", dict(uplink_compressor="randmask:0.05")),
                ("EF hsq", dict(uplink_compressor="hsq")),
                ("uveq", dict(uplink_compressor="uveq")))
LLAMA_SKETCH = dict(uplink_compressor="sketch>>qsgd:8")
SKETCH_TOL = 1e-4                # |S - S_plain| <= 1e-4 * bucket mass
# the CUDA entry points of kernels/csrc, as the profiler names them
OUR_KERNELS = ("threshold_sparsify_vec4", "threshold_sparsify_scalar",
               "qsgd_quantize_rows", "qsgd_pack_rows", "ternarize_rows",
               "ternarize_pack_rows", "pack_codes_words",
               "unpack_codes_words", "count_sketch_fold",
               "count_sketch_unfold", "count_sketch_partial",
               "count_sketch_reduce")
# count_sketch's launches by path, beside its total
SKETCH_PATHS = ("count_sketch/fold", "count_sketch/scatter")
# name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "threshold_sparsify": ("src/repro_torch/kernels/csrc/topk_mask.cu",
                           "src/repro/kernels/topk_mask.py:31"),
    "qsgd_quantize": ("src/repro_torch/kernels/csrc/qsgd.cu",
                      "src/repro/kernels/qsgd.py:35"),
    "qsgd_pack": ("src/repro_torch/kernels/csrc/bitpack.cu",
                  "src/repro/kernels/bitpack.py:108"),
    "ternarize": ("src/repro_torch/kernels/csrc/ternary.cu",
                  "src/repro/kernels/ternary.py:36"),
    "ternarize_pack": ("src/repro_torch/kernels/csrc/bitpack.cu",
                       "src/repro/kernels/bitpack.py:69"),
    "pack_codes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                   "src/repro/kernels/bitpack.py:141"),
    "unpack_codes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                     "src/repro/kernels/bitpack.py:161"),
    "count_sketch": ("src/repro_torch/kernels/csrc/count_sketch.cu",
                     "src/repro/kernels/count_sketch.py:52"),
}
OFF_PATH = ("pack_codes", "unpack_codes")      # no path runs them


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps):
    """Device time of one call of ``fn`` (the sum over the kernels it
    launches, by name), from ``torch.profiler`` over ``reps`` calls: at
    small shapes ``cuda_ms`` times the host's launch rate instead."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            name = re.search(r"(\w+)(<[^>]*>)?\(", e.key)
            name = name.group(1) if name else e.key
            by_kernel[name] = by_kernel.get(name, 0.0) + us / reps / 1e3
    return sum(by_kernel.values()), by_kernel


def max_abs_err(a, b):
    """Max |a - b| over the outputs of a kernel and its plain version."""
    err = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"output shape/dtype {tuple(x.shape)} {x.dtype} != "
                 f"{tuple(y.shape)} {y.dtype}")
        d = (x.to(torch.float64) - y.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def psum_rel_err(a, b):
    """Max relative error of a per-row f32 sum against its plain version."""
    d = (a.double() - b.double()).abs()
    return float((d / b.double().abs().clamp(min=1e-30)).max()) \
        if d.numel() else 0.0


def check_kernels(dev):
    from repro_torch.compress.sparsification import _k
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.model import Model

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    leaves = sorted(set(Model(get_arch("paper_lm")).param_sizes()))
    # the top-k carriers each leaf hands to QSGD, with the QSGD block
    # adapted to min(2048, k): short, odd and multi-row carriers
    carriers = sorted({_k(n, 0.05) for n in leaves} | {3001})
    # the carriers the ternary stage gets from stc (0.01) and topk:0.1
    tern_carriers = sorted({_k(n, f) for n in leaves for f in (0.01, 0.1)})
    tern_sizes = sorted(set(leaves + tern_carriers + [100, 3001]))
    sizes = {"threshold_sparsify": leaves + [3001, LLAMA_W_UP],
             "qsgd_quantize": carriers + [_k(LLAMA_W_UP, 0.05)],
             "qsgd_pack": [k for k in carriers if min(2048, k) % 2 == 0]
             + [_k(LLAMA_W_UP, 0.05)],
             # "u" marks an unaligned view (x[1:], the scalar load path)
             "ternarize": tern_sizes + ["u5001", LLAMA_W_UP],
             "ternarize_pack": tern_sizes + ["u5001", LLAMA_W_UP],
             # (rows, block): short rows with a byte-wise tail, then full ones
             "pack_codes": [(3, 20)] + [(-(-n // 2048), 2048)
                                        for n in leaves + [LLAMA_W_UP]],
             "unpack_codes": [(3, 20)] + [(-(-n // 2048), 2048)
                                          for n in leaves + [LLAMA_W_UP]]}
    print(f"paper_lm leaf sizes {leaves}; top-k carriers {carriers}; "
          f"ternary carriers {tern_carriers}")
    build.LAUNCHES.clear()
    results = {}
    for name, ns in sizes.items():
        worst, worst_rel = 0.0, 0.0
        for n in ns:
            for variant in (2, 4) if name in OFF_PATH else (None,):
                row = check_one(name, n, variant, g, dev)
                worst = max(worst, row["max_abs_err"])
                worst_rel = max(worst_rel, row.get("psum_rel_err", 0.0))
                if variant in (None, 2):
                    results[name] = dict(row, max_abs_err=worst)
                    if "psum_rel_err" in row:
                        results[name]["psum_rel_err"] = worst_rel
        results[name]["calls"] = build.LAUNCHES[name]
    results["count_sketch"] = check_count_sketch(leaves, g, dev)
    results["count_sketch"]["calls"] = build.LAUNCHES["count_sketch"]
    return results


def sketch_mass(x, a, b, rows, cols):
    """Each bucket's absolute mass, the plain sketch of |x| with every sign
    +1 (f64): the scale of the tolerance on S."""
    from repro_torch.compress.sketch import _chunks, bucket_and_sign
    M = torch.zeros(rows * cols, dtype=torch.float64, device=x.device)
    offs = torch.arange(rows, device=x.device)[:, None] * cols
    for lo, hi in _chunks(x.shape[0]):
        h, _ = bucket_and_sign(torch.arange(lo, hi, device=x.device), a, b,
                               cols)
        M.index_add_(0, (h + offs).reshape(-1),
                     x[lo:hi].abs().double().expand(rows, -1).reshape(-1))
    return M.reshape(rows, cols)


def check_count_sketch(leaves, g, dev):
    """Kernel #6 against its plain version, all shapes with the same hash
    parameters per row count: ``|S - S_plain| <= SKETCH_TOL * M + 1e-30``
    elementwise, M the bucket mass.  The fold path (power-of-two widths)
    runs at the paper_lm leaves of 65,536 elements and more, an unaligned
    view, a ragged n, n below 2 * cols, 8 columns, 10 rows in one fold,
    131,072 columns and w_up (5 x 4096); two launches on one input must be
    bit-identical there.  The scatter path runs at the other paper_lm
    leaves (rows 3 and 5), n = 3001, an unaligned view, 10 rows (two row
    groups) and rows of 70,000 columns (column tiles); its relaunches are
    compared and printed (the order of the shared-memory atomics may
    vary).  Its grid rule is timed both ways at paper_lm's 32,768 x 3,276
    and 16,384 x 1,638 leaves (5 rows).  Returns the fold path's w_up row
    with both paths' rows under ``paths``."""
    from repro_torch.compress.sketch import CountSketch, hash_params
    from repro_torch.kernels import count_sketch as cs

    # (n, rows[, cols]), "u" marking an unaligned view (x[1:]); the
    # explicit widths take the other plans (the spec grammar allows any
    # sketch:r,c)
    shapes = ([(n, r) for r in (3, 5) for n in leaves]
              + [(3001, 5), ("u5001", 5), ("u65536", 5), (300_000, 5),
                 (5000, 5, 4096), (80, 5), (5000, 10, 500),
                 (100_000, 10, 4096), (500_000, 2, 70_000),
                 (600_000, 2, 131_072), (LLAMA_W_UP, 5)])
    rules = {(32_768, 5), (16_384, 5)}
    worst, worst_abs, largest, paths = 0.0, 0.0, {}, {}
    same_by_path = {"fold": True, "scatter": True}
    for n, rows, *width in shapes:
        label = n
        if isinstance(n, str):
            n = int(n[1:])
            x = (torch.randn(n + 1, generator=g, device=dev) * 2.0)[1:]
            label = f"{n} (unaligned)"
        else:
            x = torch.randn(n, generator=g, device=dev) * 2.0
        cols = width[0] if width else CountSketch(rows, 4096)._cols(n)
        path = "fold" if cs.fold_path(cols) else "scatter"
        a, b = hash_params(rows)
        P = cs.count_sketch_plain(x, a, b, rows, cols)
        M = sketch_mass(x, a, b, rows, cols)

        def held(S, what):
            torch.cuda.synchronize()
            if S.shape != P.shape or S.dtype != P.dtype:
                fail(f"count_sketch n={label} {what}: shape/dtype "
                     f"{tuple(S.shape)} {S.dtype} != {tuple(P.shape)} "
                     f"{P.dtype}")
            err = (S.double() - P.double()).abs()
            ratio = float((err / M.clamp(min=1e-30)).max())
            if not bool((err <= SKETCH_TOL * M + 1e-30).all()):
                fail(f"count_sketch n={label} rows={rows} cols={cols} "
                     f"{what}: |S - S_plain| exceeds {SKETCH_TOL} of the "
                     f"bucket mass (worst ratio {ratio:.3e})")
            return ratio, float(err.max())

        kern = lambda: cs.count_sketch_cuda(x, a, b, rows, cols)
        plain = lambda: cs.count_sketch_plain(x, a, b, rows, cols)
        S, S2 = kern(), kern()
        ratio, abs_err = held(S, path)
        same = torch.equal(S, S2)
        if path == "fold" and not same:
            fail(f"count_sketch n={label} rows={rows} cols={cols}: two "
                 f"launches of the fold path differ")
        same_by_path[path] = same_by_path[path] and same
        worst, worst_abs = max(worst, ratio), max(worst_abs, abs_err)
        big = n > 1 << 24
        ms = cuda_ms(kern, 20 if big else 200)
        plain_ms = cuda_ms(plain, 3 if big else 20)
        byte_ms = (4 * n + 4 * rows * cols) / HBM_BYTES_PER_S * 1e3
        # the scatter path hashes every (row, element): about 6 INT32
        # operations each; the fold path hashes nothing
        op_ms = 6 * rows * n / INT32_OPS_PER_S * 1e3 if path == "scatter" \
            else 0.0
        bound_ms = max(byte_ms, op_ms)
        dev_ms, split = device_ms(kern, 10 if big else 50)
        row = dict(n=f"{label} x {rows}x{cols}", ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bytes_bound_ms=byte_ms,
                   bound_by="bytes" if byte_ms >= op_ms else "operations",
                   device_ms=dev_ms, device_ms_by_kernel=split)
        bounds = f"bytes {byte_ms:.4f}"
        if path == "scatter":
            row["int32_bound_ms"] = op_ms
            bounds += f", INT32 {op_ms:.4f}"
        rule_note = ""
        if (n, rows) in rules and path == "scatter":
            # the grid rule: a CTA takes at least 4096 elements (built in),
            # or max(4 rows cols, 16384), which puts a paper_lm leaf on one
            # CTA; device time, as the events time the host here
            one = max(4 * rows * cols, 16384)
            for rule, span in (("one_cta", one), ("per_4096", 4096)):
                k = lambda: cs.count_sketch_cuda(x, a, b, rows, cols,
                                                 min_span=span)
                held(k(), f"grid rule {rule}")
                row[f"device_ms_{rule}"] = device_ms(k, 50)[0]
            rule_note = (f"; grid rule device_ms: one CTA per {one} "
                         f"elements {row['device_ms_one_cta']:.4f} "
                         f"({-(-n // one)} CTAs), a CTA per 4096 elements "
                         f"{row['device_ms_per_4096']:.4f} "
                         f"({-(-n // 4096)} CTAs)")
        print(f"kernel count_sketch/{path:7s} n={label!s:>20} rows={rows} "
              f"cols={cols} err/mass={ratio:.2e} relaunch bit-identical="
              f"{'yes' if same else 'no'} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} device_ms={dev_ms:.4f} ("
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f") bound_ms={bound_ms:.4f} ({bounds}; "
              f"{100 * bound_ms / ms:.0f}% of bound){rule_note}", flush=True)
        if n >= largest.get(path, 0):        # each path's largest shape
            largest[path], paths[path] = n, row
        del x, S, S2, P, M
    print(f"count_sketch: {len(shapes)} shapes within {SKETCH_TOL} of the "
          f"bucket mass (worst ratio {worst:.3e}); two launches on one "
          f"input bit-identical at every fold-path shape: yes, at every "
          f"scatter-path shape: {'yes' if same_by_path['scatter'] else 'no'}",
          flush=True)
    return dict(paths["fold"], max_abs_err=worst_abs,
                sketch_err_over_mass=worst,
                relaunch_bit_identical=same_by_path, paths=paths)


def check_one(name, n, bits, g, dev):
    """One kernel at one shape against its plain version; fails on a
    mismatch.  Returns the timings and errors."""
    from repro_torch.compress.sparsification import _k, top_k_indices
    from repro_torch.kernels import bitpack, ops, qsgd, ternary, topk_mask

    psum_rel = None
    label = n
    if name in ("pack_codes", "unpack_codes"):
        rows, block = n
        half = 1 << (bits - 1)
        codes = torch.randint(-half, half, (rows, block), generator=g,
                              device=dev, dtype=torch.int8)
        numel = rows * block
        if name == "pack_codes":
            kern = lambda: (bitpack.pack_codes_cuda(codes, bits),)
            plain = lambda: (bitpack.pack_codes_plain(codes, bits),)
        else:
            packed = bitpack.pack_codes_plain(codes, bits)
            kern = lambda: (bitpack.unpack_codes_cuda(packed, bits),)
            plain = lambda: (bitpack.unpack_codes_plain(packed, bits),)
        nbytes = numel + numel * bits // 8
        n_ops = 3 * numel
        label = f"{rows}x{block} bits={bits}"
    else:
        unaligned = isinstance(n, str)
        if unaligned:
            n = int(n[1:])
            x = (torch.randn(n + 1, generator=g, device=dev) * 2.0)[1:]
            label = f"{n} (unaligned)"
        else:
            x = torch.randn(n, generator=g, device=dev) * 2.0
        u = torch.rand(n, generator=g, device=dev)
        blk = max(1, min(2048, n))
        nb = -(-n // blk)
        if name == "threshold_sparsify":
            _, t = top_k_indices(x, _k(n, 0.05))
            kern = lambda: topk_mask.threshold_sparsify_cuda(x, t)
            plain = lambda: topk_mask.threshold_sparsify_plain(x, t)
            nbytes = 12 * n + 4
            n_ops = 3 * n
        elif name == "qsgd_quantize":
            kern = lambda: qsgd.qsgd_quantize_cuda(x, u, 8, blk)
            plain = lambda: qsgd.qsgd_quantize_plain(x, u, 8, blk)
            nbytes = 8 * n + nb * blk + 4 * nb
            n_ops = 8 * n
        elif name == "qsgd_pack":
            kern = lambda: bitpack.qsgd_pack_cuda(x, u, 4, blk)
            plain = lambda: bitpack.qsgd_pack_plain(x, u, 4, blk)
            nbytes = 8 * n + nb * blk // 2 + 4 * nb
            n_ops = 10 * n
        else:
            # the ternary stages' pass at threshold 0 on a carrier, and the
            # fused STC's at the top-k (0.1) threshold on a leaf; both
            # thresholds are checked, the top-k one is timed
            nb = -(-n // 2048)
            fn_k = ternary.ternarize_cuda if name == "ternarize" else \
                bitpack.ternarize_pack_cuda
            fn_p = ternary.ternarize_plain if name == "ternarize" else \
                bitpack.ternarize_pack_plain
            for t in (torch.zeros(1, device=dev), ops._stc_threshold(x, 0.1)):
                kern = lambda t=t: fn_k(x, t)
                plain = lambda t=t: fn_p(x, t)
                ko, po = kern(), plain()
                torch.cuda.synchronize()
                for i in (0, 2):          # codes or packed bytes, pcnt
                    if not torch.equal(ko[i], po[i]):
                        fail(f"{name} n={label} t={float(t)}: output {i} "
                             f"differs from the plain version")
                rel = psum_rel_err(ko[1], po[1])
                if rel > 1e-6:
                    fail(f"{name} n={label}: psum relative error {rel}")
                psum_rel = max(psum_rel or 0.0, rel)
            code_bytes = nb * 2048 if name == "ternarize" else nb * 512
            nbytes = 4 * n + code_bytes + 8 * nb + 4
            n_ops = 4 * n
    err = max_abs_err(kern(), plain())
    torch.cuda.synchronize()
    if psum_rel is None and err != 0.0:
        fail(f"{name} n={label}: kernel differs from its plain version "
             f"(max abs err {err})")
    numel = n if isinstance(n, int) else n[0] * n[1]
    reps = 20 if numel > 1 << 24 else 200
    ms, plain_ms = cuda_ms(kern, reps), cuda_ms(plain, reps)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3
    exact = "bit-equal=yes" if psum_rel is None else \
        f"codes,pcnt bit-equal=yes psum_rel_err={psum_rel:.2e}"
    print(f"kernel {name:18s} n={label!s:>20} {exact} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} "
          f"(bytes={nbytes:,}, {100 * bound_ms / ms:.0f}% of bound)",
          flush=True)
    row = dict(n=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S
               >= n_ops / F32_OPS_PER_S else "operations", max_abs_err=err)
    if psum_rel is not None:
        row["psum_rel_err"] = psum_rel
    return row


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def fed_data(model, clients, seq, batch):
    from repro_torch.data.synthetic import FedDataConfig
    return FedDataConfig(vocab_size=model.cfg.vocab_size,
                         num_clients=clients, seq_len=seq,
                         batch_per_client=batch, heterogeneity=1.5)


def run_sim(model, fl_kw, backend, clients, seq, batch, rounds, dev,
            local_steps, local_lr):
    from repro_torch.core.engine import run_rounds
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import sample_round

    fl = FLConfig(backend=backend, local_steps=local_steps,
                  local_lr=local_lr, **fl_kw)
    sim = make_sim_step(model, fl, clients, chunk=seq, device=dev)
    data = fed_data(model, clients, seq, batch)
    state = sim.init_fn(0)
    state, ms = run_rounds(sim.engine, state,
                           lambda r: sample_round(data, r, dev), rounds)
    torch.cuda.synchronize()
    return sim, state, ms


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def check_ledger(sim, ms, clients, what):
    """Every round's ledger equals the static terms times the selected
    client count, in float32."""
    terms = sim.terms
    want = {"uplink_wire": terms["up_wire"],
            "uplink_entropy": terms["up_entropy"],
            "downlink_wire": terms["down_wire"],
            "uplink_dense": terms["dense"], "downlink_dense": terms["dense"]}
    for name, term in want.items():
        got = getattr(ms["ledger"], name).cpu()
        exp = (torch.tensor(float(clients), dtype=torch.float32)
               * torch.tensor(term, dtype=torch.float32))
        if not torch.equal(got, exp.expand_as(got)):
            fail(f"{what}: ledger {name} {got.tolist()} != {float(exp)}")


def launch_counts():
    from repro_torch.kernels import build
    return {name: build.LAUNCHES[name] for name in KERNELS}


def paper_lm_phase(dev):
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    # kernels each chain's kernel backend must launch (under @fused the odd
    # short carriers, e.g. the norms' k = 13, quantize staged and pack in
    # PyTorch); the plain backend must launch none
    expect = {CHAINS[0]: ("threshold_sparsify", "qsgd_quantize"),
              CHAINS[1]: ("threshold_sparsify", "qsgd_quantize",
                          "qsgd_pack")}

    model = Model(get_arch("paper_lm"))
    print(f"paper_lm: {model.param_count():,} params in "
          f"{len(model.defs)} leaves, {PAPER_LM_CLIENTS} clients, seq "
          f"{PAPER_LM_SEQ}, batch {PAPER_LM_BATCH}, {PAPER_LM_ROUNDS} rounds, "
          f"E=2 lr=0.2", flush=True)
    for spec in CHAINS:
        runs = {}
        for backend in ("kernel", "jax"):
            before = launch_counts()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                sim, state, ms = run_sim(model, dict(uplink_compressor=spec),
                                         backend,
                                         PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                                         PAPER_LM_BATCH, PAPER_LM_ROUNDS, dev,
                                         2, 0.2)
            secs = time.perf_counter() - t0
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, expect[spec] if backend == "kernel" else (),
                           f"paper_lm {spec} backend={backend}")
            losses = [float(v) for v in ms["loss"]]
            if not all(v == v and abs(v) < 1e6 for v in losses):
                fail(f"paper_lm {spec} {backend}: loss not finite {losses}")
            check_ledger(sim, ms, PAPER_LM_CLIENTS, f"paper_lm {spec}")
            print(f"paper_lm {spec} backend={backend}: loss per round "
                  f"{[round(v, 6) for v in losses]} "
                  f"up={float(ms['ledger'].uplink_wire[0]):,.0f} B/round "
                  f"launches {ran} ({secs:.2f}s under the profiler)",
                  flush=True)
            if backend == "kernel":
                print_profile(prof, secs, f"paper_lm {spec}", top=6)
            runs[backend] = (state, ms)
        (sk, mk), (sp, mp) = runs["kernel"], runs["jax"]
        pairs = (list(zip(_tensors(sk.params), _tensors(sp.params)))
                 + list(zip(_tensors(sk.comm_state), _tensors(sp.comm_state)))
                 + [(getattr(mk["ledger"], f), getattr(mp["ledger"], f))
                    for f in mk["ledger"].fields()]
                 + [(mk["loss"], mp["loss"])])
        for a, b in pairs:
            if not torch.equal(a, b):
                fail(f"paper_lm {spec}: kernel backend differs from the "
                     f"plain backend (max abs err "
                     f"{float((a.double() - b.double()).abs().max())})")
        print(f"paper_lm {spec}: kernel and plain backends bit-identical "
              f"({len(pairs)} tensors: params, EF residuals, ledger, loss)",
              flush=True)


def llama_phase(dev, fl_kw, expect, what):
    """llama3_2_1b at full width and depth through the kernels: finite
    loss and params, the ledger equal to its static terms, and the kernels
    of ``expect`` launched."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch("llama3_2_1b")
    model = Model(cfg)
    print(f"llama3_2_1b ({what}): {model.param_count():,} params, "
          f"{cfg.num_layers} layers (no depth cut), d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; {LLAMA_CLIENTS} clients, seq "
          f"{LLAMA_SEQ}, batch {LLAMA_BATCH}, {LLAMA_ROUNDS} rounds of "
          f"{fl_kw} backend=kernel", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sim, state, ms = run_sim(model, fl_kw, "kernel", LLAMA_CLIENTS,
                                 LLAMA_SEQ, LLAMA_BATCH, LLAMA_ROUNDS, dev, 1,
                                 0.05)
    secs = time.perf_counter() - t0
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    check_launches(ran, expect, f"llama3_2_1b {what}")
    losses = [float(v) for v in ms["loss"]]
    if not all(v == v and abs(v) < 1e6 for v in losses):
        fail(f"llama3_2_1b {what}: loss not finite {losses}")
    check_ledger(sim, ms, LLAMA_CLIENTS, f"llama3_2_1b {what}")
    for t in _tensors(state.params):
        if not bool(torch.isfinite(t).all()):
            fail(f"llama3_2_1b {what}: non-finite parameters")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"llama3_2_1b {what}: loss per round "
          f"{[round(v, 6) for v in losses]} "
          f"up={float(ms['ledger'].uplink_wire[0]):,.0f} B/round "
          f"down={float(ms['ledger'].downlink_wire[0]):,.0f} B/round, "
          f"ledger == static terms, launches {ran}, peak memory {peak:.1f} "
          f"GiB, {secs:.2f}s under the profiler", flush=True)
    print_profile(prof, secs, f"llama3_2_1b {what}")
    del sim, state, ms
    torch.cuda.empty_cache()


def check_launches(ran, expect, what):
    """The kernels of ``expect`` launched, and no other."""
    for name, count in ran.items():
        if (count > 0) != (name in expect):
            fail(f"{what}: {name} launched {count} times (expected "
                 f"{'some' if name in expect else 'none'})")


def first_round(model, fl_kw, backend, dev, local_lr=0.2):
    """Round 1 of the sim program's hops from one fixed state: the
    downlinked params, the client losses, each client's decoded rows
    (whose signs are the codes and support, and whose magnitudes are mu
    on the ternary wires), the static ledger terms and the client deltas."""
    from repro_torch.core import engine as ET
    from repro_torch.core.rng import PRNGKey
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import sample_round

    fl = FLConfig(backend=backend, local_steps=2, local_lr=local_lr, **fl_kw)
    terms, up, down = ET.ledger_terms(model, fl)
    disp = ET.make_dispatch(model, fl, up, down, PAPER_LM_CLIENTS,
                            PAPER_LM_SEQ)
    params = model.init(0, dev)
    batch = sample_round(fed_data(model, PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                                  PAPER_LM_BATCH), 0, dev)
    _, r_down, _, r_up, _ = PRNGKey(fl.seed).split(5)
    p_down = disp.downlink(params, r_down)
    deltas, losses, _ = disp.local_update(p_down,
                                          ET.Dispatch.model_batch(batch))
    rows, _ = disp.wire_rows(deltas, ET.comm_state_init(
        up, params, PAPER_LM_CLIENTS, dev) if up.stateful else None, r_up)
    torch.cuda.synchronize()
    return terms, p_down, losses, rows, deltas


def stc_first_rounds(dev):
    """Slice 2's path on paper_lm, round 1 from one state on both backends
    for each of ``STC_RUNS``: identical downlinked params, losses, codes,
    supports and ledger terms, mu within rtol 1e-5 (DGC: identical rows).
    A comparison of the backends, so it runs outside the counted phases."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    for label, fl_kw, _ in STC_RUNS:
        exact = "dgc_momentum" in fl_kw     # no mu: every output exact
        (tk, pk, lk, rk, _), (tp, pp, lp, rp, _) = (
            first_round(model, fl_kw, b, dev) for b in ("kernel", "jax"))
        if tk != tp:
            fail(f"{label}: ledger terms differ {tk} != {tp}")
        for (name, a), b in zip(pk.items(), pp.values()):
            if not torch.equal(a, b):
                fail(f"{label}: downlinked {name} differs between backends")
        if not torch.equal(lk, lp):
            fail(f"{label}: round-1 losses differ {lk} != {lp}")
        mu_rel = 0.0
        for (name, a), b in zip(rk.items(), rp.values()):
            if not torch.equal(torch.sign(a), torch.sign(b)):
                fail(f"{label}: round-1 codes or support of {name} differ")
            if exact and not torch.equal(a, b):
                fail(f"{label}: round-1 rows of {name} differ")
            nz = b != 0
            if bool(nz.any()):
                mu_rel = max(mu_rel, float(((a[nz] - b[nz]).abs()
                                            / b[nz].abs()).max()))
        if mu_rel > 1e-5:
            fail(f"{label}: round-1 mu relative error {mu_rel}")
        print(f"paper_lm {label}: round 1 from one state — codes, supports, "
              f"downlinked params, losses and ledger identical on both "
              f"backends; decoded |rows| (mu) max rel err {mu_rel:.2e}",
              flush=True)


def stc_phase(dev):
    """Slice 2's path on paper_lm: 3 free-running rounds on both backends
    for each of ``STC_RUNS``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    print(f"paper_lm STC path: {PAPER_LM_CLIENTS} clients, seq "
          f"{PAPER_LM_SEQ}, batch {PAPER_LM_BATCH}, {PAPER_LM_ROUNDS} rounds, "
          f"E=2 lr=0.2", flush=True)
    for label, fl_kw, expect in STC_RUNS:
        exact = "dgc_momentum" in fl_kw
        runs = {}
        for backend in ("kernel", "jax"):
            before = launch_counts()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                sim, state, ms = run_sim(model, fl_kw, backend,
                                         PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                                         PAPER_LM_BATCH, PAPER_LM_ROUNDS, dev,
                                         2, 0.2)
            secs = time.perf_counter() - t0
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, expect if backend == "kernel" else (),
                           f"paper_lm {label} backend={backend}")
            losses = [float(v) for v in ms["loss"]]
            if not all(v == v and abs(v) < 1e6 for v in losses):
                fail(f"paper_lm {label} {backend}: loss not finite {losses}")
            check_ledger(sim, ms, PAPER_LM_CLIENTS, f"paper_lm {label}")
            print(f"paper_lm {label} backend={backend}: loss per round "
                  f"{[round(v, 6) for v in losses]} "
                  f"up={float(ms['ledger'].uplink_wire[0]):,.0f} "
                  f"down={float(ms['ledger'].downlink_wire[0]):,.0f} B/round "
                  f"launches {ran} ({secs:.2f}s under the profiler)",
                  flush=True)
            if backend == "kernel":
                print_profile(prof, secs, f"paper_lm {label}", top=6)
            runs[backend] = (state, ms)
        (sk, mk), (sp, mp) = runs["kernel"], runs["jax"]
        gap = float(((mk["loss"] - mp["loss"]).abs() / mp["loss"].abs())
                    .max())
        if exact:
            for a, b in (list(zip(_tensors(sk.params), _tensors(sp.params)))
                         + list(zip(_tensors(sk.comm_state),
                                    _tensors(sp.comm_state)))):
                if not torch.equal(a, b):
                    fail(f"paper_lm {label}: kernel backend differs from "
                         f"the plain backend")
        print(f"paper_lm {label}: free-running loss, kernel vs plain, "
              f"largest relative gap {gap:.3e}"
              + (" (params and DGC state bit-identical)" if exact else ""),
              flush=True)


def sketch_first_rounds(dev):
    """Slice 3's path on paper_lm, round 1 from one state on both backends
    for each of ``SKETCH_RUNS``: identical losses and ledger terms, every
    client's sketch S of every leaf within phase 3's tolerance of the
    plain one, and the overlap of the decoded supports printed.  A
    comparison of the backends, so it runs outside the counted phases."""
    from repro_torch.compress import sketch as SK
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.types import FLConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    for label, fl_kw, _ in SKETCH_RUNS:
        (tk, _, lk, rk, dk), (tp, _, lp, rp, dp) = (
            first_round(model, fl_kw, b, dev, SKETCH_LR)
            for b in ("kernel", "jax"))
        if tk != tp:
            fail(f"{label}: ledger terms differ {tk} != {tp}")
        if not torch.equal(lk, lp):
            fail(f"{label}: round-1 losses differ {lk} != {lp}")
        fl = FLConfig(**fl_kw)
        stage = SK.CountSketch(fl.sketch_rows, fl.sketch_cols)
        a, b = SK.hash_params(stage.rows)
        worst, overlap = 0.0, 1.0
        for (name, d), d_p in zip(dk.items(), dp.values()):
            if not torch.equal(d, d_p):
                fail(f"{label}: round-1 deltas of {name} differ")
            for c in range(PAPER_LM_CLIENTS):
                x = d[c].reshape(-1).to(torch.float32)
                cols = stage._cols(x.shape[0])
                S_k = ops.sketch(x, stage.rows, cols)
                S_p = SK.sketch(x, stage.rows, cols)
                M = sketch_mass(x, a, b, stage.rows, cols)
                err = (S_k.double() - S_p.double()).abs()
                if not bool((err <= SKETCH_TOL * M + 1e-30).all()):
                    fail(f"{label}: round-1 sketch of {name} client {c} "
                         f"exceeds {SKETCH_TOL} of the bucket mass")
                worst = max(worst, float((err / M.clamp(min=1e-30)).max()))
        for (name, a_), b_ in zip(rk.items(), rp.values()):
            sk_, sp_ = a_ != 0, b_ != 0
            union = max(1, int((sk_ | sp_).sum()))
            overlap = min(overlap, int((sk_ & sp_).sum()) / union)
        print(f"paper_lm {label}: round 1 from one state — deltas, losses "
              f"and ledger identical on both backends; S within "
              f"{SKETCH_TOL} of the bucket mass (worst ratio {worst:.3e}); "
              f"decoded supports overlap >= {overlap:.4f} (intersection "
              f"over union, worst leaf)", flush=True)


def sketch_phase(dev):
    """Slice 3's path on paper_lm: 3 free-running rounds on both backends
    for each of ``SKETCH_RUNS``; the losses' largest relative gap must stay
    within 1e-3."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    print(f"paper_lm count-sketch path: {PAPER_LM_CLIENTS} clients, seq "
          f"{PAPER_LM_SEQ}, batch {PAPER_LM_BATCH}, {PAPER_LM_ROUNDS} rounds, "
          f"E=2 lr={SKETCH_LR}", flush=True)
    for label, fl_kw, expect in SKETCH_RUNS:
        losses = {}
        for backend in ("kernel", "jax"):
            before = launch_counts()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                sim, state, ms = run_sim(model, fl_kw, backend,
                                         PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                                         PAPER_LM_BATCH, PAPER_LM_ROUNDS, dev,
                                         2, SKETCH_LR)
            secs = time.perf_counter() - t0
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, expect if backend == "kernel" else (),
                           f"paper_lm {label} backend={backend}")
            loss = [float(v) for v in ms["loss"]]
            if not all(v == v and abs(v) < 1e6 for v in loss):
                fail(f"paper_lm {label} {backend}: loss not finite {loss}")
            check_ledger(sim, ms, PAPER_LM_CLIENTS, f"paper_lm {label}")
            print(f"paper_lm {label} backend={backend}: loss per round "
                  f"{[round(v, 6) for v in loss]} "
                  f"up={float(ms['ledger'].uplink_wire[0]):,.0f} B/round "
                  f"launches {ran} ({secs:.2f}s under the profiler)",
                  flush=True)
            if backend == "kernel":
                print_profile(prof, secs, f"paper_lm {label}", top=6)
            losses[backend] = ms["loss"]
        gap = float(((losses["kernel"] - losses["jax"]).abs()
                     / losses["jax"].abs()).max())
        if not gap <= 1e-3:
            fail(f"paper_lm {label}: free-running losses differ by {gap:.3e} "
                 f"(relative) between the backends, above 1e-3")
        print(f"paper_lm {label}: free-running loss, kernel vs plain, "
              f"largest relative gap {gap:.3e} (limit 1e-3)", flush=True)


def plain_stages_phase(dev):
    """The kernel-less stages on paper_lm, one round each on the card's
    plain ops: a finite loss, the ledger equal to its static terms, and no
    kernel launched."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    for label, fl_kw in PLAIN_STAGES:
        before = launch_counts()
        t0 = time.perf_counter()
        sim, _, ms = run_sim(model, fl_kw, "jax", PAPER_LM_CLIENTS,
                             PAPER_LM_SEQ, PAPER_LM_BATCH, 1, dev, 2, 0.2)
        secs = time.perf_counter() - t0
        check_launches({k: v - before[k]
                        for k, v in launch_counts().items()}, (),
                       f"paper_lm {label}")
        loss = float(ms["loss"][0])
        if not (loss == loss and abs(loss) < 1e6):
            fail(f"paper_lm {label}: loss not finite {loss}")
        check_ledger(sim, ms, PAPER_LM_CLIENTS, f"paper_lm {label}")
        print(f"paper_lm {label} (uplink {fl_kw['uplink_compressor']}, "
              f"plain backend): round-1 loss "
              f"{loss:.6f} up={float(ms['ledger'].uplink_wire[0]):,.0f} "
              f"B/round, ledger == static terms ({secs:.2f}s)", flush=True)


def print_profile(prof, wall_s, what, top=10):
    """The device's busy share of the profiled run's wall time (the sum of
    its kernel and copy events), then device time by the operator that
    launched it (``torch.profiler``; the ctypes-launched kernels of this
    port appear under their own kernel names)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in on_device) / 1e3
    print(f"{what} profile: device busy {busy_ms:.1f} ms of "
          f"{wall_s * 1e3:.1f} ms wall ({100 * busy_ms / (wall_s * 1e3):.1f}%)"
          f"; device time by launching operator:")
    ops = sorted((e for e in events if e.device_type !=
                  torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                 key=dev_us, reverse=True)
    for e in ops[:top]:
        print(f"  {dev_us(e) / 1e3:9.2f} ms  {e.count:6d} calls  "
              f"{e.key[:90]}")
    ours = [e for e in on_device
            if any(f"{k}(" in e.key or f"{k}<" in e.key for k in OUR_KERNELS)]
    for e in ours:
        print(f"  {dev_us(e) / 1e3:9.2f} ms  {e.count:6d} launches  "
              f"{e.key[:90]} (port kernel)")


def kernel_rows(kern, launches, paths):
    """The ``kernels`` JSON rows: phase 3's measurements, the main paths'
    launch counts (the off-path kernels count their phase-3 calls;
    ``paths``, the count sketch's by path)."""
    rows = []
    for name, (source, replaces) in KERNELS.items():
        k = kern[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": k["calls"] if name in OFF_PATH else launches[name],
               "max_abs_err": k["max_abs_err"], "ms": k["ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "library_ms": None, "n": k["n"]}
        for extra in ("psum_rel_err", "sketch_err_over_mass",
                      "relaunch_bit_identical", "bytes_bound_ms", "paths"):
            if extra in k:
                row[extra] = k[extra]
        if name == "count_sketch":
            row["launches_by_path"] = {p.split("/")[1]: paths[p]
                                       for p in SKETCH_PATHS}
        if name in OFF_PATH:
            row["launches_from"] = "phase 3 (no path runs this kernel)"
        rows.append(row)
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "kernels", "csrc")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run this script "
              f"from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False

    print(card_line(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    secs = build.build()
    print(f"kernel build: {secs:.2f}s for {len(build.SOURCES)} sources "
          f"({', '.join(build.SOURCES)}), nvcc in parallel", flush=True)
    for name in build.SOURCES:
        for line in build.LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    kern = check_kernels(dev)
    stc_first_rounds(dev)
    sketch_first_rounds(dev)

    # the main paths' launch counts: every counter at 0 just before each
    # path's phase, read just after (the comparisons above do not count)
    launches = {name: 0 for name in KERNELS}
    paths = {name: 0 for name in SKETCH_PATHS}
    for phase in (paper_lm_phase, stc_phase, sketch_phase,
                  plain_stages_phase,
                  lambda d: llama_phase(d, dict(uplink_compressor=CHAINS[1]),
                                        ("threshold_sparsify", "qsgd_pack"),
                                        CHAINS[1]),
                  lambda d: llama_phase(d, LLAMA_STC,
                                        ("ternarize_pack", "qsgd_quantize"),
                                        "EF stc:0.1@fused + lfl8"),
                  lambda d: llama_phase(d, LLAMA_SKETCH,
                                        ("count_sketch", "qsgd_quantize"),
                                        "EF sketch>>qsgd:8")):
        build.LAUNCHES.clear()
        phase(dev)
        for name, count in launch_counts().items():
            launches[name] += count
        for name in SKETCH_PATHS:
            paths[name] += build.LAUNCHES[name]
    for name in KERNELS:
        if name not in OFF_PATH and launches[name] <= 0:
            fail(f"kernel {name} was never launched on a main path")
    for name in SKETCH_PATHS:
        if paths[name] <= 0:
            fail(f"{name} was never launched on a main path")
    print(f"main-path launches {launches}; count_sketch by path {paths}",
          flush=True)

    print(json.dumps({"kernels": kernel_rows(kern, launches, paths)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
