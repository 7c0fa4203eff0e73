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
     The last round of each kernel run of phases 4-5c goes under
     ``torch.profiler``, which prints the device's busy share and device
     time by launching operator (the plain runs do not: nothing reads
     their profiles; a whole run's trace took longer to summarise than
     the run);
  6. slice 5's path, the population round: paper_lm over a streaming
     ``ClientPopulation`` of 100,000 and of 1,000,000 clients (stride
     cohorts of 16, a 64-slot residual store, EF ``topk:0.05>>qsgd:8``,
     seq 48, batch 4, E=2, 4 rounds) on both backends: the store's bytes
     equal at both sizes, every round's batch ids unique and the ones the
     engine committed, and the backends bit-identical in params, slab,
     client and stamp;
  6b. the eviction leg: paper_lm, 192 clients, cohorts of 24, a 32-slot
     store under ``drop`` and under ``sketch`` (a 5 x 16384 tail), 6
     rounds on both backends: the store's ``stats()`` equal to the hits,
     misses and evictions its slots show, the tail non-zero once round 1
     has evicted and its norm never rising across a gather, the backends
     bit-identical under ``drop`` and their losses within 1e-3 (4c's
     tolerance) under ``sketch``;
  6c. llama3_2_1b at full width and depth over 1,000,000 clients, cohorts
     of 2, a 2-slot store under ``sketch``, EF ``topk:0.05>>qsgd:4@fused``,
     3 rounds through the kernels: finite losses, every round after the
     first evicting 2 rows and recovering 2, and the peak memory under
     76 GiB.  Phases 6-6c print each run's round times; one kernel run
     a phase (6: 1,000,000 clients, 6b: ``sketch``, 6c) profiles its last
     round for the device busy share, top device ops and the store's
     share of device time;
  7. slice 6's path, the survey's client and server algorithms: paper_lm,
     8 clients, seq 32, batch 2, E=2, 4 rounds with the held-out eval
     every 2 rounds (``run_rounds(..., metrics_fn=, eval_every=2)``), on
     both backends: FedAvgM, FedAdam and FedYogi (server lr 0.05 for the
     adaptive two), SCAFFOLD and FedDANE (mu 0.01, E=3, lr 0.1) on EF
     ``topk:0.05>>qsgd:8``, and CMFL 0.52 with FedAdam on the dense
     ``qsgd:8``.  Backends bit-identical in params, every state field
     (moments, controls, ``prev_delta``, EF residuals), losses, eval
     losses, ``selected`` and ledger; SCAFFOLD's and FedDANE's uplink
     exactly twice FedAvgM's; CMFL selects all 8 at round 0; the eval
     loss NaN on rounds 0 and 2, finite on 1 and 3;
  7b. llama3_2_1b at full width and depth, 2 clients, seq 128, batch 1,
     E=1, 3 rounds of FedAdam with CMFL 0.52 on ``qsgd:8`` through the
     kernels;
  7c. the same, 2 rounds of SCAFFOLD (E=2) on ``qsgd:4@fused``.  Phases
     7b and 7c need finite losses and parameters, the ledger equal to its
     static terms times the selected count, and a peak memory under 76
     GiB, printed beside the card's name and power limit.  Phases 7-7c
     print each run's round times, losses, eval losses and ``selected``;
     one kernel run a phase (7: FedAdam) profiles its last round;
  8. slice 7's selection (the reference's ``bench_selection``): paper_lm,
     16 clients, 4 per round, E=2, lr 0.2, seq 32, batch 2, 3 rounds of
     ``random``, ``power_of_choice`` and ``multi_criteria`` on EF
     ``topk:0.05>>qsgd:8``, with the held-out eval on the last round, both
     backends: bit-identical, ``selected`` 4 every round, every ledger
     term 4 times one client's; the first policy's kernel run profiles its
     last round;
  9. slice 7's async engine on paper_lm (``bench_async``'s knobs: 8
     slots, seq 48, batch 4, heterogeneity 2.0, E=2, lr 0.2, alpha 0.5, EF
     ``topk:0.05>>qsgd:8``), both backends: the degenerate run (constant
     latency, K = 8, 2 generations) bit-identical to the sync run of the
     same config; FedBuff K = 4 under ``heavy_tail`` with FedAdam, FedAsync
     K = 1 under ``uniform`` and K = 8 with a deadline of the median
     ``resource`` latency, 32 events each; then ``bench_scale``'s async leg
     (100,000 clients, stride cohorts of 16, a 64-slot store, K = 4,
     ``heavy_tail``, 32 events).  Each run prints its event order, flush
     count and final clock; the backends are bit-identical in every state
     tensor and metric;
  9b. llama3_2_1b at full width and depth, async: 2 slots, FedAsync (K =
     1) under ``heavy_tail``, EF ``topk:0.05>>qsgd:4@fused``, seq 128,
     batch 1, E=1, 6 events through the kernels: finite losses, a flush
     every event, the peak memory under 76 GiB with the hop that last
     raised it, each event's time and the last event's busy share;
  10. slice 8's privacy wire on paper_lm (8 clients, seq 32, batch 2,
     E=2, 3 rounds): each of the reference's ``PRIVACY_CASES`` (``qsgd:4``,
     ``topk:0.05>>qsgd:4``, ``ternary@fused``, EF ``topk:0.05>>qsgd:8``,
     ``qsgd:2@fused``, each ``>>secagg``) equal to its clear run bit for
     bit on the kernel backend (params, EF rows with the mask context
     dropped, ledger but the entropy bill, loss) and to the plain backend
     (the ternary case, whose mu sums in another order: ledger exact, loss
     within rtol 1e-5, params within 1e-3 of their scale); one leaf
     encoded by the 8
     clients, whose masked code planes sum to the clear sum and, without
     client 4, to it minus ``dropout_correction``; then
     ``topk:0.05>>qsgd:4>>dpnoise:0.8>>secagg``, whose ledger bills
     dp_rho = 8 x 0.5/0.8^2 in f32 a round;
  10b. llama3_2_1b at full width and depth, 2 clients, seq 128, batch 1,
     E=1, 2 rounds of EF ``topk:0.05>>qsgd:4@fused`` with ``dp_sigma``
     0.8, ``dp_clip`` 1.0 and ``scenario_dropout`` 0.5 through the
     kernels, with ``secure_agg`` on and off: bit-identical, the ledger
     billing both clients every round (the pre-dropout count), the peak
     memory under 76 GiB beside the card's name and power limit;
  11. slice 8's client dynamics on paper_lm, both backends bit-identical
     in every run: the reference's ``SCENARIO_CASES`` (duty-1 square and
     diurnal traces, epoch-scale floor 1) equal to their scenario-free
     runs bit for bit (2 rounds); square and diurnal traces at duty 0.5
     over 16 clients, ``selected`` the trace's count every round;
     ``scenario_dropout`` 0.3 under ``qsgd:4>>secagg`` equal to the clear
     run, billed before the dropout; ``scenario_epoch_scale`` 0.5 at E=4
     with each client's step budget printed; the population's square trace
     over 100,000 clients (cohorts of 16, 64 slots); the async engine (8
     slots, K = 8, ``heavy_tail``, 24 events) with the deadline tracking
     the 0.5 completion quantile and dropout 0.2, printing its flush
     times and ``q_est``;
  12. slice 9's flight recorder on paper_lm, each configuration run with
     ``FLConfig.telemetry`` on and off on both backends: the dense sim (8
     clients, 3 rounds, EF ``topk:0.05>>qsgd:4@fused``, a square trace at
     duty 0.5, dropout 0.3, epoch scale 0.5 at E=4), 6b's population
     under ``drop`` and ``sketch`` (3 rounds), phase 9's FedBuff K = 4
     ``heavy_tail`` run and its population leg over 100,000 clients (32
     events each) and ``qsgd:4>>secagg``.  On against off, every tensor
     but the telemetry is bit-identical; the stage slots, summed one
     after another in f32, equal the ledger's wire totals every round;
     the store counters equal the hits, misses, evictions and recoveries
     the slots show; the backends' ``RoundStats`` are bit-identical.
     Then ``repro_torch.launch.train.main`` with ``--trace``,
     ``--profile-dir`` and ``--checkpoint`` on the sim, population and
     async paths: each trace validates, the report renders the sections
     the path feeds, the profile directory holds a trace and the
     checkpoint restores bit-equal; the sim run's wall time traced and
     untraced is printed, for information;
  12b. llama3_2_1b at full width and depth, 2 clients, 2 rounds of EF
     ``topk:0.05>>qsgd:4@fused`` through the kernels with telemetry on and
     off: bit-identical (the first run's tensors kept on the host), the
     slots summing to the ledger, the peak memory under 76 GiB, and the
     bf16 checkpoint (2.47 GB) saved, restored bit-equal and deleted, its
     seconds printed beside the card's name and power limit;
  13. slice 10's model families: the ``SMOKE`` config of each text-only
     arch (``qwen2_5_32b`` with its qkv bias, ``deepseek_67b``, the MoE
     archs ``qwen3_moe_30b_a3b``, ``moonshot_v1_16b_a3b`` and
     ``llama4_scout_17b_a16e``, ``mamba2_370m`` and the Jamba hybrid) on
     the sim round, 4 clients, seq 32, batch 2, E=1, 2 rounds of EF
     ``topk:0.05>>qsgd:8`` on both backends: params, EF residuals, ledger
     and losses bit-identical, the ledger equal to its static terms, the
     losses finite.  ``whisper_base`` and ``internvl2_76b`` (whose inputs
     the FL data does not have, in the reference too) run ``Model.loss``
     and its gradients on a seeded ``frontend`` / ``patches`` batch,
     held against the port's CPU run of the same params and batch (f32:
     loss within rtol 1e-5, gradients within rtol 1e-4 / atol 1e-6); then
     ``whisper_base`` at full size (bf16): one loss and gradient at 1,500
     frames, seq 128, batch 2, its peak memory printed;
  13b. ``mamba2_370m`` at full width and depth (419,825,152 params), 2
     clients, seq 256, batch 1, E=1, 2 rounds of EF
     ``topk:0.05>>qsgd:4@fused`` through the kernels;
  13c. ``qwen3_moe_30b_a3b`` at full width cut to 1 layer (1,236,015,104
     params), 2 clients, seq 128 (10 slots an expert), batch 1, E=1, 2
     rounds of the same chain through the kernels, and the share of
     routed tokens dropped past an expert's capacity.  Phases 13b and 13c
     need finite losses and parameters, the ledger equal to its static
     terms and a peak memory under 76 GiB, and print the peak, the round
     times, the last round's busy share under ``torch.profiler`` and the
     launches of #1 and #3 beside the card's name and power limit;
  14. the ``kernels`` JSON line: launch counts are those of the main-path
     phases (4, 4b, 4c, 4d, 5, 5b, 5c, 6, 6b, 6c, 7, 7b, 7c, 8, 9, 9b, 10,
     10b, 11, 12, 12b, 13, 13b, 13c), each counted from 0 just before its
     phase (the count sketch's by path too, each of which must launch);
     the pack and unpack kernels are on no path and count their phase-3
     calls;
  15. last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""
import contextlib
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
# slice 5's path: the sync leg of the reference's bench_scale
# (benchmarks/run.py:445): population sizes, cohort, store slots, rounds
POP_SIZES, POP_COHORT, POP_CAPACITY, POP_ROUNDS = (100_000, 1_000_000), 16, \
    64, 4
POP_SEQ, POP_BATCH, POP_SPEC = 48, 4, "topk:0.05>>qsgd:8"
# the eviction leg: (clients, cohort, capacity, rounds)
EVICT_POP = (192, 24, 32, 6)
LLAMA_POP = dict(n_clients=1_000_000, cohort=2, capacity=2,
                 eviction="sketch", spec="topk:0.05>>qsgd:4@fused", rounds=3)
LLAMA_PEAK_GIB = 76.0
# slice 6's path: the survey's client and server algorithms on paper_lm,
# E=2, lr 0.2 unless a run says otherwise; the adaptive server steps at
# the reference's own server lr for them (launch/dryrun.py:52,
# tests/test_async.py:107); (label, FLConfig knobs, kernels the kernel
# backend runs)
ALGO_CLIENTS, ALGO_SEQ, ALGO_BATCH, ALGO_ROUNDS, ALGO_EVAL_EVERY = \
    8, 32, 2, 4, 2
ALGO_CHAIN = "topk:0.05>>qsgd:8"
ALGO_RUNS = (
    ("fedavgm", dict(server_opt="fedavgm", uplink_compressor=ALGO_CHAIN),
     ("threshold_sparsify", "qsgd_quantize")),
    ("fedadam", dict(server_opt="fedadam", server_lr=0.05,
                     uplink_compressor=ALGO_CHAIN),
     ("threshold_sparsify", "qsgd_quantize")),
    ("fedyogi", dict(server_opt="fedyogi", server_lr=0.05,
                     uplink_compressor=ALGO_CHAIN),
     ("threshold_sparsify", "qsgd_quantize")),
    ("scaffold", dict(algorithm="scaffold", uplink_compressor=ALGO_CHAIN),
     ("threshold_sparsify", "qsgd_quantize")),
    ("feddane", dict(algorithm="feddane", fedprox_mu=0.01, local_steps=3,
                     local_lr=0.1, uplink_compressor=ALGO_CHAIN),
     ("threshold_sparsify", "qsgd_quantize")),
    # the dense wire: after top-k, prev_delta is 95% zeros and every
    # client falls below 0.52 from round 1 on
    ("cmfl", dict(cmfl_threshold=0.52, server_opt="fedadam", server_lr=0.05,
                  uplink_compressor="qsgd:8"),
     ("qsgd_quantize",)),
)
ALGO_PROFILED = "fedadam"        # phase 7's kernel run that is profiled
# (label, FLConfig knobs, local steps, rounds, eval cadence, kernels)
LLAMA_ALGO_RUNS = (
    ("7b", "FedAdam + CMFL 0.52, qsgd:8",
     dict(server_opt="fedadam", server_lr=0.05, cmfl_threshold=0.52,
          uplink_compressor="qsgd:8"), 1, 3, 3, ("qsgd_quantize",)),
    ("7c", "SCAFFOLD E=2, qsgd:4@fused",
     dict(algorithm="scaffold", uplink_compressor="qsgd:4@fused"), 2, 2, 2,
     ("qsgd_pack",)),
)
# slice 7's path: bench_selection (benchmarks/run.py:621), bench_async's
# knobs (:349-392) and bench_scale's async leg (:493-512)
SEL_CLIENTS, SEL_PER_ROUND, SEL_SEQ, SEL_BATCH, SEL_ROUNDS = 16, 4, 32, 2, 3
SEL_POLICIES = ("random", "power_of_choice", "multi_criteria")
SEL_SPEC = "topk:0.05>>qsgd:8"
ASYNC_SLOTS, ASYNC_SEQ, ASYNC_BATCH, ASYNC_EVENTS = 8, 48, 4, 32
ASYNC_FL = dict(uplink_compressor="topk:0.05>>qsgd:8", staleness_alpha=0.5)
# (label, Topology.async_ knobs, FLConfig knobs); "median" is the median
# fault-free (resource) latency of the clients, bench_async's deadline
ASYNC_RUNS = (
    ("FedBuff K=4 heavy_tail FedAdam",
     dict(buffer_size=4, latency_profile="heavy_tail"),
     dict(server_opt="fedadam", server_lr=0.05)),
    ("FedAsync K=1 uniform", dict(buffer_size=1, latency_profile="uniform"),
     {}),
    ("FedBuff K=8 deadline", dict(buffer_size=8, latency_profile="heavy_tail",
                                  flush_deadline="median"), {}),
)
ASYNC_POP = dict(n_clients=100_000, cohort=16, capacity=64, sampler="stride")
ASYNC_POP_K = 4
LLAMA_ASYNC = dict(slots=2, buffer_size=1, latency_profile="heavy_tail",
                   spec="topk:0.05>>qsgd:4@fused", events=6)
# slice 8's privacy wire: the reference's PRIVACY_CASES
# (tests/parity_cases.py:117), each masked spec beside its clear base;
# (label, masked spec, clear spec, EF, the backends' loss rtol (None:
# bit-identical; the ternary row's mu is a sum in another order), kernels)
PRIV_RUNS = (
    ("secagg_qsgd4", "qsgd:4>>secagg", "qsgd:4", False, None,
     ("qsgd_quantize",)),
    ("secagg_topk_qsgd", "topk:0.05>>qsgd:4>>secagg", "topk:0.05>>qsgd:4",
     False, None, ("threshold_sparsify", "qsgd_quantize")),
    ("secagg_ternary_fused", "ternary@fused>>secagg", "ternary@fused", False,
     1e-5, ("ternarize_pack",)),
    ("secagg_ef_chain", "topk:0.05>>qsgd:8>>secagg", "topk:0.05>>qsgd:8",
     True, None, ("threshold_sparsify", "qsgd_quantize")),
    ("secagg_qsgd2_fused", "qsgd:2@fused>>secagg", "qsgd:2@fused", False,
     None, ("qsgd_pack",)),
)
PRIV_PARAM_RTOL = 1e-3          # the ternary row's params across backends
PRIV_DP = "topk:0.05>>qsgd:4>>dpnoise:0.8>>secagg"
LLAMA_PRIV = dict(uplink_compressor="topk:0.05>>qsgd:4@fused", dp_sigma=0.8,
                  dp_clip=1.0, scenario_dropout=0.5)
# slice 8's client dynamics: the reference's SCENARIO_CASES
# (tests/parity_cases.py:167), enabled but drawing identity masks; (label,
# spec, FLConfig knobs, kernels of the kernel backend, of the plain one)
SCN_CASES = (
    ("square_duty1_ef", "topk:0.25>>qsgd:8", dict(scenario_trace="square"),
     ("threshold_sparsify", "qsgd_quantize"), ()),
    ("diurnal_rate1_kernel", "topk:0.25@kernel>>qsgd:8",
     dict(scenario_trace="diurnal"), ("threshold_sparsify", "qsgd_quantize"),
     ("threshold_sparsify",)),
    ("escale_floor1_fused", "qsgd:4@fused", dict(scenario_epoch_scale=1.0),
     ("qsgd_pack",), ()),
    ("square_duty1_secagg", "qsgd:4>>secagg", dict(scenario_trace="square"),
     ("qsgd_quantize",), ()),
    ("diurnal_escale_combo", "topk:0.25>>qsgd:8",
     dict(scenario_trace="diurnal", scenario_epoch_scale=1.0),
     ("threshold_sparsify", "qsgd_quantize"), ()),
)
SCN_ROUNDS, SCN_TRACE_CLIENTS = 2, 16
SCN_POP = dict(n_clients=100_000, cohort=16, capacity=64, sampler="stride",
               availability=0.5)
SCN_ASYNC_TOPO = dict(buffer_size=8, latency_profile="heavy_tail")
SCN_ASYNC_EVENTS = 24
# slice 9's flight recorder: phase 6b's population at fewer rounds (round 1
# already evicts)
TELE_POP_ROUNDS = 3
# slice 10's model families: the text-only archs' SMOKE configs on the sim
# round, and the two whose inputs the FL data lacks
FAMILY_ARCHS = ("qwen2_5_32b", "deepseek_67b", "qwen3_moe_30b_a3b",
                "moonshot_v1_16b_a3b", "llama4_scout_17b_a16e",
                "mamba2_370m", "jamba_1_5_large_398b")
FAMILY_CLIENTS, FAMILY_SEQ, FAMILY_BATCH, FAMILY_ROUNDS = 4, 32, 2, 2
FAMILY_SPEC = "topk:0.05>>qsgd:8"
FRONTEND_ARCHS = ("whisper_base", "internvl2_76b")
FRONTEND_LOSS_RTOL, FRONTEND_GRAD_RTOL, FRONTEND_GRAD_ATOL = 1e-5, 1e-4, 1e-6
WHISPER_SEQ, WHISPER_BATCH = 128, 2
FULL_SPEC = "topk:0.05>>qsgd:4@fused"
# (phase, arch, layers kept (None: all), clients, seq, batch, rounds)
FULL_RUNS = (("13b", "mamba2_370m", None, 2, 256, 1, 2),
             ("13c", "qwen3_moe_30b_a3b", 1, 2, 128, 1, 2))
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
# the code widths phase 3 checks each kernel at, the reported one first
# (QSGD quantizes at 8 bits, and at 4 under @fused where a carrier's block
# is odd)
BITS = {"qsgd_quantize": (8, 4), "pack_codes": (2, 4),
        "unpack_codes": (2, 4)}


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
    # phases 13b and 13c: every leaf of the full-width runs and its carrier
    full = sorted({n for r in FULL_RUNS
                   for n in full_run_model(r[0])[0].param_sizes()})
    full_carriers = sorted({_k(n, 0.05) for n in full})
    big = sorted({LLAMA_W_UP} | set(full))
    big_carriers = sorted({_k(LLAMA_W_UP, 0.05)} | set(full_carriers))
    sizes = {"threshold_sparsify": sorted(set(leaves + [3001] + big)),
             "qsgd_quantize": sorted(set(carriers + big_carriers)),
             "qsgd_pack": [k for k in sorted(set(carriers + big_carriers))
                           if min(2048, k) % 2 == 0],
             # "u" marks an unaligned view (x[1:], the scalar load path)
             "ternarize": tern_sizes + ["u5001", LLAMA_W_UP],
             "ternarize_pack": tern_sizes + ["u5001", LLAMA_W_UP],
             # (rows, block): short rows with a byte-wise tail, then full ones
             "pack_codes": [(3, 20)] + [(-(-n // 2048), 2048)
                                        for n in leaves + [LLAMA_W_UP]],
             "unpack_codes": [(3, 20)] + [(-(-n // 2048), 2048)
                                          for n in leaves + [LLAMA_W_UP]]}
    print(f"paper_lm leaf sizes {leaves}; top-k carriers {carriers}; "
          f"ternary carriers {tern_carriers}; 13b and 13c leaf sizes {full}, "
          f"top-k carriers {full_carriers}")
    build.LAUNCHES.clear()
    results = {}
    for name, ns in sizes.items():
        worst, worst_rel = 0.0, 0.0
        variants = BITS.get(name, (None,))
        for n in ns:
            for variant in variants:
                row = check_one(name, n, variant, g, dev)
                worst = max(worst, row["max_abs_err"])
                worst_rel = max(worst_rel, row.get("psum_rel_err", 0.0))
                if variant == variants[0]:
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
            kern = lambda: qsgd.qsgd_quantize_cuda(x, u, bits, blk)
            plain = lambda: qsgd.qsgd_quantize_plain(x, u, bits, blk)
            label = f"{label} bits={bits}"
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


def watch_peak(program, log=None):
    """Wraps the round program's hops to note in ``log`` the hop in which
    the device's peak allocated memory (a running maximum, never reset
    here) last rose, and the peak it reached there (GiB)."""
    log = {} if log is None else log

    def wrap(name, fn):
        def hop(ctx):
            before = torch.cuda.max_memory_allocated()
            out = fn(ctx)
            after = torch.cuda.max_memory_allocated()
            if after > before:
                log.update(hop=name, gib=after / 2**30)
            return out
        return hop
    program.hops = tuple((n, wrap(n, f)) for n, f in program.hops)
    return log


# the kernel runs go under the profiler; the plain runs, whose profiles
# nothing reads, do not (parsing a trace takes longer than the run)
PROFILED = {"kernel": ", the last round under the profiler", "jax": ""}


def profiled_if(on):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def cat_metrics(a, b):
    """Two ``run_rounds`` metrics back to back (``a`` may be None)."""
    from repro_torch.core.types import CommLedger
    if a is None:
        return b
    out = {k: torch.cat([a[k], b[k]]) for k in a if k != "ledger"}
    la, lb = a["ledger"].fields(), b["ledger"].fields()
    out["ledger"] = CommLedger(**{f: torch.cat([la[f], lb[f]]) for f in la})
    return out


def run_sim(model, fl_kw, backend, clients, seq, batch, rounds, dev,
            local_steps, local_lr, peak_log=None, prof_out=None, times=None):
    """``rounds`` sim rounds; with a ``prof_out`` dict the last round runs
    under ``torch.profiler`` (a whole run's trace takes longer to
    summarise than the run) and ``prof_out`` gets the profiler and the
    round's wall time; a ``times`` list gets every round's wall time, each
    round synchronised with the card."""
    from repro_torch.core.engine import run_rounds
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import sample_round

    fl = FLConfig(backend=backend, local_steps=local_steps,
                  local_lr=local_lr, **fl_kw)
    sim = make_sim_step(model, fl, clients, chunk=seq, device=dev)
    if peak_log is not None:
        watch_peak(sim.engine.round_fn, peak_log)
    data = fed_data(model, clients, seq, batch)
    data_fn = lambda r: sample_round(data, r, dev)
    state = sim.init_fn(0)
    n = rounds - (prof_out is not None)
    if times is None:
        state, head = run_rounds(sim.engine, state, data_fn, n)
    else:
        head = None
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = run_rounds(sim.engine, state, data_fn, 1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            head = cat_metrics(head, m)
    torch.cuda.synchronize()
    if prof_out is None:
        return sim, state, head
    prof = profiled_if(True)
    prof.start()
    t0 = time.perf_counter()
    state, tail = run_rounds(sim.engine, state, data_fn, 1)
    torch.cuda.synchronize()
    prof_out.update(secs=time.perf_counter() - t0)
    prof.stop()
    prof_out["prof"] = prof
    if times is not None:
        times.append(prof_out["secs"])
    return sim, state, cat_metrics(head, tail)


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
            prof = {} if backend == "kernel" else None
            sim, state, ms = run_sim(model, dict(uplink_compressor=spec),
                                     backend, PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                                     PAPER_LM_BATCH, PAPER_LM_ROUNDS, dev, 2,
                                     0.2, prof_out=prof)
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
                  f"launches {ran} ({secs:.2f}s{PROFILED[backend]})",
                  flush=True)
            if backend == "kernel":
                print_profile(prof["prof"], prof["secs"],
                              f"paper_lm {spec}, last round", top=6)
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
    """llama3_2_1b at full width and depth through the kernels."""
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
    wide_phase(dev, model, fl_kw, expect, f"llama3_2_1b {what}",
               LLAMA_CLIENTS, LLAMA_SEQ, LLAMA_BATCH, LLAMA_ROUNDS)


def wide_phase(dev, model, fl_kw, expect, what, clients, seq, batch, rounds,
               inspect=None):
    """A full-width model's sim rounds through the kernels, E=1 at lr 0.05,
    the last round under ``torch.profiler``: finite losses and params, the
    ledger equal to its static terms, the kernels of ``expect`` launched
    and no other, the peak memory under LLAMA_PEAK_GIB.  Prints the round
    times, the peak and the last round's busy share; ``inspect(params)``
    (optional) then reads the final params."""
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    peak_log, prof, times = {}, {}, []
    sim, state, ms = run_sim(model, fl_kw, "kernel", clients, seq, batch,
                             rounds, dev, 1, 0.05, peak_log=peak_log,
                             prof_out=prof, times=times)
    secs = time.perf_counter() - t0
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    check_launches(ran, expect, what)
    losses = check_finite(ms, state, what)
    check_ledger(sim, ms, clients, what)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if peak >= LLAMA_PEAK_GIB:
        fail(f"{what}: peak memory {peak:.1f} GiB, not under "
             f"{LLAMA_PEAK_GIB} GiB")
    print(f"{what}: loss per round {fmt(losses)}, round times "
          f"{', '.join(f'{t:.3f}' for t in times)} s (the last under the "
          f"profiler), up={float(ms['ledger'].uplink_wire[0]):,.0f} B/round "
          f"down={float(ms['ledger'].downlink_wire[0]):,.0f} B/round, "
          f"ledger == static terms, launches {ran}, peak memory {peak:.2f} "
          f"GiB (limit {LLAMA_PEAK_GIB:.0f}; last raised in the "
          f"{peak_log.get('hop', 'init')} hop) on {card_line()}, "
          f"{secs:.2f}s", flush=True)
    print_profile(prof["prof"], prof["secs"], f"{what}, last round")
    if inspect is not None:
        inspect(state.params)
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
            prof = {} if backend == "kernel" else None
            sim, state, ms = run_sim(model, fl_kw, backend,
                                     PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                                     PAPER_LM_BATCH, PAPER_LM_ROUNDS, dev, 2,
                                     0.2, prof_out=prof)
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
                  f"launches {ran} ({secs:.2f}s{PROFILED[backend]})",
                  flush=True)
            if backend == "kernel":
                print_profile(prof["prof"], prof["secs"],
                              f"paper_lm {label}, last round", top=6)
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
            prof = {} if backend == "kernel" else None
            sim, state, ms = run_sim(model, fl_kw, backend,
                                     PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                                     PAPER_LM_BATCH, PAPER_LM_ROUNDS, dev, 2,
                                     SKETCH_LR, prof_out=prof)
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
                  f"launches {ran} ({secs:.2f}s{PROFILED[backend]})",
                  flush=True)
            if backend == "kernel":
                print_profile(prof["prof"], prof["secs"],
                              f"paper_lm {label}, last round", top=6)
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


# ---------------------------------------------------------------------------
# phases 6-6c: the population round
# ---------------------------------------------------------------------------

STORE_RANGES = ("store.gather", "store.scatter")


def annotate_store(store):
    """Wraps the store's gather and scatter in profiler ranges, so that the
    profile reads their device time (the count-sketch tail's, under
    ``sketch``)."""
    for name in ("gather", "scatter"):
        def wrapped(*args, _fn=getattr(store, name), _range=f"store.{name}"):
            with torch.profiler.record_function(_range):
                return _fn(*args)
        setattr(store, name, wrapped)


def tail_norms(state):
    from repro_torch.compress.residual_store import _leaves
    return [float(t.norm()) for t in _leaves(state.get("tail", ()))
            if t.numel()]


def run_population(model, fl_kw, backend, pop, seq, batch, rounds, dev,
                   local_steps, local_lr, check_gathers=False,
                   profiled=False):
    """``rounds`` rounds of ``make_round_engine(..., population=pop)`` on
    ``cohort_data_fn``'s batches.  Records per round the batch's ids, the
    store's ``stats()`` and resident clients before the round, the
    resident clients and tail norms after it, its wall time (host clock,
    synchronised), and (``check_gathers``) the tail norms before and after
    a gather of the round's ids.  With ``profiled`` the last round runs
    under ``torch.profiler`` (a steady window: a whole run's trace takes
    minutes to summarise).  Returns (engine, state, metrics with the
    ledger stacked, records, the profiler or None)."""
    from repro_torch.core.engine import Topology, make_round_engine
    from repro_torch.core.types import CommLedger, FLConfig
    from repro_torch.data.pipeline import cohort_data_fn
    from repro_torch.data.synthetic import FedDataConfig

    fl = FLConfig(backend=backend, local_steps=local_steps,
                  local_lr=local_lr, **fl_kw)
    engine = make_round_engine(model, fl, Topology.sim(pop.n_clients),
                               chunk=seq, device=dev, population=pop)
    engine.aux["peak_log"] = watch_peak(engine.round_fn)
    store = engine.aux["store"]
    if profiled:
        annotate_store(store)
    data_fn = cohort_data_fn(pop, FedDataConfig(
        vocab_size=model.cfg.vocab_size, num_clients=pop.n_clients,
        seq_len=seq, batch_per_client=batch, heterogeneity=2.0), dev)
    state = engine.init_fn(0)
    records, metrics, prof = [], [], None
    for r in range(rounds):
        b = data_fn(r)
        comm = state.comm_state
        rec = {"ids": b["ids"].tolist(),
               "client_before": comm["client"].tolist(),
               "stats": {k: float(v) for k, v in
                         store.stats(comm, b["ids"]).items()}}
        if check_gathers:
            _, gathered = store.gather(comm, b["ids"])
            rec["gather_norms"] = (tail_norms(comm), tail_norms(gathered))
        torch.cuda.synchronize()
        if profiled and r == rounds - 1:
            prof = profiled_if(True)
            prof.start()
        t0 = time.perf_counter()
        state, m = engine.round_fn(state, b)
        torch.cuda.synchronize()
        rec["secs"] = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        rec["client_after"] = state.comm_state["client"].tolist()
        rec["tail_norms"] = tail_norms(state.comm_state)
        records.append(rec)
        metrics.append(m)
    ms = {k: torch.stack([m[k] for m in metrics])
          for k in metrics[0] if k != "ledger"}
    ms["ledger"] = CommLedger(**{
        f: torch.stack([m["ledger"].fields()[f] for m in metrics])
        for f in metrics[0]["ledger"].fields()})
    return engine, state, ms, records, prof


def round_times(records):
    return "round times " + ", ".join(f"{rec['secs']:.2f}" for rec in records) \
        + " s"


def check_store_records(records, pop, what):
    """Every round's ids unique and of the cohort's size; ``stats()`` equal
    to what the resident clients before and after the round show: hits
    (ids already resident), misses, evictions (residents that left) and,
    under ``sketch``, every miss recovered."""
    for r, rec in enumerate(records):
        ids, before = rec["ids"], set(rec["client_before"]) - {-1}
        after = set(rec["client_after"]) - {-1}
        if len(set(ids)) != pop.cohort:
            fail(f"{what} round {r}: cohort ids not unique {ids}")
        if not set(ids) <= after:
            fail(f"{what} round {r}: the store did not commit the batch's "
                 f"ids {ids}")
        hits = len(set(ids) & before)
        want = {"hits": hits, "misses": pop.cohort - hits,
                "evictions": len(before - after),
                "sketch_recovered": (pop.cohort - hits
                                     if pop.eviction == "sketch" else 0)}
        if rec["stats"] != {k: float(v) for k, v in want.items()}:
            fail(f"{what} round {r}: stats() {rec['stats']} != the slots' "
                 f"{want}")


def check_finite(ms, state, what):
    losses = [float(v) for v in ms["loss"]]
    if not all(v == v and abs(v) < 1e6 for v in losses):
        fail(f"{what}: loss not finite {losses}")
    for t in _tensors(state.params):
        if not bool(torch.isfinite(t).all()):
            fail(f"{what}: non-finite parameters")
    return losses


def population_phase(dev):
    """Slice 5's path on paper_lm, the sync leg of bench_scale: the same
    store bytes at both population sizes, the batch's ids committed, and
    the backends bit-identical."""
    from repro_torch.compress.residual_store import _leaves, store_nbytes
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.population import ClientPopulation
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    want_bytes = POP_CAPACITY * (4 * model.param_count() + 8) + 4
    nbytes = {}
    for N in POP_SIZES:
        runs = {}
        for backend in ("kernel", "jax"):
            pop = ClientPopulation(n_clients=N, cohort=POP_COHORT,
                                   capacity=POP_CAPACITY, sampler="stride")
            before = launch_counts()
            t0 = time.perf_counter()
            engine, state, ms, recs, prof = run_population(
                model, dict(uplink_compressor=POP_SPEC), backend, pop,
                POP_SEQ, POP_BATCH, POP_ROUNDS, dev, 2, 0.2,
                profiled=backend == "kernel" and N == POP_SIZES[-1])
            secs = time.perf_counter() - t0
            what = f"paper_lm population {N:,} backend={backend}"
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, ("threshold_sparsify", "qsgd_quantize")
                           if backend == "kernel" else (), what)
            losses = check_finite(ms, state, what)
            check_ledger(engine, ms, POP_COHORT, what)
            check_store_records(recs, pop, what)
            client = state.comm_state["client"]
            last = client[state.comm_state["stamp"] == POP_ROUNDS - 1]
            if sorted(last.tolist()) != sorted(recs[-1]["ids"]):
                fail(f"{what}: the last round's committed ids "
                     f"{sorted(last.tolist())} are not its batch's")
            nbytes[N, backend] = store_nbytes(state.comm_state)
            print(f"{what}: population={N:,} cohort={pop.cohort} "
                  f"capacity={pop.capacity} store="
                  f"{nbytes[N, backend] / 1e6:.1f}MB "
                  f"({nbytes[N, backend]:,} B); loss per round "
                  f"{[round(v, 6) for v in losses]}; ids unique and "
                  f"committed, stats == slots; launches {ran}; "
                  f"{round_times(recs)} ({secs:.2f}s in all)", flush=True)
            if prof is not None:
                print_profile(prof, recs[-1]["secs"],
                              f"{what}, last round", top=6)
            runs[backend] = (state, ms)
        (sk, mk), (sp, mp) = runs["kernel"], runs["jax"]
        pairs = (list(zip(_tensors(sk.params), _tensors(sp.params)))
                 + list(zip(_leaves(sk.comm_state), _leaves(sp.comm_state)))
                 + [(mk["loss"], mp["loss"])])
        for a, b in pairs:
            if not torch.equal(a, b):
                fail(f"paper_lm population {N:,}: kernel backend differs "
                     f"from the plain backend")
        print(f"paper_lm population {N:,}: kernel and plain backends "
              f"bit-identical ({len(pairs)} tensors: params, slab, client, "
              f"stamp, clock, loss)", flush=True)
    if set(nbytes.values()) != {want_bytes}:
        fail(f"store bytes {nbytes} differ across population sizes or from "
             f"{want_bytes:,}")
    print(f"paper_lm population: store bytes {want_bytes:,} "
          f"({want_bytes / 1e6:.1f}MB) at {POP_SIZES[0]:,} and "
          f"{POP_SIZES[1]:,} clients, equal", flush=True)


def eviction_phase(dev):
    """The eviction leg on paper_lm (E=1): stats() against the slots, the
    tail non-zero once round 1 has evicted and its norm never rising
    across a gather (checked on the plain run, outside the profile), the
    backends bit-identical under drop and within 4c's 1e-3 under sketch."""
    from repro_torch.compress.residual_store import _leaves
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.population import ClientPopulation
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    N, M, S, R = EVICT_POP
    for eviction in ("drop", "sketch"):
        runs = {}
        for backend in ("kernel", "jax"):
            pop = ClientPopulation(n_clients=N, cohort=M, capacity=S,
                                   eviction=eviction)
            what = f"paper_lm eviction={eviction} backend={backend}"
            before = launch_counts()
            t0 = time.perf_counter()
            engine, state, ms, recs, prof = run_population(
                model, dict(uplink_compressor=POP_SPEC), backend, pop,
                PAPER_LM_SEQ, PAPER_LM_BATCH, R, dev, 1, 0.2,
                check_gathers=backend == "jax" and eviction == "sketch",
                profiled=backend == "kernel" and eviction == "sketch")
            secs = time.perf_counter() - t0
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, ("threshold_sparsify", "qsgd_quantize")
                           if backend == "kernel" else (), what)
            losses = check_finite(ms, state, what)
            check_ledger(engine, ms, M, what)
            check_store_records(recs, pop, what)
            evicted = 0
            for r, rec in enumerate(recs):
                evicted += rec["stats"]["evictions"]
                if eviction == "sketch" and evicted and not all(
                        v > 0 for v in rec["tail_norms"]):
                    fail(f"{what} round {r}: a tail is zero after "
                         f"{evicted:.0f} evictions")
                if "gather_norms" in rec:
                    b4, aft = rec["gather_norms"]
                    if any(a > b * (1 + 1e-6) for a, b in zip(aft, b4)):
                        fail(f"{what} round {r}: a tail's norm rose across "
                             f"the gather ({b4} -> {aft})")
            if evicted < R:
                fail(f"{what}: only {evicted:.0f} evictions in {R} rounds")
            print(f"{what}: {N} clients, cohort {M}, capacity {S}, "
                  f"{evicted:.0f} evictions in {R} rounds, stats == slots"
                  + (f", tail norms after the last round "
                     f"{[round(v, 4) for v in recs[-1]['tail_norms'][:3]]}"
                     f"... non-zero, never rising across a gather"
                     if eviction == "sketch" else "")
                  + f"; loss per round {[round(v, 6) for v in losses]}; "
                  f"launches {ran}; {round_times(recs)} ({secs:.2f}s in "
                  f"all)", flush=True)
            if prof is not None:
                print_profile(prof, recs[-1]["secs"],
                              f"{what}, last round", top=6)
            runs[backend] = (state, ms)
        (sk, mk), (sp, mp) = runs["kernel"], runs["jax"]
        for k in ("client", "stamp", "clock"):
            if not torch.equal(sk.comm_state[k], sp.comm_state[k]):
                fail(f"paper_lm eviction={eviction}: store {k} differs "
                     f"between the backends")
        if eviction == "drop":
            for a, b in (list(zip(_tensors(sk.params), _tensors(sp.params)))
                         + list(zip(_leaves(sk.comm_state),
                                    _leaves(sp.comm_state)))):
                if not torch.equal(a, b):
                    fail("paper_lm eviction=drop: kernel backend differs "
                         "from the plain backend")
        gap = float(((mk["loss"] - mp["loss"]).abs() / mp["loss"].abs())
                    .max())
        if not gap <= 1e-3:
            fail(f"paper_lm eviction={eviction}: losses differ by {gap:.3e} "
                 f"between the backends, above 1e-3")
        print(f"paper_lm eviction={eviction}: client, stamp and clock "
              f"identical on both backends"
              + (", params and slab bit-identical" if eviction == "drop"
                 else "")
              + f"; losses' largest relative gap {gap:.3e}", flush=True)


def llama_population_phase(dev):
    """llama3_2_1b at full width and depth over a million clients with a
    two-slot sketch store: finite losses, 2 evictions and 2 recoveries in
    every round after the first, and the peak memory."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.population import ClientPopulation
    from repro_torch.models.model import Model

    cfg = get_arch("llama3_2_1b")
    model = Model(cfg)
    kw = dict(LLAMA_POP)
    spec, rounds = kw.pop("spec"), kw.pop("rounds")
    pop = ClientPopulation(**kw)
    what = (f"llama3_2_1b population={pop.n_clients:,} cohort={pop.cohort} "
            f"capacity={pop.capacity} eviction={pop.eviction} "
            f"({pop.tail_rows} x {pop.tail_cols} tail) EF {spec}")
    print(f"{what}: {model.param_count():,} params, {cfg.num_layers} layers "
          f"(no depth cut), seq {LLAMA_SEQ}, batch {LLAMA_BATCH}, E=1, "
          f"{rounds} rounds, backend=kernel", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    engine, state, ms, recs, prof = run_population(
        model, dict(uplink_compressor=spec), "kernel", pop, LLAMA_SEQ,
        LLAMA_BATCH, rounds, dev, 1, 0.05, profiled=True)
    secs = time.perf_counter() - t0
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    check_launches(ran, ("threshold_sparsify", "qsgd_pack"), what)
    losses = check_finite(ms, state, what)
    check_ledger(engine, ms, pop.cohort, what)
    check_store_records(recs, pop, what)
    for r, rec in enumerate(recs[1:], 1):
        st = rec["stats"]
        if st["evictions"] != 2 or st["sketch_recovered"] != 2:
            fail(f"{what} round {r}: stats {st}, expected 2 evictions and "
                 f"2 recoveries")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if peak >= LLAMA_PEAK_GIB:
        fail(f"{what}: peak memory {peak:.1f} GiB, not under "
             f"{LLAMA_PEAK_GIB} GiB")
    print(f"{what}: loss per round {[round(v, 6) for v in losses]}, ledger "
          f"== static terms, 2 evictions and 2 recoveries in rounds 1-"
          f"{rounds - 1}, tail norms after the last round "
          f"{[round(v, 4) for v in recs[-1]['tail_norms'][:3]]}..., "
          f"launches {ran}, peak memory {peak:.1f} GiB "
          f"(limit {LLAMA_PEAK_GIB:.0f}; last raised in the "
          f"{engine.aux['peak_log'].get('hop')} hop); {round_times(recs)} "
          f"({secs:.2f}s in all)", flush=True)
    print_profile(prof, recs[-1]["secs"], f"{what}, last round")
    del engine, state, ms
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7-7c: the client and server algorithms
# ---------------------------------------------------------------------------

def run_algorithm(model, fl_kw, backend, clients, seq, batch, rounds,
                  eval_every, dev, local_steps, local_lr, profiled=False):
    """``rounds`` rounds of ``make_sim_step`` through ``run_rounds`` with
    a held-out eval (``eval_batch``) as its ``metrics_fn`` at
    ``eval_every``.  Records each round's wall time (host clock,
    synchronised); with ``profiled`` the last round runs under
    ``torch.profiler``.  Returns (sim, state, metrics, round times, the
    profiler or None, the hop log of the peak memory)."""
    from repro_torch.core.engine import run_rounds
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import eval_batch, sample_round

    kw = dict(dict(local_steps=local_steps, local_lr=local_lr), **fl_kw)
    fl = FLConfig(backend=backend, eval_every=eval_every, **kw)
    sim = make_sim_step(model, fl, clients, chunk=seq, device=dev)
    program = sim.engine.round_fn
    peak_log = watch_peak(program)
    data = fed_data(model, clients, seq, batch)
    ev = eval_batch(data, 99, batch_size=batch, device=dev)
    times, prof = [], None

    def timed_round(state, b):
        nonlocal prof
        torch.cuda.synchronize()
        if profiled and state.round == rounds - 1:
            prof = profiled_if(True)
            prof.start()
        t0 = time.perf_counter()
        out = program(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if prof is not None and state.round == rounds - 1:
            prof.stop()
        return out

    def metrics_fn(state, m):
        with torch.no_grad():
            loss = model.loss(state.params, ev, chunk=seq)[0]
        return dict(m, eval_loss=loss)

    sim.engine.round_fn = timed_round
    state = sim.init_fn(0)
    state, ms = run_rounds(sim.engine, state,
                           lambda r: sample_round(data, r, dev), rounds,
                           metrics_fn=metrics_fn)
    torch.cuda.synchronize()
    return sim, state, ms, times, prof, peak_log


def state_fields(state):
    """Every tensor of an FLState, by field: params, the server moments,
    the controls, prev_delta, the EF residuals."""
    return {f: _tensors(getattr(state, f))
            for f in ("params", "server_opt_state", "control",
                      "client_controls", "prev_delta", "comm_state")}


def same_bits(a, b):
    """Bit-identical, NaN where NaN (the eval loss off its cadence)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, nan=0.0),
                            torch.nan_to_num(b, nan=0.0)))


def check_algorithm_ledger(sim, ms, what):
    """Every round's ledger equals the static terms (SCAFFOLD's and
    FedDANE's uplink doubled in them) times the round's selected count,
    in float32."""
    terms = sim.terms
    want = {"uplink_wire": terms["up_wire"],
            "uplink_entropy": terms["up_entropy"],
            "downlink_wire": terms["down_wire"],
            "uplink_dense": terms["dense"], "downlink_dense": terms["dense"]}
    sel = ms["selected"].cpu()
    for name, term in want.items():
        got = getattr(ms["ledger"], name).cpu()
        exp = sel * torch.tensor(term, dtype=torch.float32)
        if not torch.equal(got, exp):
            fail(f"{what}: ledger {name} {got.tolist()} != selected x "
                 f"{term} = {exp.tolist()}")


def check_eval_cadence(ms, rounds, eval_every, what):
    ev = [float(v) for v in ms["eval_loss"]]
    for r, v in enumerate(ev):
        due = r % eval_every == eval_every - 1
        if due != (v == v) or (due and not abs(v) < 1e6):
            fail(f"{what}: eval loss {ev} off the cadence of every "
                 f"{eval_every} rounds")
    return ev


def fmt(vals):
    return [round(float(v), 6) for v in vals]


def algorithms_phase(dev):
    """Slice 6's path on paper_lm, each run on both backends: bit-identical
    backends, the 2x uplink bill, CMFL's warm-up round and the eval
    cadence."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    print(f"paper_lm algorithms: {ALGO_CLIENTS} clients, seq {ALGO_SEQ}, "
          f"batch {ALGO_BATCH}, {ALGO_ROUNDS} rounds, eval every "
          f"{ALGO_EVAL_EVERY}, E=2 lr=0.2 unless set", flush=True)
    uplink = {}
    for label, fl_kw, kernels in ALGO_RUNS:
        runs = {}
        for backend in ("kernel", "jax"):
            before = launch_counts()
            t0 = time.perf_counter()
            sim, state, ms, times, prof, _ = run_algorithm(
                model, fl_kw, backend, ALGO_CLIENTS, ALGO_SEQ, ALGO_BATCH,
                ALGO_ROUNDS, ALGO_EVAL_EVERY, dev, 2, 0.2,
                profiled=backend == "kernel" and label == ALGO_PROFILED)
            secs = time.perf_counter() - t0
            what = f"paper_lm {label} {fl_kw} backend={backend}"
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, kernels if backend == "kernel" else (), what)
            losses = check_finite(ms, state, what)
            ev = check_eval_cadence(ms, ALGO_ROUNDS, ALGO_EVAL_EVERY, what)
            check_algorithm_ledger(sim, ms, what)
            for field, ts in state_fields(state).items():
                if not all(bool(torch.isfinite(t).all()) for t in ts):
                    fail(f"{what}: non-finite {field}")
            selected = [int(v) for v in ms["selected"]]
            print(f"{what}: loss per round {fmt(losses)}, eval loss "
                  f"{fmt(ev)}, selected {selected}, up "
                  f"{fmt(ms['ledger'].uplink_wire)} B, launches {ran}, "
                  f"round times {', '.join(f'{t:.3f}' for t in times)} s "
                  f"({secs:.2f}s in all)", flush=True)
            if prof is not None:
                print_profile(prof, times[-1], f"{what}, last round", top=6)
            runs[backend] = (state, ms)
        (sk, mk), (sp, mp) = runs["kernel"], runs["jax"]
        fk, fp = state_fields(sk), state_fields(sp)
        pairs = [(a, b) for f in fk for a, b in zip(fk[f], fp[f])]
        if any(len(fk[f]) != len(fp[f]) for f in fk):
            fail(f"paper_lm {label}: the backends' states differ in form")
        pairs += [(getattr(mk["ledger"], f), getattr(mp["ledger"], f))
                  for f in mk["ledger"].fields()]
        pairs += [(mk[k], mp[k]) for k in ("loss", "eval_loss", "selected")]
        for a, b in pairs:
            if not same_bits(a, b):
                fail(f"paper_lm {label}: kernel backend differs from the "
                     f"plain backend (max abs err "
                     f"{float((a.double() - b.double()).abs().nan_to_num().max())})")
        counts = {f: len(ts) for f, ts in fk.items() if ts}
        print(f"paper_lm {label}: kernel and plain backends bit-identical "
              f"({len(pairs)} tensors: {counts}, ledger, losses, eval "
              f"losses, selected)", flush=True)
        uplink[label] = mk["ledger"].uplink_wire.cpu()
        if label == "cmfl" and int(mk["selected"][0]) != ALGO_CLIENTS:
            fail(f"paper_lm cmfl: round 0 selected "
                 f"{int(mk['selected'][0])} of {ALGO_CLIENTS}")
    for label in ("scaffold", "feddane"):
        if not torch.equal(uplink[label], 2 * uplink["fedavgm"]):
            fail(f"paper_lm {label}: uplink {uplink[label].tolist()} is not "
                 f"twice fedavgm's {uplink['fedavgm'].tolist()}")
    print(f"paper_lm algorithms: scaffold's and feddane's uplink exactly "
          f"2x fedavgm's ({float(uplink['fedavgm'][0]):,.0f} B/round)",
          flush=True)


def llama_algorithm_phase(dev, tag):
    """llama3_2_1b at full width and depth through the kernels: finite
    losses and parameters, the ledger equal to its terms times the
    selected count, the eval cadence, and the peak memory under 76 GiB."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    _, label, fl_kw, steps, rounds, eval_every, kernels = next(
        run for run in LLAMA_ALGO_RUNS if run[0] == tag)
    cfg = get_arch("llama3_2_1b")
    model = Model(cfg)
    what = f"llama3_2_1b {label}"
    print(f"{what}: {model.param_count():,} params, {cfg.num_layers} layers "
          f"(no depth cut), {LLAMA_CLIENTS} clients, seq {LLAMA_SEQ}, batch "
          f"{LLAMA_BATCH}, E={steps}, {rounds} rounds, eval every "
          f"{eval_every}, backend=kernel", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    sim, state, ms, times, prof, peak_log = run_algorithm(
        model, fl_kw, "kernel", LLAMA_CLIENTS, LLAMA_SEQ, LLAMA_BATCH,
        rounds, eval_every, dev, steps, 0.05, profiled=True)
    secs = time.perf_counter() - t0
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    check_launches(ran, kernels, what)
    losses = check_finite(ms, state, what)
    ev = check_eval_cadence(ms, rounds, eval_every, what)
    check_algorithm_ledger(sim, ms, what)
    for field, ts in state_fields(state).items():
        if not all(bool(torch.isfinite(t).all()) for t in ts):
            fail(f"{what}: non-finite {field}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if peak >= LLAMA_PEAK_GIB:
        fail(f"{what}: peak memory {peak:.1f} GiB, not under "
             f"{LLAMA_PEAK_GIB} GiB")
    state_gib = {f: round(sum(t.numel() * t.element_size() for t in ts)
                          / 2**30, 2)
                 for f, ts in state_fields(state).items() if ts}
    print(f"{what}: loss per round {fmt(losses)}, eval loss {fmt(ev)}, "
          f"selected {[int(v) for v in ms['selected']]}, up "
          f"{fmt(ms['ledger'].uplink_wire)} B, ledger == terms x selected, "
          f"launches {ran}, round times "
          f"{', '.join(f'{t:.2f}' for t in times)} s ({secs:.2f}s in all)",
          flush=True)
    print(f"{what}: peak memory {peak:.2f} GiB (limit "
          f"{LLAMA_PEAK_GIB:.0f}; last raised in the {peak_log.get('hop')} "
          f"hop), state GiB {state_gib}, on {card_line()}", flush=True)
    print_profile(prof, times[-1], f"{what}, last round")
    del sim, state, ms
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 8-9b: client selection and the async engine
# ---------------------------------------------------------------------------

def selection_phase(dev):
    """Slice 7's selection on paper_lm: each policy on both backends,
    bit-identical, exactly 4 selected every round and billed."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    print(f"paper_lm selection: {SEL_CLIENTS} clients, {SEL_PER_ROUND} per "
          f"round, seq {SEL_SEQ}, batch {SEL_BATCH}, {SEL_ROUNDS} rounds, "
          f"E=2 lr=0.2, EF {SEL_SPEC}, the held-out eval on the last round",
          flush=True)
    for policy in SEL_POLICIES:
        runs = {}
        for backend in ("kernel", "jax"):
            before = launch_counts()
            t0 = time.perf_counter()
            # the held-out eval on the last round only; the first policy's
            # kernel run profiles its last round
            sim, state, ms, times, prof, _ = run_algorithm(
                model, dict(uplink_compressor=SEL_SPEC, selection=policy,
                            clients_per_round=SEL_PER_ROUND),
                backend, SEL_CLIENTS, SEL_SEQ, SEL_BATCH, SEL_ROUNDS,
                SEL_ROUNDS, dev, 2, 0.2,
                profiled=backend == "kernel" and policy == SEL_POLICIES[0])
            secs = time.perf_counter() - t0
            what = f"paper_lm selection={policy} backend={backend}"
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, ("threshold_sparsify", "qsgd_quantize")
                           if backend == "kernel" else (), what)
            losses = check_finite(ms, state, what)
            selected = [int(v) for v in ms["selected"]]
            if selected != [SEL_PER_ROUND] * SEL_ROUNDS:
                fail(f"{what}: selected {selected}, not {SEL_PER_ROUND} "
                     f"every round")
            check_ledger(sim, ms, SEL_PER_ROUND, what)
            check_eval_cadence(ms, SEL_ROUNDS, SEL_ROUNDS, what)
            print(f"{what}: loss per round {fmt(losses)}, eval loss "
                  f"{fmt(ms['eval_loss'])}, selected {selected}, up "
                  f"{fmt(ms['ledger'].uplink_wire)} B ({SEL_PER_ROUND} x "
                  f"{sim.terms['up_wire']:,.0f}), launches {ran}, round "
                  f"times {', '.join(f'{t:.3f}' for t in times)} s "
                  f"({secs:.2f}s in all)", flush=True)
            if prof is not None:
                print_profile(prof, times[-1], f"{what}, last round", top=6)
            runs[backend] = (state, ms)
        (sk, mk), (sp, mp) = runs["kernel"], runs["jax"]
        pairs = (list(zip(_tensors(sk.params), _tensors(sp.params)))
                 + list(zip(_tensors(sk.comm_state), _tensors(sp.comm_state)))
                 + [(getattr(mk["ledger"], f), getattr(mp["ledger"], f))
                    for f in mk["ledger"].fields()]
                 + [(mk[k], mp[k]) for k in ("loss", "loss_all", "selected",
                                             "eval_loss")])
        for a, b in pairs:
            if not same_bits(a, b):
                fail(f"paper_lm selection={policy}: kernel backend differs "
                     f"from the plain backend")
        print(f"paper_lm selection={policy}: kernel and plain backends "
              f"bit-identical ({len(pairs)} tensors: params, EF residuals, "
              f"ledger, losses, selected)", flush=True)


def async_data(model, n_clients, seq, batch, dev, population=None):
    from repro_torch.data.pipeline import cohort_data_fn
    from repro_torch.data.synthetic import FedDataConfig, sample_round

    data = FedDataConfig(vocab_size=model.cfg.vocab_size,
                         num_clients=n_clients, seq_len=seq,
                         batch_per_client=batch, heterogeneity=2.0)
    if population is not None:
        return data, cohort_data_fn(population, data, dev)
    return data, lambda v: sample_round(data, v, dev)


def stack_metrics(metrics):
    from repro_torch.core.types import CommLedger
    ms = {k: torch.stack([m[k] for m in metrics])
          for k in metrics[0] if k != "ledger"}
    ms["ledger"] = CommLedger(**{
        f: torch.stack([m["ledger"].fields()[f] for m in metrics])
        for f in metrics[0]["ledger"].fields()})
    return ms


def run_async(model, fl_kw, topo_kw, backend, slots, seq, batch, events,
              dev, local_steps, local_lr, population=None, profiled=False):
    """``events`` server events of ``make_round_engine(Topology.async_)``
    after its init.  Records each event's popped slot (and, over a
    population, the client it hosts), the event's wall time (host clock,
    synchronised) and the init's; with ``profiled`` the last event runs
    under ``torch.profiler``.  Returns (engine, state, stacked metrics,
    order, arriving ids, event times, init time, peak after the init
    (GiB), the profiler or None, the peak hop log)."""
    from repro_torch.core.engine import Topology, make_round_engine
    from repro_torch.core.types import FLConfig

    fl = FLConfig(backend=backend, local_steps=local_steps,
                  local_lr=local_lr, **fl_kw)
    N = population.n_clients if population is not None else slots
    _, data_fn = async_data(model, N, seq, batch, dev, population)
    engine = make_round_engine(model, fl, Topology.async_(N, **topo_kw),
                               chunk=seq, device=dev, data_fn=data_fn,
                               population=population)
    program = engine.round_fn
    order, arrived = [], []
    pop_hop = dict(program.hops)["pop"]

    def recording_pop(ctx):
        ctx = pop_hop(ctx)
        order.append(ctx["c"])
        if population is not None:
            arrived.append(int(ctx["state"].async_state["slot_client"]
                               [ctx["c"]]))
        return ctx
    program.hops = tuple((n, recording_pop if n == "pop" else f)
                         for n, f in program.hops)
    peak_log = watch_peak(program)
    t0 = time.perf_counter()
    state = engine.init_fn(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    times, metrics, prof = [], [], None
    for e in range(events):
        if profiled and e == events - 1:
            prof = profiled_if(True)
            prof.start()
        t0 = time.perf_counter()
        state, m = program(state, None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if prof is not None:
            prof.stop()
        if population is not None and arrived[-1] not in \
                state.comm_state["client"].tolist():
            fail(f"event {e}: client {arrived[-1]} is not in the store "
                 f"after its arrival")
        metrics.append(m)
    return (engine, state, stack_metrics(metrics), order, arrived, times,
            init_s, init_peak, prof, peak_log)


def async_tensors(state, ms):
    """Every tensor of an async run: params, server moments, comm_state or
    store, the async state, then the per-event metrics and ledger."""
    return (_tensors(state.params) + _tensors(state.server_opt_state)
            + _tensors(state.comm_state) + _tensors(state.async_state)
            + [ms[k] for k in ("loss", "clock", "staleness",
                               "server_version", "flushed", "buffer_fill")]
            + list(ms["ledger"].fields().values()))


def check_async_run(engine, ms, what, slots):
    """Per-event invariants: the clock never runs back, every staleness is
    >= 0, the server version counts the flushes, every event bills one
    upload and each flush one downlink per re-dispatched slot."""
    clock = ms["clock"]
    if not bool((clock[1:] >= clock[:-1]).all()):
        fail(f"{what}: the virtual clock ran back {clock.tolist()}")
    if float(ms["staleness"].min()) < 0:
        fail(f"{what}: negative staleness")
    flushes = int(ms["flushed"].sum())
    if int(ms["server_version"][-1]) != flushes:
        fail(f"{what}: server version {int(ms['server_version'][-1])} != "
             f"{flushes} flushes")
    terms = engine.terms
    up = torch.tensor(terms["up_wire"], dtype=torch.float32)
    if not torch.equal(ms["ledger"].uplink_wire, up.expand_as(clock)):
        fail(f"{what}: an event does not bill exactly one upload")
    down = ms["ledger"].downlink_wire
    if bool(((down > 0) != (ms["flushed"] > 0)).any()) or \
            float(down.max()) > slots * terms["down_wire"]:
        fail(f"{what}: downlink billed off the flushes")
    return flushes


def async_line(ms, order, times, init_s):
    return (f"event order {order}, {int(ms['flushed'].sum())} flushes, "
            f"staleness {[int(v) for v in ms['staleness']]}, final clock "
            f"{float(ms['clock'][-1]):.4f}, loss {float(ms['loss'][-1]):.6f}"
            f"; init {init_s:.2f}s, events {sum(times):.2f}s (max "
            f"{max(times):.3f}s)")


def async_phase(dev):
    """Slice 7's async engine on paper_lm: the degenerate run against the
    sync run, FedBuff, FedAsync and the deadline flush, then the
    population leg; every run on both backends, bit-identical."""
    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import Topology, make_round_engine, \
        run_rounds
    from repro_torch.core.population import ClientPopulation
    from repro_torch.core.types import FLConfig
    from repro_torch.data.pipeline import device_latency
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    kernels = ("threshold_sparsify", "qsgd_quantize")
    data, data_fn = async_data(model, ASYNC_SLOTS, ASYNC_SEQ, ASYNC_BATCH,
                               dev)
    res = data_fn(0)["resources"].cpu()
    median = float(np.median(device_latency("resource", res, None).numpy()))
    print(f"paper_lm async: {ASYNC_SLOTS} slots, seq {ASYNC_SEQ}, batch "
          f"{ASYNC_BATCH}, heterogeneity 2.0, E=2 lr=0.2, {ASYNC_FL}; "
          f"median resource latency {median:.6f}", flush=True)
    degenerate = ("degenerate K=8 constant",
                  dict(buffer_size=ASYNC_SLOTS, latency_profile="constant"),
                  {})
    for label, topo_kw, fl_kw in (degenerate,) + ASYNC_RUNS:
        if topo_kw.get("flush_deadline") == "median":
            topo_kw = dict(topo_kw, flush_deadline=median)
        events = (2 * ASYNC_SLOTS if label == degenerate[0]
                  else ASYNC_EVENTS)
        runs = {}
        for backend in ("kernel", "jax"):
            what = f"paper_lm async {label} backend={backend}"
            before = launch_counts()
            t0 = time.perf_counter()
            engine, state, ms, order, _, times, init_s, _, prof, _ = \
                run_async(model, dict(ASYNC_FL, **fl_kw), topo_kw, backend,
                          ASYNC_SLOTS, ASYNC_SEQ, ASYNC_BATCH, events, dev,
                          2, 0.2, profiled=backend == "kernel")
            secs = time.perf_counter() - t0
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, kernels if backend == "kernel" else (), what)
            check_finite(ms, state, what)
            flushes = check_async_run(engine, ms, what, ASYNC_SLOTS)
            K = topo_kw["buffer_size"]
            if K == 1 and flushes != events:
                fail(f"{what}: FedAsync flushed {flushes} of {events} events")
            if "flush_deadline" not in topo_kw and K > 1 and \
                    flushes != events // K:
                fail(f"{what}: {flushes} flushes, not {events // K}")
            if "flush_deadline" in topo_kw and flushes <= events // K:
                fail(f"{what}: the deadline drove no flush ({flushes})")
            print(f"{what}: {async_line(ms, order, times, init_s)}; "
                  f"launches {ran} ({secs:.2f}s)", flush=True)
            if prof is not None:
                print_profile(prof, times[-1], f"{what}, last event", top=6)
            runs[backend] = (state, ms)
        pairs = list(zip(async_tensors(*runs["kernel"]),
                         async_tensors(*runs["jax"])))
        for a, b in pairs:
            if not same_bits(a, b):
                fail(f"paper_lm async {label}: kernel backend differs from "
                     f"the plain backend")
        print(f"paper_lm async {label}: kernel and plain backends "
              f"bit-identical ({len(pairs)} tensors)", flush=True)
        if label != degenerate[0]:
            continue
        # the degenerate contract: the sync run of the same config
        sa, ma = runs["kernel"]
        fl = FLConfig(backend="kernel", local_steps=2, local_lr=0.2,
                      **ASYNC_FL)
        sync = make_round_engine(model, fl, Topology.sim(ASYNC_SLOTS),
                                 chunk=ASYNC_SEQ, device=dev)
        ss, msy = run_rounds(sync, sync.init_fn(0), data_fn, 2)
        pairs = (list(zip(_tensors(sa.params), _tensors(ss.params)))
                 + list(zip(_tensors(sa.comm_state),
                            _tensors(ss.comm_state)))
                 + [(ma["loss"][ASYNC_SLOTS - 1::ASYNC_SLOTS].to(dev),
                     msy["loss"]),
                    (ma["ledger"].uplink_wire.reshape(2, -1).sum(1)
                     .to(dev), msy["ledger"].uplink_wire),
                    (ma["ledger"].downlink_wire[ASYNC_SLOTS - 1::ASYNC_SLOTS]
                     .to(dev), msy["ledger"].downlink_wire)])
        for a, b in pairs:
            if not torch.equal(a, b):
                fail("paper_lm async degenerate: differs from the sync run")
        if order != list(range(ASYNC_SLOTS)) * 2:
            fail(f"paper_lm async degenerate: event order {order}")
        print(f"paper_lm async degenerate: equal to the sync run bit for "
              f"bit ({len(pairs)} tensors: params, EF residuals, the flush "
              f"losses, the ledger per generation)", flush=True)

    # the population leg (bench_scale's async leg)
    runs = {}
    for backend in ("kernel", "jax"):
        pop = ClientPopulation(**ASYNC_POP)
        what = (f"paper_lm async population={pop.n_clients:,} cohort="
                f"{pop.cohort} capacity={pop.capacity} K={ASYNC_POP_K} "
                f"heavy_tail backend={backend}")
        before = launch_counts()
        t0 = time.perf_counter()
        engine, state, ms, order, arrived, times, init_s, _, prof, _ = \
            run_async(model, ASYNC_FL, dict(buffer_size=ASYNC_POP_K,
                                            latency_profile="heavy_tail"),
                      backend, 0, ASYNC_SEQ, ASYNC_BATCH, ASYNC_EVENTS, dev,
                      2, 0.2, population=pop, profiled=backend == "kernel")
        secs = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in launch_counts().items()}
        check_launches(ran, kernels if backend == "kernel" else (), what)
        check_finite(ms, state, what)
        flushes = check_async_run(engine, ms, what, pop.cohort)
        if flushes != ASYNC_EVENTS // ASYNC_POP_K:
            fail(f"{what}: {flushes} flushes")
        print(f"{what}: {async_line(ms, order, times, init_s)}; arriving "
              f"clients {arrived[:8]}...; store resident "
              f"{int((state.comm_state['client'] >= 0).sum())} of "
              f"{pop.capacity}; launches {ran} ({secs:.2f}s)", flush=True)
        if prof is not None:
            print_profile(prof, times[-1], f"{what}, last event", top=6)
        runs[backend] = (state, ms)
    pairs = list(zip(async_tensors(*runs["kernel"]),
                     async_tensors(*runs["jax"])))
    for a, b in pairs:
        if not same_bits(a, b):
            fail("paper_lm async population: kernel backend differs from "
                 "the plain backend")
    print(f"paper_lm async population: kernel and plain backends "
          f"bit-identical ({len(pairs)} tensors)", flush=True)


def llama_async_phase(dev):
    """llama3_2_1b at full width and depth on the async engine: FedAsync
    over 2 slots through the kernels, the peak memory under 76 GiB."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch("llama3_2_1b")
    model = Model(cfg)
    kw = dict(LLAMA_ASYNC)
    what = (f"llama3_2_1b async {kw['slots']} slots K={kw['buffer_size']} "
            f"{kw['latency_profile']} EF {kw['spec']}")
    print(f"{what}: {model.param_count():,} params, {cfg.num_layers} layers "
          f"(no depth cut), seq {LLAMA_SEQ}, batch {LLAMA_BATCH}, E=1, "
          f"{kw['events']} events, backend=kernel", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    engine, state, ms, order, _, times, init_s, init_peak, prof, peak_log = \
        run_async(model, dict(uplink_compressor=kw["spec"]),
                  dict(buffer_size=kw["buffer_size"],
                       latency_profile=kw["latency_profile"]), "kernel",
                  kw["slots"], LLAMA_SEQ, LLAMA_BATCH, kw["events"], dev, 1,
                  0.05, profiled=True)
    secs = time.perf_counter() - t0
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    check_launches(ran, ("threshold_sparsify", "qsgd_pack"), what)
    check_finite(ms, state, what)
    flushes = check_async_run(engine, ms, what, kw["slots"])
    if flushes != kw["events"]:
        fail(f"{what}: {flushes} flushes in {kw['events']} events")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if peak >= LLAMA_PEAK_GIB:
        fail(f"{what}: peak memory {peak:.1f} GiB, not under "
             f"{LLAMA_PEAK_GIB} GiB")
    state_gib = {f: round(sum(t.numel() * t.element_size()
                              for t in _tensors(v)) / 2**30, 2)
                 for f, v in (("params", state.params),
                              ("comm_state", state.comm_state),
                              ("pending_comm",
                               state.async_state.get("pending_comm")),
                              ("updates", state.async_state["updates"]))}
    print(f"{what}: {async_line(ms, order, times, init_s)}; event times "
          f"{', '.join(f'{t:.2f}' for t in times)} s; launches {ran} "
          f"({secs:.2f}s in all)", flush=True)
    print(f"{what}: peak memory {peak:.2f} GiB (limit {LLAMA_PEAK_GIB:.0f}; "
          f"{init_peak:.2f} GiB by the end of the init; last raised in the "
          f"{peak_log.get('hop', 'init')} hop), state GiB {state_gib}, on "
          f"{card_line()}", flush=True)
    print_profile(prof, times[-1], f"{what}, last event")
    del engine, state, ms
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 10-11: the privacy wire and the scenario's client dynamics
# ---------------------------------------------------------------------------

def drop_ctx(tree):
    from repro_torch.compress.secure_agg import drop_mask_ctx
    return drop_mask_ctx(tree)


def run_tensors(state, ms, entropy=True):
    """params, the comm state (the secagg context dropped), the ledger
    (without ``uplink_entropy`` unless ``entropy``: masked codes are
    uniform, so a masked wire's entropy bill is its wire bill) and the
    loss of a sim run."""
    led = [v for f, v in ms["ledger"].fields().items()
           if entropy or f != "uplink_entropy"]
    return (_tensors(state.params) + _tensors(drop_ctx(state.comm_state))
            + led + [ms["loss"]])


def check_pairs(a, b, what, rtol=None):
    """Bit-identical tensor pairs (NaN where NaN), or within ``rtol`` (and
    an atol of ``rtol`` times the pair's largest magnitude)."""
    if len(a) != len(b):
        fail(f"{what}: {len(a)} tensors against {len(b)}")
    for x, y in zip(a, b):
        if rtol is None:
            ok = same_bits(x, y)
        else:
            x, y = x.double(), y.double()
            scale = float(y.abs().max()) if y.numel() else 0.0
            ok = x.shape == y.shape and bool(torch.allclose(
                x, y, rtol=rtol, atol=rtol * scale))
        if not ok:
            err = float((x.double() - y.double()).abs().max()) \
                if x.shape == y.shape else float("nan")
            fail(f"{what}: tensors differ (max abs err {err})")
    return len(a)


def run_paper(model, fl_kw, backend, dev, what, expect, clients=None,
              rounds=None, local_steps=2):
    """One paper_lm sim run (phase 4's clients, seq, batch and rounds
    unless given; lr 0.2) with its launch check; returns (sim, state, ms,
    launches, seconds)."""
    before = launch_counts()
    t0 = time.perf_counter()
    sim, state, ms = run_sim(model, fl_kw, backend,
                             clients or PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                             PAPER_LM_BATCH, rounds or PAPER_LM_ROUNDS, dev,
                             local_steps, 0.2)
    secs = time.perf_counter() - t0
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    check_launches(ran, expect, what)
    return sim, state, ms, ran, secs


def code_plane_sums(spec, dev):
    """One paper_lm-sized leaf (65,536 elements) encoded by 8 clients on
    the kernel backend, each with its injected context: the masked
    integer planes summed over the cohort equal the clear planes' sum mod
    2^w, and with client C/2 left out the sum plus
    ``dropout_correction`` equals the clear sum of the others."""
    from repro_torch.compress.api import make_compressor
    from repro_torch.compress.secure_agg import (_is_int_plane,
                                                 dropout_correction,
                                                 inject_mask_ctx)
    from repro_torch.core.rng import Key

    masked = make_compressor(spec, backend="kernel")
    n, C = 65_536, PAPER_LM_CLIENTS
    drop = C // 2
    key = Key(18).fold_in(0x5eca66)
    g = torch.Generator(device=dev).manual_seed(18)
    planes_m, planes_c, clear_d = [], [], None
    for i in range(C):
        x = torch.randn(n, generator=g, device=dev) * 0.01
        st = inject_mask_ctx(masked.init((n,), dev), key, i, C)
        pm, _ = masked.encode(st, Key(7).fold_in(i), x)
        ctx = dict(pm).pop("secagg_ctx")
        body = {k: v for k, v in pm.items() if k != "secagg_ctx"}
        clear = masked.inner.encode(masked.inner.init((n,), dev),
                                    Key(7).fold_in(i), x)[0]
        planes_m.append([t for t in _tensors(body) if _is_int_plane(t)])
        planes_c.append([t for t in _tensors(clear) if _is_int_plane(t)])
        if i == drop:
            clear_d = clear
        if (ctx["idx"], ctx["cohort"]) != (i, C):
            fail(f"{spec}: context {ctx['idx']}, {ctx['cohort']}")
    # the dropped client's whole payload is the template: its plane ids
    # count its float planes too
    corr = [t for t in _tensors(dropout_correction(key, drop, C, clear_d))
            if _is_int_plane(t)]
    n_planes = len(planes_c[0])
    for p in range(n_planes):
        w = torch.iinfo(planes_c[0][p].dtype).bits
        mod = lambda v: torch.bitwise_and(v, (1 << w) - 1)
        tot_m = sum(pl[p].to(torch.int64) for pl in planes_m)
        tot_c = sum(pl[p].to(torch.int64) for pl in planes_c)
        if not torch.equal(mod(tot_m), mod(tot_c)):
            fail(f"{spec}: plane {p}'s masked sum over the cohort differs "
                 f"from the clear sum")
        part_m = sum(pl[p].to(torch.int64) for i, pl in enumerate(planes_m)
                     if i != drop)
        part_c = tot_c - planes_c[drop][p].to(torch.int64)
        if torch.equal(mod(part_m), mod(part_c)):
            fail(f"{spec}: plane {p} unmasked without client {drop}")
        if not torch.equal(mod(part_m + corr[p].to(torch.int64)),
                           mod(part_c)):
            fail(f"{spec}: plane {p}: the sum without client {drop} plus "
                 f"dropout_correction is not the clear sum")
    return n_planes


def privacy_phase(dev):
    """Slice 8's privacy wire on paper_lm: each PRIVACY_CASES spec masked
    against its clear run and across backends, the code-plane sums, and
    dp_rho on the ledger."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    print(f"paper_lm privacy: {PAPER_LM_CLIENTS} clients, seq "
          f"{PAPER_LM_SEQ}, batch {PAPER_LM_BATCH}, {PAPER_LM_ROUNDS} "
          f"rounds, E=2 lr=0.2", flush=True)
    for label, masked, clear, ef, rtol, kernels in PRIV_RUNS:
        out = {}
        for tag, spec, backend in (("masked", masked, "kernel"),
                                   ("masked", masked, "jax"),
                                   ("clear", clear, "kernel")):
            what = f"paper_lm privacy {label} {tag} backend={backend}"
            sim, state, ms, ran, secs = run_paper(
                model, dict(uplink_compressor=spec, error_feedback=ef),
                backend, dev, what, kernels if backend == "kernel" else ())
            losses = check_finite(ms, state, what)
            check_ledger(sim, ms, PAPER_LM_CLIENTS, what)
            out[tag, backend] = (state, ms)
            print(f"{what}: loss per round {fmt(losses)} "
                  f"up={float(ms['ledger'].uplink_wire[0]):,.0f} B/round "
                  f"entropy={float(ms['ledger'].uplink_entropy[0]):,.0f} "
                  f"B/round launches {ran} ({secs:.2f}s)", flush=True)
        mk, mp, ck = out["masked", "kernel"], out["masked", "jax"], \
            out["clear", "kernel"]
        n = check_pairs(run_tensors(*mk, entropy=False),
                        run_tensors(*ck, entropy=False),
                        f"paper_lm privacy {label}: masked vs clear")
        if bool((mk[1]["ledger"].uplink_entropy
                 < ck[1]["ledger"].uplink_entropy).any()):
            fail(f"paper_lm privacy {label}: masked entropy below clear")
        if rtol is None:
            m = check_pairs(run_tensors(*mk), run_tensors(*mp),
                            f"paper_lm privacy {label}: backends")
        else:
            # mu is a sum in another order on the two backends (phase
            # 4b): the ledger is exact and the losses within rtol, and the
            # params it drifts over the free-running rounds within 4c's
            # engine-scope 1e-3
            what = f"paper_lm privacy {label}: backends"
            m = check_pairs(list(mk[1]["ledger"].fields().values()),
                            list(mp[1]["ledger"].fields().values()), what)
            m += check_pairs([mk[1]["loss"]], [mp[1]["loss"]], what,
                             rtol=rtol)
            m += check_pairs(_tensors(mk[0].params), _tensors(mp[0].params),
                             what, rtol=PRIV_PARAM_RTOL)
            gap = max(float(((a.double() - b.double()).abs()
                             / b.double().abs().max()).max())
                      for a, b in zip(_tensors(mk[0].params),
                                      _tensors(mp[0].params)))
        planes = code_plane_sums(masked, dev)
        across = ("bit-identical" if rtol is None else
                  f"ledger exact, loss within rtol {rtol}, params within "
                  f"{PRIV_PARAM_RTOL} of their scale (largest gap {gap:.3g})")
        print(f"paper_lm privacy {label}: masked == clear bit for bit ({n} "
              f"tensors: params, EF rows, ledger, loss); backends {across}"
              f" ({m} tensors); {planes} code planes sum to the clear sum "
              f"over the cohort, and without client {PAPER_LM_CLIENTS // 2}"
              f" to it minus dropout_correction", flush=True)
    # dp_rho rides the ledger: C x 0.5 / sigma^2 in f32 every round
    what = f"paper_lm privacy {PRIV_DP} backend=kernel"
    sim, state, ms, ran, secs = run_paper(
        model, dict(uplink_compressor=PRIV_DP), "kernel", dev, what,
        ("threshold_sparsify", "qsgd_quantize"))
    check_finite(ms, state, what)
    rho = torch.tensor(PAPER_LM_CLIENTS, dtype=torch.float32) * \
        torch.tensor(0.5 / 0.8 ** 2, dtype=torch.float32)
    got = ms["ledger"].dp_rho.cpu()
    if not torch.equal(got, rho.expand_as(got)):
        fail(f"{what}: dp_rho {got.tolist()} != {float(rho)} a round")
    print(f"{what}: dp_rho {got.tolist()} a round, {float(got.sum()):.6f} "
          f"over {PAPER_LM_ROUNDS} rounds (= rounds x {PAPER_LM_CLIENTS} x "
          f"0.5/0.8^2 in f32); launches {ran} ({secs:.2f}s)", flush=True)


def llama_privacy_phase(dev):
    """llama3_2_1b at full width and depth: EF topk+qsgd:4@fused with DP
    noise, secure aggregation and mid-round dropout, masked against the
    same run in the clear; the ledger bills the pre-dropout count."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch("llama3_2_1b")
    model = Model(cfg)
    fl_kw = dict(LLAMA_PRIV)
    print(f"llama3_2_1b privacy: {model.param_count():,} params, "
          f"{cfg.num_layers} layers (no depth cut), {LLAMA_CLIENTS} clients, "
          f"seq {LLAMA_SEQ}, batch {LLAMA_BATCH}, E=1, {LLAMA_ROUNDS} rounds "
          f"of {fl_kw} backend=kernel", flush=True)
    out = {}
    for secure in (True, False):
        what = f"llama3_2_1b privacy secure_agg={secure}"
        torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts()
        t0 = time.perf_counter()
        peak_log = {}
        sim, state, ms = run_sim(model, dict(fl_kw, secure_agg=secure),
                                 "kernel", LLAMA_CLIENTS, LLAMA_SEQ,
                                 LLAMA_BATCH, LLAMA_ROUNDS, dev, 1, 0.05,
                                 peak_log=peak_log)
        secs = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in launch_counts().items()}
        check_launches(ran, ("threshold_sparsify", "qsgd_pack"), what)
        for t in _tensors(state.params):
            if not bool(torch.isfinite(t).all()):
                fail(f"{what}: non-finite parameters")
        # every client shipped its payload: billed whether or not it
        # dropped mid-round
        check_ledger(sim, ms, LLAMA_CLIENTS, what)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if peak >= LLAMA_PEAK_GIB:
            fail(f"{what}: peak memory {peak:.1f} GiB, not under "
                 f"{LLAMA_PEAK_GIB} GiB")
        print(f"{what}: loss per round {fmt(ms['loss'])}, selected "
              f"{fmt(ms['selected'])} of {LLAMA_CLIENTS}, billed "
              f"{LLAMA_CLIENTS} a round (the pre-dropout count), dp_rho "
              f"{fmt(ms['ledger'].dp_rho)}; launches {ran}; peak memory "
              f"{peak:.2f} GiB (limit {LLAMA_PEAK_GIB:.0f}; last raised in "
              f"the {peak_log.get('hop')} hop) on {card_line()}; "
              f"{secs:.2f}s", flush=True)
        # on the host, so that the next run's peak is its own
        out[secure] = [t.cpu() for t in run_tensors(state, ms,
                                                    entropy=False)]
        del sim, state, ms
        torch.cuda.empty_cache()
    n = check_pairs(out[True], out[False],
                    "llama3_2_1b privacy: masked vs clear")
    print(f"llama3_2_1b privacy: masked == clear bit for bit ({n} tensors: "
          f"params, EF rows, ledger, loss)", flush=True)
    del out
    torch.cuda.empty_cache()


def scenario_phase(dev):
    """Slice 8's client dynamics on paper_lm: the degenerate
    SCENARIO_CASES against the scenario-free runs, the square and diurnal
    traces, dropout under secagg, epoch scaling, the population trace and
    the async adaptive deadline; every run on both backends,
    bit-identical."""
    from repro_torch.compress.residual_store import _leaves
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import scenario as scn
    from repro_torch.core.population import ClientPopulation
    from repro_torch.data.synthetic import sample_round
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    C = PAPER_LM_CLIENTS
    print(f"paper_lm scenario: {C} clients, seq {PAPER_LM_SEQ}, batch "
          f"{PAPER_LM_BATCH}, E=2 lr=0.2 unless a run says otherwise",
          flush=True)
    # the degenerate cases: the dynamics hops run and draw identity masks
    for label, spec, fl_kw, kern, plain in SCN_CASES:
        out = {}
        for tag, kw, backend in (("on", fl_kw, "kernel"),
                                 ("on", fl_kw, "jax"),
                                 ("off", {}, "kernel")):
            what = f"paper_lm scenario {label} {tag} backend={backend}"
            sim, state, ms, ran, secs = run_paper(
                model, dict(kw, uplink_compressor=spec), backend, dev, what,
                kern if backend == "kernel" else plain, rounds=SCN_ROUNDS)
            check_finite(ms, state, what)
            out[tag, backend] = (state, ms)
        on, off = out["on", "kernel"], out["off", "kernel"]
        n = check_pairs(run_tensors(*on), run_tensors(*off),
                        f"paper_lm scenario {label}: on vs off")
        m = check_pairs(run_tensors(*on), run_tensors(*out["on", "jax"]),
                        f"paper_lm scenario {label}: backends")
        print(f"paper_lm scenario {label} ({spec}, {fl_kw}): equal to the "
              f"scenario-free run bit for bit ({n} tensors), backends "
              f"bit-identical ({m}); loss {fmt(on[1]['loss'])}", flush=True)

    # the traces at duty 0.5 over 16 clients: selected = the mask's count
    for trace in ("square", "diurnal"):
        fl_kw = dict(uplink_compressor=SEL_SPEC, scenario_trace=trace,
                     scenario_availability=0.5, scenario_period=6.0,
                     scenario_seed=1)
        out = {}
        for backend in ("kernel", "jax"):
            what = f"paper_lm scenario {trace} 0.5 backend={backend}"
            sim, state, ms, ran, secs = run_paper(
                model, fl_kw, backend, dev, what,
                ("threshold_sparsify", "qsgd_quantize")
                if backend == "kernel" else (), clients=SCN_TRACE_CLIENTS)
            check_finite(ms, state, what)
            check_algorithm_ledger(sim, ms, what)
            out[backend] = (state, ms)
        sc = scn.Scenario(trace=trace, availability=0.5, period=6.0, seed=1)
        ids = torch.arange(SCN_TRACE_CLIENTS, dtype=torch.int32, device=dev)
        want = [float(scn.availability_mask(sc, sc.seed, 0.5, r, ids).sum())
                for r in range(PAPER_LM_ROUNDS)]
        sel = fmt(out["kernel"][1]["selected"])
        if sel != want:
            fail(f"paper_lm scenario {trace}: selected {sel} != the "
                 f"trace's available counts {want}")
        m = check_pairs(run_tensors(*out["kernel"]),
                        run_tensors(*out["jax"]),
                        f"paper_lm scenario {trace}: backends")
        print(f"paper_lm scenario {trace} trace, duty 0.5, period 6, "
              f"{SCN_TRACE_CLIENTS} clients: selected per round {sel}; "
              f"backends bit-identical ({m} tensors)", flush=True)

    # mid-round dropout under secagg against the clear run: billed before
    # the dropout, the survivors' rows only in the aggregate
    out = {}
    for tag, spec, backend in (("masked", "qsgd:4>>secagg", "kernel"),
                               ("masked", "qsgd:4>>secagg", "jax"),
                               ("clear", "qsgd:4", "kernel")):
        what = f"paper_lm scenario dropout 0.3 {tag} backend={backend}"
        sim, state, ms, ran, secs = run_paper(
            model, dict(uplink_compressor=spec, scenario_dropout=0.3),
            backend, dev, what,
            ("qsgd_quantize",) if backend == "kernel" else ())
        check_finite(ms, state, what)
        check_ledger(sim, ms, C, what)
        out[tag, backend] = (state, ms)
    n = check_pairs(run_tensors(*out["masked", "kernel"], entropy=False),
                    run_tensors(*out["clear", "kernel"], entropy=False),
                    "paper_lm scenario dropout: masked vs clear")
    m = check_pairs(run_tensors(*out["masked", "kernel"]),
                    run_tensors(*out["masked", "jax"]),
                    "paper_lm scenario dropout: backends")
    print(f"paper_lm scenario dropout 0.3, qsgd:4>>secagg: selected "
          f"{fmt(out['masked', 'kernel'][1]['selected'])} of {C}, billed {C}"
          f" a round; masked == clear bit for bit ({n} tensors), backends "
          f"bit-identical ({m})", flush=True)

    # epoch scaling at E=4: each client's step budget
    fl_kw = dict(uplink_compressor=SEL_SPEC, scenario_epoch_scale=0.5)
    out = {}
    for backend in ("kernel", "jax"):
        what = f"paper_lm scenario epoch_scale 0.5 E=4 backend={backend}"
        sim, state, ms, ran, secs = run_paper(
            model, fl_kw, backend, dev, what,
            ("threshold_sparsify", "qsgd_quantize")
            if backend == "kernel" else (), rounds=2, local_steps=4)
        check_finite(ms, state, what)
        out[backend] = (state, ms)
    steps = [scn.epoch_steps(scn.Scenario(epoch_scale=0.5), 4,
                             sample_round(fed_data(model, C, PAPER_LM_SEQ,
                                                   PAPER_LM_BATCH), r, dev)
                             ["resources"])[0].tolist() for r in range(2)]
    if len(set(steps[0])) < 2:
        fail(f"epoch scaling: every client ran {steps[0]} steps")
    m = check_pairs(run_tensors(*out["kernel"]), run_tensors(*out["jax"]),
                    "paper_lm scenario epoch_scale: backends")
    print(f"paper_lm scenario epoch_scale 0.5 at E=4: n_steps per round "
          f"{steps}; loss {fmt(out['kernel'][1]['loss'])}; backends "
          f"bit-identical ({m} tensors)", flush=True)

    # the population leg: a square trace over 100,000 clients
    runs = {}
    for backend in ("kernel", "jax"):
        pop = ClientPopulation(**SCN_POP)
        what = (f"paper_lm scenario population={pop.n_clients:,} square "
                f"0.5 backend={backend}")
        before = launch_counts()
        t0 = time.perf_counter()
        engine, state, ms, recs, _ = run_population(
            model, dict(uplink_compressor=POP_SPEC, scenario_trace="square",
                        scenario_period=4.0, scenario_seed=2), backend, pop,
            PAPER_LM_SEQ, PAPER_LM_BATCH, SCN_ROUNDS + 1, dev, 2, 0.2)
        secs = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in launch_counts().items()}
        check_launches(ran, ("threshold_sparsify", "qsgd_quantize")
                       if backend == "kernel" else (), what)
        check_finite(ms, state, what)
        check_algorithm_ledger(engine, ms, what)
        want = [float(engine.aux["population"].availability_mask(
            r, torch.tensor(rec["ids"], dtype=torch.int32, device=dev))
            .sum()) for r, rec in enumerate(recs)]
        if fmt(ms["selected"]) != want:
            fail(f"{what}: selected {fmt(ms['selected'])} != the trace's "
                 f"{want}")
        print(f"{what}: selected per round {fmt(ms['selected'])} of "
              f"{pop.cohort}; {round_times(recs)}; launches {ran} "
              f"({secs:.2f}s)", flush=True)
        runs[backend] = (state, ms)
    pairs = (list(zip(_tensors(runs["kernel"][0].params),
                      _tensors(runs["jax"][0].params)))
             + list(zip(_leaves(runs["kernel"][0].comm_state),
                        _leaves(runs["jax"][0].comm_state))))
    check_pairs([a for a, _ in pairs], [b for _, b in pairs],
                "paper_lm scenario population: backends")
    print(f"paper_lm scenario population: backends bit-identical "
          f"({len(pairs)} tensors)", flush=True)

    # the async leg: the deadline tracks the 0.5 completion quantile,
    # dropout 0.2
    runs = {}
    for backend in ("kernel", "jax"):
        what = f"paper_lm scenario async {SCN_ASYNC_TOPO} backend={backend}"
        before = launch_counts()
        t0 = time.perf_counter()
        engine, state, ms, order, _, times, init_s, _, _, _ = run_async(
            model, dict(ASYNC_FL, scenario_deadline_quantile=0.5,
                        scenario_dropout=0.2), SCN_ASYNC_TOPO, backend,
            ASYNC_SLOTS, ASYNC_SEQ, ASYNC_BATCH, SCN_ASYNC_EVENTS, dev, 2,
            0.2)
        secs = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in launch_counts().items()}
        check_launches(ran, ("threshold_sparsify", "qsgd_quantize")
                       if backend == "kernel" else (), what)
        check_finite(ms, state, what)
        check_async_run(engine, ms, what, ASYNC_SLOTS)
        # one Robbins-Monro step per arrival moves q_est every event
        q = ms["q_est"].tolist()
        if any(a == b for a, b in zip(q, q[1:])):
            fail(f"{what}: q_est did not move every event "
                 f"{fmt(ms['q_est'])}")
        # a flush empties the buffer, so its fill is the arrivals since
        # the last one; below K, the deadline fired it
        at = [e for e, f in enumerate(ms["flushed"].tolist()) if f]
        fills = [e - p for e, p in zip(at, [-1] + at[:-1])]
        flush_t = [round(float(ms["clock"][e]), 4) for e in at]
        print(f"{what}: {async_line(ms, order, times, init_s)}; flush times "
              f"{flush_t} with fills {fills}; q_est {fmt(ms['q_est'])}; "
              f"launches {ran} ({secs:.2f}s)", flush=True)
        runs[backend] = (state, ms)
    a = async_tensors(*runs["kernel"]) + [runs["kernel"][1]["q_est"]]
    b = async_tensors(*runs["jax"]) + [runs["jax"][1]["q_est"]]
    n = check_pairs(a, b, "paper_lm scenario async: backends")
    print(f"paper_lm scenario async: backends bit-identical ({n} tensors)",
          flush=True)


# ---------------------------------------------------------------------------
# phases 12-12b: the flight recorder and checkpoints
# ---------------------------------------------------------------------------

def tele_run(model, fl_kw, backend, tele, dev, rounds, clients=None,
             pop=None, topo_kw=None, seq=PAPER_LM_SEQ, batch=PAPER_LM_BATCH,
             local_steps=2, heterogeneity=1.5):
    """``rounds`` rounds (server events when ``topo_kw`` is given) of
    ``make_round_engine`` with ``FLConfig.telemetry`` = ``tele``: the sim
    over ``clients`` or a population ``pop``, or the async engine.  Each
    round's record holds its wall time (host clock, synchronised) and,
    with a store, the resident clients before and after it and the ids it
    touched (the cohort, or the arriving client).  Returns (engine, state,
    stacked metrics, records)."""
    from repro_torch.core.engine import Topology, make_round_engine, \
        stack_rows
    from repro_torch.core.types import FLConfig
    from repro_torch.data.pipeline import cohort_data_fn
    from repro_torch.data.synthetic import FedDataConfig, sample_round

    fl = FLConfig(backend=backend, local_steps=local_steps, local_lr=0.2,
                  telemetry=tele, **fl_kw)
    N = pop.n_clients if pop is not None else clients
    data = FedDataConfig(vocab_size=model.cfg.vocab_size, num_clients=N,
                         seq_len=seq, batch_per_client=batch,
                         heterogeneity=heterogeneity)
    data_fn = (cohort_data_fn(pop, data, dev) if pop is not None
               else lambda r: sample_round(data, r, dev))
    topo = (Topology.async_(N, **topo_kw) if topo_kw is not None
            else Topology.sim(N))
    engine = make_round_engine(model, fl, topo, chunk=seq, device=dev,
                               data_fn=data_fn, population=pop)
    state = engine.init_fn(0)
    store = engine.aux.get("store")
    rows, recs = [], []
    for _ in range(rounds):
        rec = {}
        batch_r = None if topo_kw is not None else data_fn(state.round)
        if store is not None:
            rec["before"] = state.comm_state["client"].tolist()
            if topo_kw is None:
                rec["ids"] = batch_r["ids"].tolist()
            else:
                A = state.async_state
                c = int(torch.argmin(A["next_done"]))
                rec["ids"] = [int(A["slot_client"][c])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = engine.round_fn(state, batch_r)
        torch.cuda.synchronize()
        rec["secs"] = time.perf_counter() - t0
        if store is not None:
            rec["after"] = state.comm_state["client"].tolist()
        rows.append(m)
        recs.append(rec)
    return engine, state, stack_rows(rows), recs


def tele_tensors(state, ms):
    """Every tensor a run computes but the telemetry: params, server
    moments, pipeline or store state, async state, the metrics and the
    ledger."""
    return (_tensors(state.params) + _tensors(state.server_opt_state)
            + _tensors(state.comm_state) + _tensors(state.async_state)
            + [ms[k] for k in sorted(ms) if k not in ("ledger",
                                                      "round_stats")]
            + list(ms["ledger"].fields().values()))


def stats_cpu(rs):
    return {f: v.cpu() for f, v in rs.fields().items()}


def check_slots(rs, ledger, what):
    """Every round's stage slots, summed one after another in f32, equal
    the ledger's wire totals."""
    for slots, total in (("up_stage_bytes", ledger.uplink_wire),
                         ("down_stage_bytes", ledger.downlink_wire)):
        s, t = getattr(rs, slots).cpu(), total.cpu()
        for r in range(t.shape[0]):
            acc = torch.zeros((), dtype=torch.float32)
            for v in s[r]:
                acc = acc + v
            if not torch.equal(acc, t[r]):
                fail(f"{what} round {r}: {slots} sum to {float(acc)!r}, "
                     f"the ledger bills {float(t[r])!r}")


def check_store_counters(rs, recs, eviction, what):
    """The counters equal what the resident clients before and after each
    round show: hits (ids already resident), misses, evictions (residents
    that left) and, under ``sketch``, every miss recovered."""
    rs = stats_cpu(rs)
    for r, rec in enumerate(recs):
        before = set(rec["before"]) - {-1}
        after = set(rec["after"]) - {-1}
        hits = len(set(rec["ids"]) & before)
        miss = len(rec["ids"]) - hits
        want = {"store_hits": hits, "store_misses": miss,
                "store_evictions": len(before - after),
                "store_sketch_recovered": miss if eviction == "sketch"
                else 0}
        got = {k: float(rs[k][r]) for k in want}
        if got != {k: float(v) for k, v in want.items()}:
            fail(f"{what} round {r}: counters {got} != the slots' {want}")


def tele_summary(rs):
    rs = stats_cpu(rs)
    return (f"up slots round 0 {fmt(rs['up_stage_bytes'][0])}, down "
            f"{fmt(rs['down_stage_bytes'][0])}; selected "
            f"{fmt(rs['selected'])}, available {fmt(rs['available'])}, "
            f"dropped {fmt(rs['dropped'])}, staleness histogram "
            f"{fmt(rs['staleness_hist'].sum(0))}, epoch-scale histogram "
            f"{fmt(rs['epoch_scale_hist'].sum(0))}, store hits/misses/"
            f"evictions/recovered "
            f"{[int(rs[k].sum()) for k in ('store_hits', 'store_misses',
                                          'store_evictions',
                                          'store_sketch_recovered')]}")


def telemetry_phase(dev):
    """Slice 9's flight recorder on paper_lm: each configuration with
    telemetry on and off on both backends, bit-identical but for the
    telemetry; the stage slots summing to the ledger; the store counters
    against the slots; the backends' RoundStats bit-identical; then the
    CLI's --trace, --profile-dir and --checkpoint on the sim, population
    and async paths."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.population import ClientPopulation
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    N, M, S, _ = EVICT_POP
    async_topo = dict(ASYNC_RUNS[0][1])
    configs = (
        ("dense square 0.5 + dropout 0.3 + epoch scale 0.5 E=4, EF "
         + CHAINS[1], dict(uplink_compressor=CHAINS[1],
                           scenario_trace="square",
                           scenario_availability=0.5, scenario_period=6.0,
                           scenario_dropout=0.3, scenario_epoch_scale=0.5,
                           scenario_seed=1),
         dict(clients=PAPER_LM_CLIENTS, rounds=PAPER_LM_ROUNDS,
              local_steps=4),
         ("threshold_sparsify", "qsgd_quantize", "qsgd_pack"), None),
        ("population drop", dict(uplink_compressor=POP_SPEC),
         dict(pop=dict(n_clients=N, cohort=M, capacity=S, eviction="drop"),
              rounds=TELE_POP_ROUNDS, local_steps=1, heterogeneity=2.0),
         ("threshold_sparsify", "qsgd_quantize"), "drop"),
        ("population sketch", dict(uplink_compressor=POP_SPEC),
         dict(pop=dict(n_clients=N, cohort=M, capacity=S,
                       eviction="sketch"),
              rounds=TELE_POP_ROUNDS, local_steps=1, heterogeneity=2.0),
         ("threshold_sparsify", "qsgd_quantize"), "sketch"),
        ("async " + ASYNC_RUNS[0][0],
         dict(ASYNC_FL, **ASYNC_RUNS[0][2]),
         dict(clients=ASYNC_SLOTS, topo_kw=async_topo, rounds=ASYNC_EVENTS,
              seq=ASYNC_SEQ, batch=ASYNC_BATCH, heterogeneity=2.0),
         ("threshold_sparsify", "qsgd_quantize"), None),
        (f"async population {ASYNC_POP['n_clients']:,} K={ASYNC_POP_K}",
         dict(ASYNC_FL), dict(pop=ASYNC_POP,
                              topo_kw=dict(buffer_size=ASYNC_POP_K,
                                           latency_profile="heavy_tail"),
                              rounds=ASYNC_EVENTS, seq=ASYNC_SEQ,
                              batch=ASYNC_BATCH, heterogeneity=2.0),
         ("threshold_sparsify", "qsgd_quantize"), "drop"),
        ("dense qsgd:4>>secagg", dict(uplink_compressor="qsgd:4>>secagg"),
         dict(clients=PAPER_LM_CLIENTS, rounds=PAPER_LM_ROUNDS),
         ("qsgd_quantize",), None),
    )
    print(f"paper_lm telemetry: {len(configs)} configurations, each with "
          f"telemetry on and off on both backends", flush=True)
    for label, fl_kw, run_kw, kernels, eviction in configs:
        out = {}
        for backend in ("kernel", "jax"):
            for tele in (False, True):
                kw = dict(run_kw)
                if "pop" in kw:
                    kw["pop"] = ClientPopulation(**kw["pop"])
                what = (f"paper_lm telemetry {label} backend={backend} "
                        f"telemetry={'on' if tele else 'off'}")
                before = launch_counts()
                engine, state, ms, recs = tele_run(model, fl_kw, backend,
                                                   tele, dev, **kw)
                ran = {k: v - before[k] for k, v in launch_counts().items()}
                check_launches(ran, kernels if backend == "kernel" else (),
                               what)
                check_finite(ms, state, what)
                if tele:
                    rs = ms["round_stats"]
                    check_slots(rs, ms["ledger"], what)
                    if eviction is not None:
                        check_store_counters(rs, recs, eviction, what)
                elif "round_stats" in ms:
                    fail(f"{what}: round_stats without telemetry")
                out[backend, tele] = (state, ms, recs, engine)
            (s0, m0, r0, _), (s1, m1, r1, e1) = out[backend, False], \
                out[backend, True]
            n = check_pairs(tele_tensors(s0, m0), tele_tensors(s1, m1),
                            f"paper_lm telemetry {label} backend={backend}:"
                            f" on vs off")
            secs = [sum(r["secs"] for r in rr) for rr in (r0, r1)]
            print(f"paper_lm telemetry {label} backend={backend}: on == off "
                  f"bit for bit ({n} tensors); slots sum to the ledger "
                  f"every round"
                  + (", counters == slots" if eviction is not None else "")
                  + f"; {len(r1)} rounds in {secs[0]:.3f} s off, "
                  f"{secs[1]:.3f} s on ({100 * (secs[1] / secs[0] - 1):+.1f}"
                  f"%); slots {list(e1.aux['telemetry'].up_names)} / "
                  f"{list(e1.aux['telemetry'].down_names)}", flush=True)
        a = list(stats_cpu(out["kernel", True][1]["round_stats"]).values())
        b = list(stats_cpu(out["jax", True][1]["round_stats"]).values())
        m = check_pairs(a, b, f"paper_lm telemetry {label}: backends' "
                        f"RoundStats")
        print(f"paper_lm telemetry {label}: backends' RoundStats "
              f"bit-identical ({m} fields); "
              f"{tele_summary(out['kernel', True][1]['round_stats'])}",
              flush=True)
        del out
    cli_phase(dev)


def scratch_dir(prefix):
    """A new directory under the checkout's ``build/`` (which git ignores)
    for a phase's files; the phase deletes it."""
    import tempfile
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=base)


def cli_phase(dev):
    """``repro_torch.launch.train.main`` with --trace, --profile-dir and
    --checkpoint on the sim, population and async paths (the kernel
    backend): each trace validates, the report renders every section
    the run feeds, the profile directory holds a trace and the
    checkpoint restores bit-equal; then the sim run untraced, for its
    wall time."""
    import shutil

    from repro_torch import checkpoint
    from repro_torch.launch import train
    from repro_torch.obs import report
    from repro_torch.obs.trace import validate_file

    base = ["--device", dev.type, "--backend", "kernel", "--compressor",
            POP_SPEC, "--seq", "16", "--batch-per-client", "1",
            "--local-steps", "1"]
    paths = (
        ("sim", ["--clients", "4", "--rounds", "4", "--eval-every", "2"],
         ("uplink byte waterfall", "time breakdown", "eval_loss",
          "claims-ready rows")),
        ("population", ["--population", "100000", "--cohort", "4",
                        "--store-capacity", "6", "--eviction", "sketch",
                        "--rounds", "3"],
         ("uplink byte waterfall", "residual store", "time breakdown",
          "claims-ready rows")),
        ("async", ["--async", "--clients", "4", "--buffer-size", "2",
                   "--rounds", "6"],
         ("uplink byte waterfall", "staleness histogram", "buffer flushes",
          "time breakdown", "claims-ready rows")),
    )
    tmp = scratch_dir("phase12-")
    try:
        for name, argv, sections in paths:
            trace = os.path.join(tmp, f"{name}.jsonl")
            prof = os.path.join(tmp, f"{name}-profile")
            ckpt = os.path.join(tmp, f"{name}.npz")
            t0 = time.perf_counter()
            state, ms = train.main(base + argv + [
                "--trace", trace, "--profile-dir", prof, "--checkpoint",
                ckpt])
            secs = time.perf_counter() - t0
            recs = validate_file(trace)
            kinds = [r["kind"] for r in recs]
            if kinds.count("round") != int(argv[argv.index("--rounds")
                                                + 1]):
                fail(f"cli {name}: {kinds.count('round')} round records")
            if kinds.count("stages") != 1 or "checkpoint" not in kinds:
                fail(f"cli {name}: records {sorted(set(kinds))}")
            text = report.render(report.summarize(recs))
            missing = [s for s in sections if s not in text]
            if missing:
                fail(f"cli {name}: the report lacks {missing}:\n{text}")
            traces = [f for f in os.listdir(prof) if f.endswith(".json")]
            if not traces:
                fail(f"cli {name}: no profiler trace in {prof}")
            back = checkpoint.restore(ckpt, state.params)
            for n, p in state.params.items():
                if not torch.equal(back[n], p):
                    fail(f"cli {name}: checkpoint leaf {n} differs")
            counts = {k: kinds.count(k) for k in sorted(set(kinds))}
            mb = os.path.getsize(os.path.join(prof, traces[0])) / 1e6
            print(f"cli {name}: {len(recs)} records {counts}, valid; the "
                  f"report renders {list(sections)}; profiler trace "
                  f"{traces[0]} ({mb:.1f} MB); checkpoint restores "
                  f"bit-equal ({len(back)} leaves); {secs:.2f}s with the "
                  f"profiler", flush=True)
        for traced in (True, False):
            argv = base + list(paths[0][1])
            if traced:
                argv += ["--trace", os.path.join(tmp, "timed.jsonl")]
            t0 = time.perf_counter()
            train.main(argv)
            torch.cuda.synchronize()
            print(f"cli sim {'traced' if traced else 'untraced'}: "
                  f"{time.perf_counter() - t0:.3f}s wall on {card_line()}",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def llama_telemetry_phase(dev):
    """llama3_2_1b at full width and depth, 2 clients, 2 rounds of EF
    topk+qsgd:4@fused through the kernels: telemetry on against off bit
    for bit, the slots summing to the ledger, the bf16 checkpoint saved,
    restored bit-equal and deleted, the peak memory under 76 GiB."""
    import shutil

    from repro_torch import checkpoint
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch("llama3_2_1b")
    model = Model(cfg)
    fl_kw = dict(uplink_compressor=CHAINS[1])
    print(f"llama3_2_1b telemetry: {model.param_count():,} params, "
          f"{cfg.num_layers} layers (no depth cut), {LLAMA_CLIENTS} clients, "
          f"seq {LLAMA_SEQ}, batch {LLAMA_BATCH}, E=1, {LLAMA_ROUNDS} rounds "
          f"of {fl_kw} backend=kernel", flush=True)
    out, peaks = {}, {}
    for tele in (False, True):
        what = f"llama3_2_1b telemetry={'on' if tele else 'off'}"
        torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts()
        engine, state, ms, recs = tele_run(
            model, fl_kw, "kernel", tele, dev, LLAMA_ROUNDS,
            clients=LLAMA_CLIENTS, seq=LLAMA_SEQ, batch=LLAMA_BATCH,
            local_steps=1)
        ran = {k: v - before[k] for k, v in launch_counts().items()}
        check_launches(ran, ("threshold_sparsify", "qsgd_pack"), what)
        check_finite(ms, state, what)
        check_ledger(engine, ms, LLAMA_CLIENTS, what)
        if tele:
            check_slots(ms["round_stats"], ms["ledger"], what)
        peaks[tele] = torch.cuda.max_memory_allocated(dev) / 2**30
        if peaks[tele] >= LLAMA_PEAK_GIB:
            fail(f"{what}: peak memory {peaks[tele]:.1f} GiB, not under "
                 f"{LLAMA_PEAK_GIB} GiB")
        print(f"{what}: loss per round {fmt(ms['loss'])}, round times "
              f"{fmt(r['secs'] for r in recs)} s; launches "
              f"{ran}; peak memory {peaks[tele]:.2f} GiB (limit "
              f"{LLAMA_PEAK_GIB:.0f}) on {card_line()}", flush=True)
        # on the host, so that the next run's peak is its own
        out[tele] = [t.cpu() for t in tele_tensors(state, ms)]
        if not tele:
            del engine, state, ms
            torch.cuda.empty_cache()
    n = check_pairs(out[False], out[True], "llama3_2_1b telemetry: on vs off")
    del out
    print(f"llama3_2_1b telemetry: on == off bit for bit ({n} tensors); "
          f"{tele_summary(ms['round_stats'])}", flush=True)
    tmp = scratch_dir("phase12b-")
    try:
        path = os.path.join(tmp, "llama.npz")
        t0 = time.perf_counter()
        checkpoint.save(path, state.params)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = checkpoint.restore(path, state.params)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for name, p in state.params.items():
            if back[name].dtype != p.dtype or not torch.equal(back[name], p):
                fail(f"llama3_2_1b checkpoint: leaf {name} differs")
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"llama3_2_1b checkpoint: {size / 1e9:.3f} GB ({cfg.dtype}) saved "
          f"in {save_s:.2f}s, restored bit-equal onto the card in "
          f"{restore_s:.2f}s, deleted; on {card_line()}", flush=True)
    del engine, state, ms
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 13-13c: every model family
# ---------------------------------------------------------------------------

def families_phase(dev):
    """Slice 10's families: each text-only arch's SMOKE config on the sim
    round, the backends bit-identical; the frontend families' loss and
    gradients against the port's CPU run; whisper_base at full size."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.model import Model

    for arch in FAMILY_ARCHS:
        model = Model(get_smoke(arch))
        cfg = model.cfg
        print(f"{arch} SMOKE: {model.param_count():,} params in "
              f"{len(model.defs)} leaves, pattern {cfg.block_pattern} x "
              f"{cfg.num_superblocks}, d_model {cfg.d_model}, experts "
              f"{cfg.num_experts} top-{cfg.experts_per_token}, "
              f"{cfg.dtype}; {FAMILY_CLIENTS} clients, seq {FAMILY_SEQ}, "
              f"batch {FAMILY_BATCH}, E=1, {FAMILY_ROUNDS} rounds of EF "
              f"{FAMILY_SPEC}", flush=True)
        out = {}
        for backend in ("kernel", "jax"):
            what = f"{arch} SMOKE backend={backend}"
            before = launch_counts()
            t0 = time.perf_counter()
            sim, state, ms = run_sim(
                model, dict(uplink_compressor=FAMILY_SPEC), backend,
                FAMILY_CLIENTS, FAMILY_SEQ, FAMILY_BATCH, FAMILY_ROUNDS, dev,
                1, 0.05)
            secs = time.perf_counter() - t0
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            check_launches(ran, ("threshold_sparsify", "qsgd_quantize")
                           if backend == "kernel" else (), what)
            losses = check_finite(ms, state, what)
            check_ledger(sim, ms, FAMILY_CLIENTS, what)
            print(f"{what}: loss per round {fmt(losses)} "
                  f"up={float(ms['ledger'].uplink_wire[0]):,.0f} B/round, "
                  f"ledger == static terms, launches {ran} ({secs:.2f}s)",
                  flush=True)
            out[backend] = (_tensors(state.params)
                            + _tensors(state.comm_state)
                            + list(ms["ledger"].fields().values())
                            + [ms["loss"]])
        n = check_pairs(out["kernel"], out["jax"],
                        f"{arch} SMOKE: kernel vs plain backend")
        print(f"{arch} SMOKE: kernel and plain backends bit-identical ({n} "
              f"tensors: params, EF residuals, ledger, loss)", flush=True)
    for arch in FRONTEND_ARCHS:
        frontend_check(arch, dev)
    whisper_full(dev)


def frontend_batch(cfg, seq, batch, device, seed=0):
    """A seeded batch with the stubbed frontend's embeddings: ``frontend``
    (encdec) or ``patches`` (vlm), which the FL data does not carry."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device=device)
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1),
           "mask": torch.ones((batch, seq), device=device)}
    key, n = (("frontend", cfg.frontend_tokens) if cfg.family == "encdec"
              else ("patches", cfg.num_patches))
    out[key] = torch.randn((batch, n, cfg.d_model), generator=g,
                           device=device).to(cfg.dtype)
    return out


def loss_and_grads(model, params, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, aux = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), aux["xent"].detach(), list(grads)


def frontend_check(arch, dev):
    """``arch``'s SMOKE loss and gradients on the card against the port's
    CPU run of the same params and batch (f32 both)."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.model import Model

    model = Model(get_smoke(arch))
    params = model.init(0, "cpu")
    batch = frontend_batch(model.cfg, FAMILY_SEQ, FAMILY_BATCH, "cpu")
    loss_c, xent_c, grads_c = loss_and_grads(model, params, batch)
    t0 = time.perf_counter()
    loss_d, xent_d, grads_d = loss_and_grads(
        model, {k: v.to(dev) for k, v in params.items()},
        {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    what = f"{arch} SMOKE loss on the card vs the CPU"
    check_pairs([loss_d.cpu(), xent_d.cpu()], [loss_c, xent_c], what,
                rtol=FRONTEND_LOSS_RTOL)
    worst = 0.0
    for name, gd, gc in zip(params, grads_d, grads_c):
        gd = gd.cpu().double()
        if not bool(torch.isfinite(gd).all()) or not bool(torch.allclose(
                gd, gc.double(), rtol=FRONTEND_GRAD_RTOL,
                atol=FRONTEND_GRAD_ATOL)):
            fail(f"{what}: gradient {name} differs (max abs err "
                 f"{float((gd - gc.double()).abs().max())})")
        worst = max(worst, float((gd - gc.double()).abs().max()))
    print(f"{what}: {model.param_count():,} params, loss "
          f"{float(loss_d):.6f} (CPU {float(loss_c):.6f}, rtol "
          f"{FRONTEND_LOSS_RTOL}), {len(grads_d)} gradients within rtol "
          f"{FRONTEND_GRAD_RTOL} / atol {FRONTEND_GRAD_ATOL} (max abs err "
          f"{worst:.3g}); {secs:.2f}s on the card", flush=True)


def whisper_full(dev):
    """whisper_base at full size (bf16): one loss and gradient at its
    1,500 frames."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch("whisper_base")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(0, dev)
    batch = frontend_batch(cfg, WHISPER_SEQ, WHISPER_BATCH, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, xent, grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    what = "whisper_base full size"
    if not (bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)):
        fail(f"{what}: non-finite loss or gradients")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"{what}: {model.param_count():,} params in {len(model.defs)} "
          f"leaves ({cfg.num_layers} decoder + {cfg.encoder_layers} encoder "
          f"layers, no cut, {cfg.dtype}), frontend {cfg.frontend_tokens} "
          f"frames, seq {WHISPER_SEQ}, batch {WHISPER_BATCH}: loss "
          f"{float(loss):.4f}, {len(grads)} finite gradients in "
          f"{secs:.2f}s, peak memory {peak:.2f} GiB on {card_line()}",
          flush=True)
    del params, grads
    torch.cuda.empty_cache()


def fused_chain_kernels(model, fraction=0.05, block=2048):
    """The kernels the kernel backend runs for EF ``topk:<fraction>>>
    qsgd:4@fused``: #1 on every leaf, #3 on each carrier whose adapted
    QSGD block (``min(block, k)``) is even, and #2 on the odd ones (which
    then pack in PyTorch)."""
    from repro_torch.compress.sparsification import _k

    odd = any(min(block, _k(n, fraction)) % 2 for n in model.param_sizes())
    return ("threshold_sparsify", "qsgd_pack") + \
        (("qsgd_quantize",) if odd else ())


def full_run_model(tag):
    """The Model of a FULL_RUNS row (defs only, nothing allocated), its
    depth cut where the row says, and the row."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    row = next(r for r in FULL_RUNS if r[0] == tag)
    cfg = get_arch(row[1])
    if row[2] is not None:
        cfg = dataclasses.replace(cfg, num_layers=row[2])
    return Model(cfg), row


def moe_probe(model, params, tokens):
    """The routing of superblock 0's ``attn+moe`` entry over ``tokens`` (C,
    B, S) at ``params``, each sequence on its own, through the model's own
    layer functions up to the MoE's input: the share of routed (token,
    expert) pairs past capacity and the busiest expert's demand in one
    sequence, for the MoE's input and for the embeddings routed alone
    (without the attention branch); the attention branch's output norm
    over the embedding's (mean over positions); and the mean cosine
    between two positions' normed inputs in a sequence, both ways."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import model as MM

    cfg = model.cfg
    if cfg.block_pattern[0] != "attn+moe":
        fail(f"moe_probe: pattern {cfg.block_pattern} has no attn+moe first")
    p = MM._index(MM._subtree(params, "layers."), 0)["b0"]
    seqs = tokens.reshape(-1, tokens.shape[-1])
    S = seqs.shape[1]

    def routing(x):
        h = L.rmsnorm(x, p["ffn"]["ln"], cfg.norm_eps)
        _, _, sel, _, keep = L.moe_route(h, p["ffn"]["router"], cfg)
        routed = sel.sum(2) > 0                                  # (N,S,E)
        hn = F.normalize(h.float(), dim=-1)
        cos = (hn @ hn.transpose(1, 2)).sum((1, 2)) - S          # off-diag
        return (float((routed & ~keep).sum() / routed.sum()),
                int(routed.sum(1).max()), float(cos.mean() / (S * (S - 1))))

    with torch.no_grad():
        x = params["embed"].index_select(0, seqs.reshape(-1)).reshape(
            *seqs.shape, cfg.d_model)
        y = MM._self_attention(p["mixer"], x, cfg,
                               torch.arange(S, device=x.device), causal=True,
                               window=cfg.sliding_window, use_rope=True)
        ratio = float(((y - x).float().norm(dim=-1)
                       / x.float().norm(dim=-1)).mean())
        return routing(y), routing(x), ratio


def moe_line(probe, capacity, when):
    (drop, demand, cos), (drop_e, demand_e, cos_e), ratio = probe
    return (f"{when}: {100 * drop:.2f}% of the routed (token, expert) pairs "
            f"dropped past capacity {capacity}, the busiest "
            f"expert asked for {demand} tokens of a sequence, mean cosine "
            f"between two positions' MoE inputs {cos:.4f}; the attention "
            f"branch's output {ratio:.2f}x the embedding in norm; the "
            f"embeddings routed alone: {100 * drop_e:.2f}% dropped, demand "
            f"{demand_e}, cosine {cos_e:.4f}")


def full_width_phase(dev, tag):
    """A FULL_RUNS row at full width through the kernels (``wide_phase``);
    for an MoE, the routing at the init and at the final params."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import sample_round
    from repro_torch.models.layers import moe_capacity

    model, (_, arch, layers, clients, seq, batch, rounds) = \
        full_run_model(tag)
    cfg = model.cfg
    cut = (f"cut to {layers} of {get_arch(arch).num_layers} layers, full "
           f"width" if layers is not None else "no depth cut")
    what = f"{arch} ({tag}, {cut})"
    inspect = None
    if cfg.num_experts:
        cap = moe_capacity(cfg, seq)
        desc = (f", {cfg.num_experts} experts top-{cfg.experts_per_token} "
                f"d_ff {cfg.d_ff}, capacity {cap} an expert")
        data = fed_data(model, clients, seq, batch)
        init = moe_probe(model, model.init(0, dev),
                         sample_round(data, 0, dev)["tokens"])
        print(f"{what}: " + moe_line(init, cap, "at the init on round 0's "
                                     "batch"), flush=True)
        inspect = lambda params: print(f"{what}: " + moe_line(
            moe_probe(model, params, sample_round(
                data, rounds - 1, dev)["tokens"]), cap,
            "at the final params on the last round's batch"), flush=True)
    else:
        desc = (f", d_state {cfg.ssm_state}, {cfg.ssm_heads} heads of "
                f"{cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    print(f"{what}: {model.param_count():,} params in {len(model.defs)} "
          f"leaves (largest {max(model.param_sizes()):,}), d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}{desc}, {cfg.dtype}; "
          f"{clients} clients, seq {seq}, batch {batch}, E=1, {rounds} "
          f"rounds of EF {FULL_SPEC} backend=kernel", flush=True)
    wide_phase(dev, model, dict(uplink_compressor=FULL_SPEC),
               fused_chain_kernels(model), what, clients, seq, batch,
               rounds, inspect)


def print_profile(prof, wall_s, what, top=10):
    """The device's busy share of the profiled run's wall time (the sum of
    its kernel and copy events), then device time by the operator that
    launched it (``torch.profiler``; the ctypes-launched kernels of this
    port appear under their own kernel names)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    # the store's profiler ranges also appear as GPU-side spans (idle gaps
    # included): not device work
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.key not in STORE_RANGES]
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
    for e in events:
        if e.key in STORE_RANGES and \
                e.device_type != torch.autograd.DeviceType.CUDA:
            ms = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0)) / 1e3
            print(f"  {ms:9.2f} ms  {e.count:6d} calls   {e.key} (device "
                  f"time under the range, {100 * ms / max(busy_ms, 1e-9):.1f}"
                  f"% of the device time)")


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

    t0 = time.perf_counter()
    kern = check_kernels(dev)
    stc_first_rounds(dev)
    sketch_first_rounds(dev)
    print(f"kernel checks and round-1 comparisons done in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

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
                                        "EF sketch>>qsgd:8"),
                  population_phase, eviction_phase, llama_population_phase,
                  algorithms_phase,
                  lambda d: llama_algorithm_phase(d, "7b"),
                  lambda d: llama_algorithm_phase(d, "7c"),
                  selection_phase, async_phase, llama_async_phase,
                  privacy_phase, llama_privacy_phase, scenario_phase,
                  telemetry_phase, llama_telemetry_phase, families_phase,
                  lambda d: full_width_phase(d, "13b"),
                  lambda d: full_width_phase(d, "13c")):
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        phase(dev)
        print(f"phase done in {time.perf_counter() - t0:.1f}s", flush=True)
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
