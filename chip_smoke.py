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
     widths, bound by its INT32 hash work, one launch of thread-block
     clusters) runs at n = 3001, an unaligned view, 10 rows (two row
     groups) and rows of 70,000 columns (column tiles, several clusters);
     each of its shapes prints its cluster size, clusters, CTAs and the
     kernels a call launches (``torch.profiler``), which must be the plan's
     launches, and one at every paper_lm leaf;
  4. slice 1's path: paper_lm at full width, 8 clients, 2 sim rounds of
     EF ``topk:0.05>>qsgd:8`` and ``topk:0.05>>qsgd:4@fused``, each with
     ``backend="kernel"`` and with the plain backend on the card — params,
     EF residuals and ledgers must be bit-identical between the two;
  4b. slice 2's path: paper_lm at full width, 8 clients, on both backends,
     of EF ``stc`` (0.01) with an ``lfl8`` downlink, EF ``stc:0.1@fused``,
     EF ``topk:0.1>>ternary@fused`` and DGC ``topk`` (0.01, momentum 0.9).
     First, outside the counted phases, round 1 from one state gives
     identical codes, supports, downlinked params and ledger on both
     backends, mu within rtol 1e-5 (DGC: identical rows); then 2
     free-running rounds of each, whose losses are printed with their
     largest relative gap (DGC: bit-identical runs);
  4c. slice 3's path: paper_lm at full width, 8 clients, E=2, lr 0.1, on
     both backends, of the reference's FetchSGD runs: EF ``sketch``
     (top-k fraction 0.1) and EF ``sketch>>qsgd:8``.  First, outside the
     counted phases, round 1 from one state gives identical deltas,
     losses and ledger on both backends and every client's sketch within
     phase 3's tolerance, and prints the overlap of the decoded supports;
     then 2 free-running rounds of each, whose losses may differ by a
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
     The last round of each kernel run of phases 4-5 goes under
     ``torch.profiler`` (5b and 5c, like the other large models' phases,
     run without it: summarising their traces took longer than the
     rounds), which prints the device's busy share and device
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
     store under ``drop`` and under ``sketch`` (a 5 x 16384 tail), 4
     rounds on both backends: the store's ``stats()`` equal to the hits,
     misses and evictions its slots show, the tail non-zero once round 1
     has evicted and its norm never rising across a gather, the backends
     bit-identical under ``drop`` and their losses within 1e-3 (4c's
     tolerance) under ``sketch``;
  6c. llama3_2_1b at full width and depth over 1,000,000 clients, cohorts
     of 2, a 2-slot store under ``sketch``, EF ``topk:0.05>>qsgd:4@fused``,
     2 rounds through the kernels: finite losses, the second round
     evicting 2 rows and recovering 2, and the peak memory under 76 GiB.
     Phases 6-6c print each run's round times; one kernel run a phase (6:
     1,000,000 clients, 6b: ``sketch``) profiles its last round for the
     device busy share, top device ops and the store's share of device
     time (6c's 10 s rounds, like 5c's 6 s ones, run without the
     profiler: summarising such a round's trace took longer than the
     round);
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
     phase 7's FedAdam kernel run profiles its last round;
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
     ``resource`` latency, 24 events each; then ``bench_scale``'s async leg
     (100,000 clients, stride cohorts of 16, a 64-slot store, K = 4,
     ``heavy_tail``, 24 events).  Each run prints its event order, flush
     count and final clock; the backends are bit-identical in every state
     tensor and metric;
  9b. llama3_2_1b at full width and depth, async: 2 slots, FedAsync (K =
     1) under ``heavy_tail``, EF ``topk:0.05>>qsgd:4@fused``, seq 128,
     batch 1, E=1, 6 events through the kernels: finite losses, a flush
     every event, the peak memory under 76 GiB with the hop that last
     raised it and each event's time;
  10. slice 8's privacy wire on paper_lm (8 clients, seq 32, batch 2,
     E=2, 2 rounds): each of the reference's ``PRIVACY_CASES`` (``qsgd:4``,
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
     clients, 2 rounds, EF ``topk:0.05>>qsgd:4@fused``, a square trace at
     duty 0.5, dropout 0.3, epoch scale 0.5 at E=4), 6b's population
     under ``drop`` and ``sketch`` (3 rounds), phase 9's FedBuff K = 4
     ``heavy_tail`` run and its population leg over 100,000 clients (24
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
     times and the launches of #1 and #3 beside the card's name and power
     limit (no round under the profiler);
  14. serving on the card: for every text-only arch's ``SMOKE`` config
     and ``whisper_base``'s (its ``enc`` cache filled by
     ``encode_cross_kv``), decode token by token equals the port's own
     forward logits within 5e-3; a window-4 ring buffer within 2e-3 (its
     slot positions checked), the int8 KV cache within 0.05; Jamba's
     ``SMOKE`` loss and gradients bit-identical with remat on and off;
     then ``serve.main`` on paper_lm (batch 4, prompt 16, 32 steps, cache
     128) prints its telemetry;
  14b. serving at full width: llama3_2_1b uncut decoding 64 steps at
     ``decode_32k``'s 32,768-slot cache, batch 8 (the shape's 128 would
     hold 128 GiB of bf16 KV), with the bf16 and the int8 cache (mean
     and p95 ms a step, tokens/s, the cache's bytes, the bytes a step
     moves and their floor at 3.35 TB/s, peak memory, one step under the
     profiler); ``long_500k``'s 8,192-slot ring buffer at batch 1 across
     the wrap at 524,288, every slot's position checked; ``prefill_32k``'s
     32,768 positions at batch 1 (of 32); ``mamba2_370m`` uncut, 64 steps
     at batch 8.  Phases 14 and 14b launch none of the eight kernels;
  14c. ``train_4k``: llama3_2_1b uncut at seq 4,096, batch 1 on each of 2
     clients, 2 rounds of EF ``topk:0.05>>qsgd:4@fused`` through the
     kernels with remat on (the config's), peak under 76 GiB, no round
     under the profiler (its trace takes a minute to summarise); then what a
     layer keeps for the backward with remat off, on a 1-layer cut, and
     whether 16 such layers fit the card;
  15. slice 12's topologies over ``torch.distributed``, each client a rank
     (``repro_torch.launch.mesh.run_ranks``, spawned after the kernels are
     built; one card cannot hold two NCCL ranks of one communicator, so
     the ranks share ``cuda:0`` over gloo, which stages each collective
     through the host).  One group of 4 ranks runs 15, 15c and 15d, each
     rank counting its kernel launches per phase from 0 and reporting
     them to this process.  15: the star on paper_lm (phase 4's batch),
     3 rounds on each backend of the identity FedSGD wire, EF
     ``topk:0.05>>qsgd:4@fused``, ``ternary@fused``, SCAFFOLD on
     ``qsgd:8`` and the EF chain ``>>secagg``: every rank's wire operands
     its payload (``payload_nbytes``), the ranks' sum the ledger's
     uplink (in its own float32 arithmetic; SCAFFOLD's billed twice,
     its dense control f32 beside it), the packed wire uint8 with no int8
     or f32 code plane, the staged QSGD wire int8, only the identity wire
     an f32 all-reduce; the backends bit-identical (the ternary chain at
     engine scope: its kernel sums mu in another order) and the masked
     chain equal to the clear one;
  15b. llama3_2_1b uncut, 2 ranks sharing the card over gloo, one client
     each, 2 rounds of EF ``topk:0.05>>qsgd:4@fused`` through the
     kernels: each rank's peak memory, round times, the share of each
     round in the collective wrapper and the gathered bytes, beside the
     card's name and power limit;
  15c. hier at pod 2 x data 2 on paper_lm, ``qsgd:8`` on the edge and the
     pod hop, the cloud hop every 2nd of 4 rounds, telemetry on:
     ``pod_divergence`` 0 after cloud rounds, edge bytes equal to
     ``edge_wire`` every round and each data index's pod group's bytes
     to ``cloud_wire`` on cloud rounds, the telemetry pod slot 0 on edge
     rounds and ``cloud_wire`` on cloud rounds, the backends
     bit-identical;
  15d. gossip on paper_lm, 4 ranks: the ring and ``expander_graph(4)``,
     each on ``qsgd:8`` and EF ``topk:0.25>>qsgd:8``, 5 rounds from
     per-node perturbed params: the consensus below 0.7x its first value,
     the mix bytes ``mix_wire`` every round, the backends bit-identical;
  15e. ``repro_torch.launch.train.main`` with ``--nproc 1 --dist-backend
     nccl`` for the star and ``--hierarchical`` (pod 1 x data 1): the
     NCCL path built and run on the card (its rank's launches stay in its
     process);
  15f. in 15's group, the star over a ``ClientPopulation``, every rank a
     replica of the residual store: n = cohort = capacity = 4 against the
     dense star, 12 clients into 8 slots under ``drop``, 10^6 under
     ``sketch``, the 12 at availability 0.75 under the diurnal trace;
     store digests equal on every rank every round, the ``store`` hop one
     f32 EF row a rank a round, the backends bit-identical;
  15g. in 15's group, ``train.main`` with ``--nproc 4`` in each rank and
     ``--trace``, ``--profile-dir`` and ``--checkpoint`` (star and hier):
     each trace validated and rendered, the checkpoint restored
     bit-equal, the params equal to the untraced run's;
  15h. in 15's group, the star on a model axis (``MODEL_AXIS_MESH``,
     data 2 x model 2: rank r is client r // 2's model rank r % 2,
     training the client's whole update and encoding its block of every
     leaf), 3 rounds on each backend of the identity FedSGD wire, EF
     ``topk:0.05>>qsgd:8``, EF ``topk:0.05>>qsgd:4@fused``,
     ``ternary@fused``, SCAFFOLD on ``qsgd:8``, the fused chain
     ``>>secagg`` and a population of 6 clients, cohort 2, 4 slots under
     ``drop``: params (and the store replicas) bit-equal on all 4 ranks
     after every round, each rank's wire operand its blocks' payload, the
     ``model`` rebuild hop and SCAFFOLD's ``dense`` hop its f32 blocks,
     the ledger the whole leaves' terms (the gap to the ranks' wire sum
     printed), the backends bit-identical (ternary at engine scope), the
     masked chain equal to the clear one, and the identity run equal to
     the same rounds at data 2 x model 1 (the sim over 2 clients);
  15i. in 15b's group, after its rounds: llama3_2_1b uncut as one client
     at data 1 x model 2, 2 rounds of EF ``topk:0.05>>qsgd:4@fused``
     through the kernels: each rank's peak memory, round times,
     collective share and bytes by hop, params bit-equal on both ranks
     every round;
  16. the ``kernels`` JSON line: launch counts are those of the main-path
     phases (4, 4b, 4c, 4d, 5, 5b, 5c, 6, 6b, 6c, 7, 7b, 7c, 8, 9, 9b, 10,
     10b, 11, 12, 12b, 13, 13b, 13c, 14, 14b, 14c, 15, 15b, 15c, 15d, 15f,
     15g, 15h, 15i),
     each counted from 0 just before its phase (the count sketch's by
     path too, each of which must launch); the pack and unpack kernels are
     on no path and count their phase-3 calls;
  17. last line: ``{"ok": true, "device": {...}}``.

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

PAPER_LM_CLIENTS, PAPER_LM_SEQ, PAPER_LM_BATCH, PAPER_LM_ROUNDS = 8, 32, 2, 2
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
EVICT_POP = (192, 24, 32, 4)
LLAMA_POP = dict(n_clients=1_000_000, cohort=2, capacity=2,
                 eviction="sketch", spec="topk:0.05>>qsgd:4@fused", rounds=2)
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
ASYNC_SLOTS, ASYNC_SEQ, ASYNC_BATCH, ASYNC_EVENTS = 8, 48, 4, 24
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
# slice 11's serving: decode against the forward on every text-only arch's
# SMOKE config and whisper_base's (its encoder's keys and values in the
# cache), at the reference's limits (tests/test_models.py:77, :111, :220);
# a capacity factor no token overflows, so that a MoE routes the forward's
# tokens as it routes the decode's one (the reference's test configs' 8.0)
SERVE_ARCHS = ("paper_lm", "llama3_2_1b") + FAMILY_ARCHS + ("whisper_base",)
SERVE_SEQ, SERVE_BATCH, SERVE_CAPACITY = 16, 2, 8.0
DECODE_TOL, RING_TOL, INT8_TOL = 5e-3, 2e-3, 0.05
RING_ARCH, RING_WINDOW = "llama3_2_1b", 4
REMAT_ARCH = "jamba_1_5_large_398b"       # Mamba, attention and MoE
SERVE_CLI = ["--batch", "4", "--prompt-len", "16", "--steps", "32",
             "--cache-len", "128"]
# phase 14b at full width: decode_32k's cache at batch 8 of its 128 (128 x
# 32,768 tokens x 32 KiB of bf16 KV a token is 128 GiB, over one card's
# 80 GB), long_500k's ring buffer at its batch 1, prefill_32k at batch 1
# of its 32
FULL_DECODE_BATCH, FULL_DECODE_STEPS = 8, 64
RING_STEPS_BEFORE_WRAP = 32
PREFILL_BATCH = 1
# phase 14c: train_4k's sequence, batch 1 on each of 2 clients (the
# shape's global batch is 256), attention and cross-entropy in chunks of
# 512 (the round engine's default, the reference dry-run's)
TRAIN4K_CLIENTS, TRAIN4K_BATCH, TRAIN4K_CHUNK, TRAIN4K_ROUNDS = 2, 1, 512, 2
# slice 12's topologies: one client a rank, every rank on the card over
# gloo (NCCL cannot put two ranks of one communicator on one card);
# (label, FLConfig knobs, kernels of the kernel backend)
RANK_TIMEOUT_S = 300             # the process group's; a hung rank fails
TOPO_RANKS, TOPO_ROUNDS = 4, 3
TOPO_FL = dict(local_steps=2, local_lr=0.2)
STAR_CHAINS = (
    ("fedsgd identity", dict(algorithm="fedsgd", local_steps=1,
                             uplink_compressor="none"), ()),
    ("EF topk:0.05>>qsgd:4@fused",
     dict(uplink_compressor="topk:0.05>>qsgd:4@fused"),
     ("threshold_sparsify", "qsgd_quantize", "qsgd_pack")),
    ("ternary packed", dict(uplink_compressor="ternary@fused"),
     ("ternarize_pack",)),
    ("SCAFFOLD qsgd:8", dict(algorithm="scaffold",
                             uplink_compressor="qsgd:8"),
     ("qsgd_quantize",)),
)
STAR_MASKED = ("EF topk:0.05>>qsgd:4@fused>>secagg",
               dict(uplink_compressor="topk:0.05>>qsgd:4@fused>>secagg"),
               ("threshold_sparsify", "qsgd_quantize", "qsgd_pack"))
HIER_FL = dict(uplink_compressor="qsgd:8", pod_compressor="qsgd8",
               sync_every=2, telemetry=True)
HIER_ROUNDS, GOSSIP_ROUNDS = 4, 5
GOSSIP_RUNS = (("ring", "qsgd:8", ("qsgd_quantize",)),
               ("ring", "topk:0.25>>qsgd:8",
                ("threshold_sparsify", "qsgd_quantize")),
               ("expander", "qsgd:8", ("qsgd_quantize",)),
               ("expander", "topk:0.25>>qsgd:8",
                ("threshold_sparsify", "qsgd_quantize")))
LLAMA_STAR = dict(uplink_compressor="topk:0.05>>qsgd:4@fused")
# phase 15f: the star over a population on the same 4 ranks, each run on
# both backends: (label, ClientPopulation knobs, FLConfig knobs, kernels
# the kernel backend runs).  Population seed 2 draws cohorts of 12
# clients that hit, miss and evict within 4 rounds at capacity 8.
POP_STAR_ROUNDS = 4
POP_STAR_DEGENERATE = dict(n_clients=4, cohort=4, capacity=4)
POP_STAR_RUNS = (
    ("b drop 12/4/8", dict(n_clients=12, cohort=4, capacity=8,
                           eviction="drop", seed=2),
     dict(uplink_compressor=CHAINS[0]),
     ("threshold_sparsify", "qsgd_quantize")),
    ("c sketch 1M/4/8", dict(n_clients=1_000_000, cohort=4, capacity=8,
                             eviction="sketch"),
     dict(uplink_compressor=CHAINS[1]),
     ("threshold_sparsify", "qsgd_quantize", "qsgd_pack")),
    ("d diurnal 0.75 12/4/8", dict(n_clients=12, cohort=4, capacity=8,
                                   eviction="drop", seed=2,
                                   availability=0.75),
     dict(uplink_compressor=CHAINS[0], scenario_trace="diurnal"),
     ("threshold_sparsify", "qsgd_quantize")),
)
# phase 15g: the train CLI's ranks with --trace, --profile-dir and
# --checkpoint (star, then hier at pod 2 x data 2)
CLI_RANK_RUNS = (("star", []),
                 ("hier", ["--hierarchical", "--sync-every", "2"]))
CLI_RANK_KERNELS = ("threshold_sparsify", "qsgd_quantize", "qsgd_pack")
# phase 15h: the star on a model axis, data 2 x model 2 on the same 4
# ranks, each rank encoding its block of every leaf: (label, FLConfig
# knobs, kernels the kernel backend may launch, kernels it must launch;
# a block's top-k carrier may be odd, which the unpacked QSGD kernel
# quantizes under @fused)
MODEL_AXIS_MESH = {"data": 2, "model": 2}
MODEL_AXIS_ROUNDS = 3
_FUSED = ("threshold_sparsify", "qsgd_quantize", "qsgd_pack")
MODEL_AXIS_CHAINS = (
    ("fedsgd identity", dict(algorithm="fedsgd", local_steps=1,
                             uplink_compressor="none"), (), ()),
    ("EF topk:0.05>>qsgd:8", dict(uplink_compressor=CHAINS[0]),
     ("threshold_sparsify", "qsgd_quantize"),
     ("threshold_sparsify", "qsgd_quantize")),
    ("EF topk:0.05>>qsgd:4@fused", dict(uplink_compressor=CHAINS[1]),
     _FUSED, ("threshold_sparsify", "qsgd_pack")),
    ("ternary packed", dict(uplink_compressor="ternary@fused"),
     ("ternarize_pack",), ("ternarize_pack",)),
    ("SCAFFOLD qsgd:8", dict(algorithm="scaffold",
                             uplink_compressor="qsgd:8"),
     ("qsgd_quantize",), ("qsgd_quantize",)),
    ("EF topk:0.05>>qsgd:4@fused>>secagg",
     dict(uplink_compressor=CHAINS[1] + ">>secagg"), _FUSED,
     ("threshold_sparsify", "qsgd_pack")),
)
MODEL_AXIS_POP = ("drop 6/2/4", dict(n_clients=6, cohort=2, capacity=4,
                                     eviction="drop"),
                  dict(uplink_compressor=CHAINS[0]),
                  ("threshold_sparsify", "qsgd_quantize"),
                  ("threshold_sparsify", "qsgd_quantize"))
# the CUDA entry points of kernels/csrc, as the profiler names them
OUR_KERNELS = ("threshold_sparsify_vec4", "threshold_sparsify_scalar",
               "qsgd_quantize_rows", "qsgd_pack_rows", "ternarize_rows",
               "ternarize_pack_rows", "pack_codes_words",
               "unpack_codes_words", "count_sketch_fold",
               "count_sketch_unfold", "count_sketch_scatter",
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
    small shapes ``cuda_ms`` times the host's launch rate instead.  Also
    returns the device events (kernel launches) a call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel, events = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            name = re.search(r"(\w+)(<[^>]*>)?\(", e.key)
            name = name.group(1) if name else e.key
            by_kernel[name] = by_kernel.get(name, 0.0) + us / reps / 1e3
            events += e.count
    return sum(by_kernel.values()), by_kernel, events / reps


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


def sketch_shapes(leaves):
    """Phase 3's count-sketch shapes: (n, rows[, cols]), "u" marking an
    unaligned view (x[1:]); the explicit widths take the other plans (the
    spec grammar allows any sketch:r,c)."""
    return ([(n, r) for r in (3, 5) for n in leaves]
            + [(3001, 5), ("u5001", 5), ("u65536", 5), (300_000, 5),
               (5000, 5, 4096), (80, 5), (5000, 10, 500),
               (100_000, 10, 4096), (500_000, 2, 70_000),
               (600_000, 2, 131_072), (LLAMA_W_UP, 5)])


def check_count_sketch(leaves, g, dev):
    """Kernel #6 against its plain version, all shapes with the same hash
    parameters per row count: ``|S - S_plain| <= SKETCH_TOL * M + 1e-30``
    elementwise, M the bucket mass.  The fold path (power-of-two widths)
    runs at the paper_lm leaves of 65,536 elements and more, an unaligned
    view, a ragged n, n below 2 * cols, 8 columns, 10 rows in one fold,
    131,072 columns and w_up (5 x 4096); two launches on one input must be
    bit-identical there.  The scatter path runs at the other paper_lm
    leaves (rows 3 and 5), n = 3001, an unaligned view, 10 rows (two row
    groups) and rows of 70,000 columns (column tiles, 8 clusters); its
    relaunches are compared and printed (the order of the shared-memory
    atomics may vary).  Each scatter shape prints its plan (cluster size,
    clusters, CTAs) and the kernels a call launches, from
    ``torch.profiler``: the plan's launches, one at every paper_lm leaf.
    A source tree without ``device_plan`` (one older than the cluster
    launch, timed against this one by ``scripts/chip_phases.py``) prints
    its launches unheld.  Returns the fold path's w_up row with both
    paths' rows under ``paths``."""
    from repro_torch.compress.sketch import CountSketch, hash_params
    from repro_torch.kernels import count_sketch as cs

    worst, worst_abs, largest, paths = 0.0, 0.0, {}, {}
    same_by_path = {"fold": True, "scatter": True}
    planned = hasattr(cs, "device_plan")
    for n, rows, *width in sketch_shapes(leaves):
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
        plan = (cs.device_plan(x.device.index, n, rows, cols)
                if planned and path == "scatter" else None)
        dev_ms, split, per_call = device_ms(kern, 10 if big else 50)
        # torch.profiler now and then drops a tiny shape's events (never
        # adds one): a count below the plan's is profiled again, at most
        # twice, and the largest count stands
        profiles = 1
        while plan is not None and per_call < plan.launches and profiles < 3:
            again = device_ms(kern, 10 if big else 50)
            profiles += 1
            if again[2] > per_call:
                dev_ms, split, per_call = again
        row = dict(n=f"{label} x {rows}x{cols}", ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bytes_bound_ms=byte_ms,
                   bound_by="bytes" if byte_ms >= op_ms else "operations",
                   device_ms=dev_ms, device_ms_by_kernel=split,
                   launches_per_call=per_call)
        bounds = f"bytes {byte_ms:.4f}"
        plan_note = ""
        if path == "scatter":
            row["int32_bound_ms"] = op_ms
            bounds += f", INT32 {op_ms:.4f}"
            plan_note = "; plan n/a (no device_plan in this tree)"
            if plan is not None:
                row.update(cluster=plan.cluster, clusters=plan.clusters,
                           ctas=plan.ctas)
                plan_note = (f"; cluster {plan.cluster} x {plan.clusters} "
                             f"clusters = {plan.ctas} CTAs of {plan.span} "
                             f"elements, {plan.smem} B shared")
                if per_call != plan.launches:
                    fail(f"count_sketch n={label} rows={rows} cols={cols}: "
                         f"{per_call} kernels a call, the plan has "
                         f"{plan.launches}")
                if n in leaves and per_call != 1:
                    fail(f"count_sketch n={label} rows={rows} cols={cols}: a "
                         f"paper_lm leaf takes {per_call} kernels a call")
        print(f"kernel count_sketch/{path:7s} n={label!s:>20} rows={rows} "
              f"cols={cols} err/mass={ratio:.2e} relaunch bit-identical="
              f"{'yes' if same else 'no'} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} device_ms={dev_ms:.4f} ("
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f") kernels/call={per_call:g}"
              + (f" (the most of {profiles} profiles)" if profiles > 1
                 else "")
              + f" bound_ms={bound_ms:.4f} "
              f"({bounds}; {100 * bound_ms / ms:.0f}% of bound){plan_note}",
              flush=True)
        if n >= largest.get(path, 0):        # each path's largest shape
            largest[path], paths[path] = n, row
        del x, S, S2, P, M
    print(f"count_sketch: {len(sketch_shapes(leaves))} shapes within "
          f"{SKETCH_TOL} of the bucket mass (worst ratio {worst:.3e}); two "
          f"launches on one input bit-identical at every fold-path shape: "
          f"yes, at every scatter-path shape: "
          f"{'yes' if same_by_path['scatter'] else 'no'}", flush=True)
    return dict(paths["fold"], max_abs_err=worst_abs,
                sketch_err_over_mass=worst,
                relaunch_bit_identical=same_by_path, paths=paths)


def count_sketch_phase(dev):
    """Phase 3's count-sketch shapes alone, for ``scripts/chip_phases.py``
    (which can point it at another source tree with ``--src``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    check_count_sketch(sorted(set(Model(get_arch("paper_lm")).param_sizes())),
                       g, dev)


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
            local_steps, local_lr, peak_log=None, prof_out=None, times=None,
            chunk=None):
    """``rounds`` sim rounds; with a ``prof_out`` dict the last round runs
    under ``torch.profiler`` (a whole run's trace takes longer to
    summarise than the run) and ``prof_out`` gets the profiler and the
    round's wall time; a ``times`` list gets every round's wall time, each
    round synchronised with the card.  The model's attention and
    cross-entropy chunk is ``chunk`` (default ``seq``, the train CLI's)."""
    from repro_torch.core.engine import run_rounds
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import sample_round

    fl = FLConfig(backend=backend, local_steps=local_steps,
                  local_lr=local_lr, **fl_kw)
    sim = make_sim_step(model, fl, clients, chunk=chunk or seq, device=dev)
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


def llama_phase(dev, fl_kw, expect, what, profile=True):
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
               LLAMA_CLIENTS, LLAMA_SEQ, LLAMA_BATCH, LLAMA_ROUNDS,
               profile=profile)


def wide_phase(dev, model, fl_kw, expect, what, clients, seq, batch, rounds,
               inspect=None, chunk=None, profile=True):
    """A full-width model's sim rounds through the kernels, E=1 at lr 0.05,
    the last round under ``torch.profiler`` (unless ``profile`` is False:
    summarising a long round's trace takes a minute): finite losses and
    params, the ledger equal to its static terms, the kernels of
    ``expect`` launched and no other, the peak memory under
    LLAMA_PEAK_GIB.  Prints the round times, the peak and the last round's
    busy share; ``inspect(params)`` (optional) then reads the final
    params."""
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    peak_log, prof, times = {}, {} if profile else None, []
    sim, state, ms = run_sim(model, fl_kw, "kernel", clients, seq, batch,
                             rounds, dev, 1, 0.05, peak_log=peak_log,
                             prof_out=prof, times=times, chunk=chunk)
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
          f"{', '.join(f'{t:.3f}' for t in times)} s"
          f"{' (the last under the profiler)' if profile else ''}, "
          f"up={float(ms['ledger'].uplink_wire[0]):,.0f} B/round "
          f"down={float(ms['ledger'].downlink_wire[0]):,.0f} B/round, "
          f"ledger == static terms, launches {ran}, peak memory {peak:.2f} "
          f"GiB (limit {LLAMA_PEAK_GIB:.0f}; last raised in the "
          f"{peak_log.get('hop', 'init')} hop) on {card_line()}, "
          f"{secs:.2f}s", flush=True)
    if profile:
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
    every round after the first, and the peak memory (no round under the
    profiler: summarising a 10 s round took longer than the round)."""
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
        LLAMA_BATCH, rounds, dev, 1, 0.05)
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
        rounds, eval_every, dev, steps, 0.05)
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
                  0.05)
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


# ---------------------------------------------------------------------------
# phases 14-14c: serving, long sequences and remat
# ---------------------------------------------------------------------------

def text_batch(cfg, seq, batch, device, seed=0):
    """A seeded text batch (and the stubbed frontend's frames for an
    encoder-decoder)."""
    if cfg.family == "encdec":
        return frontend_batch(cfg, seq, batch, device, seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device=device)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1),
            "mask": torch.ones((batch, seq), device=device)}


def decode_error(model, params, batch, cache, window=0):
    """Decodes ``batch``'s tokens one by one from ``cache`` (a Python int
    position); the largest |decode logits - forward logits| over the
    steps, and the cache."""
    from repro_torch.models import model as MM

    cfg = model.cfg
    with torch.no_grad():
        x, _ = MM.forward(params, batch, cfg, chunk=8)
        full = MM.unembed(params, x, cfg)
    err = 0.0
    for t in range(batch["tokens"].shape[1]):
        logits, cache = model.decode(params, cache,
                                     batch["tokens"][:, t:t + 1], t,
                                     window=window)
        err = max(err, float((logits[:, 0] - full[:, t]).abs().max()))
    return err, cache


def serve_parity_phase(dev):
    """Phase 14: decode equals the forward on the card (every text-only
    SMOKE arch and whisper_base's with its ``enc`` cache filled), the
    window-4 ring buffer, the int8 cache, remat on against off bit for
    bit, then ``serve.main`` on paper_lm."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import model as MM
    from repro_torch.models.model import Model

    for arch in SERVE_ARCHS:
        cfg = get_smoke(arch)
        if cfg.num_experts:
            cfg = dataclasses.replace(cfg,
                                      expert_capacity_factor=SERVE_CAPACITY)
        model = Model(cfg)
        params = model.init(0, dev)
        batch = text_batch(cfg, SERVE_SEQ, SERVE_BATCH, dev)
        enc_len = cfg.frontend_tokens if cfg.family == "encdec" else 0
        cache = model.init_cache(SERVE_BATCH, SERVE_SEQ, enc_len=enc_len,
                                 device=dev)
        if enc_len:
            MM.encode_cache(params, cache, batch["frontend"], cfg)
        t0 = time.perf_counter()
        err, _ = decode_error(model, params, batch, cache)
        secs = time.perf_counter() - t0
        if not err < DECODE_TOL:
            fail(f"{arch} SMOKE: decode differs from the forward by {err}")
        print(f"{arch} SMOKE ({cfg.family}, pattern {cfg.block_pattern}, "
              f"{cfg.dtype}): {SERVE_SEQ} decode steps at batch "
              f"{SERVE_BATCH} == forward logits within {err:.3g} (limit "
              f"{DECODE_TOL}){' with the enc cache filled' if enc_len else ''}"
              f"; {secs:.2f}s", flush=True)

    cfg = dataclasses.replace(get_smoke(RING_ARCH),
                              sliding_window=RING_WINDOW)
    model = Model(cfg)
    params = model.init(0, dev)
    batch = text_batch(cfg, SERVE_SEQ, SERVE_BATCH, dev)
    cache = model.init_cache(SERVE_BATCH, RING_WINDOW, device=dev)
    err, cache = decode_error(model, params, batch, cache,
                              window=RING_WINDOW)
    want = torch.arange(SERVE_SEQ - RING_WINDOW, SERVE_SEQ, device=dev)
    want = want[(want % RING_WINDOW).argsort()].to(torch.int32)
    spos = cache["b0.kv.slot_pos"]
    if not err < RING_TOL or not torch.equal(spos, want.expand_as(spos)):
        fail(f"{RING_ARCH} SMOKE ring buffer: error {err}, slot positions "
             f"{spos.tolist()}")
    print(f"{RING_ARCH} SMOKE, sliding window {RING_WINDOW}: a "
          f"{RING_WINDOW}-slot ring buffer decodes {SERVE_SEQ} steps == "
          f"forward within {err:.3g} (limit {RING_TOL}), slot positions "
          f"{want.tolist()}", flush=True)

    model = Model(get_smoke(RING_ARCH))
    params = model.init(0, dev)
    batch = text_batch(model.cfg, SERVE_SEQ, SERVE_BATCH, dev)
    cache = model.init_cache(SERVE_BATCH, SERVE_SEQ, quantized=True,
                             device=dev)
    err, _ = decode_error(model, params, batch, cache)
    if not err < INT8_TOL:
        fail(f"{RING_ARCH} SMOKE int8 cache: {err} from the forward")
    print(f"{RING_ARCH} SMOKE int8 KV cache: decode within {err:.4f} of "
          f"the exact forward (limit {INT8_TOL})", flush=True)

    cfg = get_smoke(REMAT_ARCH)
    batch = text_batch(cfg, SERVE_SEQ, SERVE_BATCH, dev)
    params = Model(cfg).init(0, dev)
    runs = [loss_and_grads(Model(dataclasses.replace(cfg, remat=r)), params,
                           batch) for r in (False, True)]
    (loss0, _, g0), (loss1, _, g1) = runs
    if not torch.equal(loss0, loss1) or not all(
            torch.equal(a, b) for a, b in zip(g0, g1)):
        fail(f"{REMAT_ARCH} SMOKE: remat changes the loss or a gradient")
    print(f"{REMAT_ARCH} SMOKE: remat on == off bit for bit (loss "
          f"{float(loss0):.6f} and {len(g0)} gradients)", flush=True)

    print(f"serve.main {' '.join(SERVE_CLI)} (paper_lm, on the card):",
          flush=True)
    seqs = serve.main(SERVE_CLI)
    if tuple(seqs.shape) != (4, 48):
        fail(f"serve.main served {tuple(seqs.shape)}")
    print(f"serve on {card_line()}", flush=True)
    no_kernel_launches("phase 14")


def no_kernel_launches(what):
    ran = launch_counts()
    check_launches(ran, (), what)
    print(f"{what}: kernel launches {ran} (serving runs none of the "
          f"eight)", flush=True)


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def decode_floor_bytes(params, cache):
    """The bytes one decode step must move as the port computes it: every
    weight read once, every cache leaf read once, and each K / V cache
    leaf's f32 (B, KV, W, hd) copy written and read once."""
    total = nbytes(params.values()) + nbytes(cache.values())
    for name, t in cache.items():
        if name.endswith(("kv.k", "kv.v")):
            total += 2 * 4 * t.numel()
    return total


def timed_decode(model, params, cache, tok, pos0, steps, window=0):
    """``steps`` greedy decode steps from ``pos0``, each synchronised;
    returns (step seconds, the first step's logits, the last's)."""
    times, first = [], None
    for t in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode(params, cache, tok, pos0 + t,
                                     window=window)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if first is None:
            first = logits.clone()
        tok = torch.argmax(logits[:, -1:], dim=-1)
    if not bool(torch.isfinite(logits).all()):
        fail("decode: non-finite logits")
    return times, first, logits


def step_line(times, batch):
    """Mean and p95 of the warm steps (the first is set-up, as in
    ``serve``) and tokens/s."""
    from repro_torch.launch.serve import _stats

    mean, p95 = _stats(times[1:])
    return (f"first step {times[0] * 1e3:.2f} ms, then {len(times) - 1} "
            f"steps mean {mean * 1e3:.3f} ms p95 {p95 * 1e3:.3f} ms, "
            f"{batch / mean:,.1f} tokens/s"), mean


def profile_step(model, params, cache, tok, pos, what, window=0):
    """One decode step under ``torch.profiler``: the device's busy share
    and device time by operator."""
    prof = profiled_if(True)
    prof.start()
    t0 = time.perf_counter()
    model.decode(params, cache, tok, pos, window=window)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    prof.stop()
    print_profile(prof, secs, what, top=8)


def serve_full_phase(dev):
    """Phase 14b: llama3_2_1b uncut decoding at decode_32k's cache
    length (bf16 and int8 caches), long_500k's ring buffer across the
    wrap, mamba2_370m uncut, and prefill_32k's prefill."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import SHAPES, decode_cache_len, \
        decode_window
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    cfg = get_arch("llama3_2_1b")
    model = Model(cfg)
    params = model.init(0, dev)
    shape = SHAPES["decode_32k"]
    W, window = decode_cache_len(cfg, shape), decode_window(cfg, shape)
    B, steps = FULL_DECODE_BATCH, FULL_DECODE_STEPS
    pos0 = W - steps
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    # a cache holding positions 0 .. pos0 - 1: random keys and values, and
    # the int8 cache their quantization
    caches = {False: model.init_cache(B, W, device=dev),
              True: model.init_cache(B, W, quantized=True, device=dev)}
    for name, t in caches[False].items():
        if name.endswith("slot_pos"):
            t[:, :pos0] = torch.arange(pos0, device=dev, dtype=torch.int32)
            caches[True][name].copy_(t)
        else:
            t.normal_(generator=g)
            for i in range(t.shape[0]):
                q, sc = L._quantize_kv(t[i])
                caches[True][name][i].copy_(q)
                caches[True][name + "scale"][i].copy_(sc)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev)
    print(f"llama3_2_1b decode ({shape.name}): {model.param_count():,} "
          f"params, {cfg.num_layers} layers (no depth cut), {cfg.dtype}; "
          f"batch {B} (the shape's {shape.global_batch} would hold "
          f"{shape.global_batch * W * 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2 / 2**30:.0f} GiB of bf16 KV), cache {W} slots holding positions "
          f"0..{pos0 - 1}, window {window}, {steps} greedy steps from "
          f"position {pos0}", flush=True)
    first = {}
    for quantized in (False, True):
        cache = caches[quantized]
        kind = "int8" if quantized else "bf16"
        what = f"llama3_2_1b decode_32k {kind} cache"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        floor = decode_floor_bytes(params, cache)
        times, first[quantized], _ = timed_decode(model, params, cache, tok,
                                                  pos0, steps, window)
        line, mean = step_line(times, B)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"{what}: {line}; cache {nbytes(cache.values()) / 2**30:.3f} "
              f"GiB, weights {nbytes(params.values()) / 1e9:.3f} GB, bytes "
              f"a step as computed {floor / 1e9:.2f} GB, floor "
              f"{floor / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s "
              f"({100 * floor / HBM_BYTES_PER_S / mean:.1f}% of it "
              f"reached); peak memory {peak:.2f} GiB on {card_line()}",
              flush=True)
        profile_step(model, params, cache, tok, W - 1, f"{what}, one step",
                     window)
    diff = (first[True] - first[False]).float()
    agree = float((first[True].argmax(-1) == first[False].argmax(-1))
                  .float().mean())
    print(f"llama3_2_1b decode_32k: the first step's logits, int8 cache "
          f"against bf16: max abs diff {float(diff.abs().max()):.4f} (the "
          f"logits' max abs {float(first[False].abs().max()):.3f}), argmax "
          f"equal for {100 * agree:.0f}% of the batch", flush=True)
    del caches, first
    torch.cuda.empty_cache()

    # long_500k: the window's ring buffer at batch 1 across the wrap
    shape = SHAPES["long_500k"]
    W, window = decode_cache_len(cfg, shape), decode_window(cfg, shape)
    pos0 = shape.seq_len - RING_STEPS_BEFORE_WRAP
    cache = model.init_cache(1, W, device=dev)
    prev = torch.arange(pos0 - W, pos0, device=dev)
    for name, t in cache.items():
        if name.endswith("slot_pos"):
            t[:, prev % W] = prev.to(torch.int32)
        else:
            t.normal_(generator=g)
    torch.cuda.reset_peak_memory_stats(dev)
    times, _, _ = timed_decode(model, params, cache, tok[:1], pos0, steps,
                               window)
    last = pos0 + steps - 1
    slots = torch.arange(W, device=dev)
    want = (last - (last - slots) % W).to(torch.int32)
    spos = cache["b0.kv.slot_pos"]
    if not torch.equal(spos, want.expand_as(spos)):
        fail(f"long_500k ring buffer: slot positions differ from the "
             f"expected ({int((spos != want).sum())} slots)")
    line, _ = step_line(times, 1)
    print(f"llama3_2_1b {shape.name}: ring buffer of {W} slots, window "
          f"{window}, batch 1, {steps} steps from position {pos0} across "
          f"the wrap at {shape.seq_len} (slot 0); every slot's position "
          f"checked after the last step ({int(want.min())}..{last}); "
          f"{line}; cache {nbytes(cache.values()) / 2**30:.3f} GiB, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    del cache

    # prefill_32k at batch 1
    shape = SHAPES["prefill_32k"]
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, shape.seq_len),
                           generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if tuple(logits.shape) != (PREFILL_BATCH, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"prefill_32k: logits {tuple(logits.shape)} not finite")
    print(f"llama3_2_1b {shape.name}: prefill of {shape.seq_len} positions "
          f"at batch {PREFILL_BATCH} (the shape's {shape.global_batch}) in "
          f"{secs:.2f} s ({PREFILL_BATCH * shape.seq_len / secs:,.0f} "
          f"tokens/s), attention in 512 x 512 tiles, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on "
          f"{card_line()}", flush=True)
    del params, logits
    torch.cuda.empty_cache()

    cfg = get_arch("mamba2_370m")
    model = Model(cfg)
    params = model.init(0, dev)
    cache = model.init_cache(FULL_DECODE_BATCH, 1, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (FULL_DECODE_BATCH, 1),
                        generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times, _, _ = timed_decode(model, params, cache, tok, 0, steps)
    line, _ = step_line(times, FULL_DECODE_BATCH)
    print(f"mamba2_370m decode: {model.param_count():,} params, "
          f"{cfg.num_layers} layers (no cut), batch {FULL_DECODE_BATCH}, "
          f"{steps} steps; {line}; state and conv cache "
          f"{nbytes(cache.values()) / 2**20:.1f} MiB, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on "
          f"{card_line()}", flush=True)
    profile_step(model, params, cache, tok, steps, "mamba2_370m decode, "
                 "one step")
    del params, cache
    torch.cuda.empty_cache()
    no_kernel_launches("phase 14b")


def train_4k_phase(dev):
    """Phase 14c: llama3_2_1b uncut at train_4k's sequence through the
    kernels with remat (the config's default), the peak under 76 GiB;
    then what remat off would keep for the backward."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import model as MM
    from repro_torch.models.model import Model

    cfg = get_arch("llama3_2_1b")
    shape = SHAPES["train_4k"]
    model = Model(cfg)
    what = (f"llama3_2_1b {shape.name} (remat {cfg.remat}, seq "
            f"{shape.seq_len}, batch {TRAIN4K_BATCH} on each of "
            f"{TRAIN4K_CLIENTS} clients of the shape's "
            f"{shape.global_batch}, chunk {TRAIN4K_CHUNK})")
    print(f"{what}: {TRAIN4K_ROUNDS} rounds of EF {FULL_SPEC} "
          f"backend=kernel", flush=True)
    wide_phase(dev, model, dict(uplink_compressor=FULL_SPEC),
               fused_chain_kernels(model), what, TRAIN4K_CLIENTS,
               shape.seq_len, TRAIN4K_BATCH, TRAIN4K_ROUNDS,
               chunk=TRAIN4K_CHUNK, profile=False)

    # remat off: what a layer keeps for the backward, measured on the
    # model cut to one layer (a whole run near the card's limit spends
    # minutes in the allocator before it fails)
    kept = {}
    batch = text_batch(cfg, shape.seq_len, TRAIN4K_BATCH, dev)
    for remat in (False, True):
        one = dataclasses.replace(cfg, num_layers=1, remat=remat)
        params = {k: v.requires_grad_(True)
                  for k, v in Model(one).init(0, dev).items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        x, _ = MM.forward(params, batch, one, chunk=TRAIN4K_CHUNK)
        torch.cuda.synchronize()
        kept[remat] = (torch.cuda.memory_allocated(dev) - base) / 2**30
        del params, x
        torch.cuda.empty_cache()
    # a lower bound of the local update's need: the saved activations,
    # the params and their gradients (the state and the wire come on top)
    weights = 2 * model.param_count() * cfg.dtype.itemsize / 2**30
    need = cfg.num_layers * kept[False] + weights
    card = torch.cuda.get_device_properties(dev).total_memory / 2**30
    print(f"llama3_2_1b {shape.name} remat off: a layer keeps "
          f"{kept[False]:.3f} GiB for the backward (remat on: "
          f"{kept[True]:.3f} GiB, the layer's input), measured on a "
          f"1-layer cut; {cfg.num_layers} layers with the params and their "
          f"gradients ({weights:.2f} GiB) need at least {need:.1f} GiB, "
          f"{'more' if need > card else 'less'} than the card's "
          f"{card:.1f} GiB: the run "
          f"{'does not fit, and is not run' if need > card else 'may fit'}"
          f"; on {card_line()}", flush=True)


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
               rounds, inspect, profile=False)


# ---------------------------------------------------------------------------
# phases 15-15e: the star, hier and gossip topologies over torch.distributed
# ---------------------------------------------------------------------------

def rank_setup(rank, world, init, backend="gloo"):
    """A spawned rank: the script's determinism settings, the port on the
    path, the process group joined (every gloo rank on cuda:0).  Ranks
    that share the card take their memory in expandable segments, so that
    one rank's freed blocks do not stay reserved as fragments beside the
    other's."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    from repro_torch.launch.mesh import init_ranks
    return init_ranks(backend, "cuda", rank, world, init,
                      timeout=RANK_TIMEOUT_S)


def run_group(target, nproc, what, *args):
    """``target(rank, nproc, init, out_dir, *args)`` in ``nproc`` spawned
    ranks (the kernels are built already, so they only load them); a rank
    that fails or outlives RANK_TIMEOUT_S fails the phase.  Returns the
    ranks' JSON reports."""
    import shutil

    from repro_torch.launch.mesh import run_ranks
    tmp = scratch_dir(f"{what}-")
    try:
        try:
            run_ranks(target, nproc, args=(tmp,) + args,
                      timeout=RANK_TIMEOUT_S + 120)
        except RuntimeError as e:
            fail(f"{what}: {e}")
        reps = []
        for r in range(nproc):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reps.append(json.load(f))
        return reps
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rank_fail(rank, msg):
    """A rank's check failed: say so and exit non-zero (the group fails)."""
    print(f"chip_smoke: FAIL: rank {rank}: {msg}", file=sys.stderr,
          flush=True)
    os._exit(1)


def mesh_rounds(engine, state, data_fn, rounds):
    """``rounds`` rounds of a mesh engine, each synchronised and timed,
    with the collective wrapper's records of each round."""
    from repro_torch.core import aggregation
    from repro_torch.core.engine import stack_rows
    ms, times, recs = [], [], []
    for _ in range(rounds):
        aggregation.COLLECTIVES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = engine.round_fn(state, engine.local_batch(
            data_fn(state.round)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        recs.append(list(aggregation.COLLECTIVES))
        ms.append(m)
    return state, stack_rows(ms), times, recs


def sum_ranks(value):
    """The sum over the group (a host int64 all-reduce outside the
    collective wrapper: a check, not a round's traffic)."""
    import torch.distributed as dist
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t.item())


def shares(part, whole):
    """Each round's ``part`` seconds as a percentage of its ``whole``."""
    return ", ".join(f"{100 * p / w:.0f}%" for p, w in zip(part, whole))


def ledger_bytes(clients, per_client):
    """The ledger's uplink for ``per_client`` payload bytes from each of
    ``clients``: its own float32 product of the count and the term."""
    return int(torch.tensor(float(clients), dtype=torch.float32)
               * torch.tensor(float(per_client), dtype=torch.float32))


def wire_bytes(recs, hop):
    return [sum(r.nbytes for r in rr if r.hop == hop) for rr in recs]


def payload_per_client(spec, model, dev, **kw):
    """One client's payload bytes over the model's leaves, from the plain
    pipeline (its shapes are the kernel pipeline's)."""
    from repro_torch.compress.api import make_compressor
    from repro_torch.compress.wire_format import payload_nbytes
    up = make_compressor(spec, backend="jax", **kw)
    return sum(payload_nbytes(up, n, device=dev) for n in model.param_sizes())


def check_wire_dtypes(rank, recs, hop, spec, sizes, what):
    """The packed wire gathers uint8 and no int8 code plane, the staged
    QSGD wire int8, only the identity wire all-reduces float32; a float32
    operand of a compressed wire is side info (scales, mu: at most one per
    2,048 coordinates), never a code plane."""
    rs = [r for rr in recs for r in rr if r.hop == hop]
    dts = {str(r.dtype).replace("torch.", "") for r in rs}
    ops = {r.op for r in rs}
    if spec == "none":
        if (dts, ops) != ({"float32"}, {"all_reduce"}):
            rank_fail(rank, f"{what}: identity wire {dts} {ops}")
        return dts
    limit = max(1, -(-max(sizes) // 2048))
    big = [r.nbytes // 4 for r in rs if r.dtype == torch.float32
           and r.nbytes // 4 > limit]
    if ops != {"all_gather"} or big:
        rank_fail(rank, f"{what}: wire ops {ops}, f32 planes {big}")
    packed = "@fused" in spec
    if packed and ("uint8" not in dts or "int8" in dts):
        rank_fail(rank, f"{what}: packed wire dtypes {dts}")
    if not packed and "qsgd" in spec and "int8" not in dts:
        rank_fail(rank, f"{what}: staged qsgd wire dtypes {dts}")
    return dts


def backend_pairs(runs, what, rank, skip_ctx=False, skip=(), loose=False):
    """Every state tensor and metric of the kernel run bit-equal to the
    plain run's (SecAgg contexts dropped where asked, the ledger fields of
    ``skip`` left out).  ``loose`` (the ternary wire, whose kernel sums mu
    in another order): the ledger exact, the losses within rtol 1e-5, the
    params and pipeline rows within rtol 1e-4 / atol 1e-6 on >= 99.9% of
    each tensor's elements (a support flip at a threshold tie moves one
    coordinate by a whole mu: DESIGN.md section 6's engine scope)."""
    from repro_torch.compress.secure_agg import drop_mask_ctx
    (sk, mk), (sp, mp) = runs["kernel"], runs["jax"]
    comm = (lambda s: drop_mask_ctx(s)) if skip_ctx else (lambda s: s)
    state = [list(zip(_tensors(f(sk)), _tensors(f(sp)))) for f in (
        lambda s: s.params, lambda s: comm(s.comm_state),
        lambda s: s.control, lambda s: s.client_controls)]
    state = [p for group in state for p in group]
    ledger = [(getattr(mk["ledger"], f), getattr(mp["ledger"], f))
              for f in mk["ledger"].fields() if f not in skip]
    metrics = [(mk[k], mp[k]) for k in ("loss", "pod_divergence",
                                         "consensus") if k in mk]
    for group, pairs in (("state", state), ("ledger", ledger),
                         ("metric", metrics)):
        for a, b in pairs:
            if torch.equal(a, b):
                continue
            err = float((a.double() - b.double()).abs().max())
            if loose and group == "state" and torch.isclose(
                    a, b, rtol=1e-4, atol=1e-6).double().mean() >= 0.999:
                continue
            if loose and group == "metric" and torch.allclose(a, b,
                                                               rtol=1e-5):
                continue
            rank_fail(rank, f"{what}: kernel backend differs from the plain "
                            f"backend in a {group} tensor (max abs err "
                            f"{err})")
    return len(state) + len(ledger) + len(metrics)


def topology_ranks(rank, world, init, out_dir):
    """One of phase 15/15c/15d/15f/15g/15h's 4 ranks on the card (gloo):
    the star's chains, then hier at pod 2 x data 2, gossip, the star over
    a population, the train CLI's ranks traced and the star on a model
    axis, each phase's kernel launches counted from 0 in this rank."""
    dev = rank_setup(rank, world, init)
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    model = Model(get_arch("paper_lm"))
    devices = [None] * world
    dist.all_gather_object(devices, str(dev))
    report = {"rank": rank, "device": str(dev), "phases": {}}
    mesh4 = make_mesh({"data": world, "model": 1}, dev)
    mesh22 = make_mesh({"pod": 2, "data": world // 2, "model": 1}, dev)
    mesh_m = make_mesh(MODEL_AXIS_MESH, dev)
    cli = lambda *a: cli_rank_phase(*a, out_dir)          # noqa: E731
    for name, fn, mesh in (("15", star_rank_phase, mesh4),
                           ("15c", hier_rank_phase, mesh22),
                           ("15d", gossip_rank_phase, mesh4),
                           ("15f", population_star_phase, mesh4),
                           ("15g", cli, mesh4),
                           ("15h", model_axis_phase, mesh_m)):
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        lines = fn(rank, model, mesh, dev, devices)
        report["phases"][name] = {
            "launches": dict(launch_counts()),
            "seconds": time.perf_counter() - t0, "lines": lines}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def paper_data(model, n, dev, lead=None):
    """Round r's paper_lm batch over n clients (phase 4's seq and batch),
    reshaped to ``lead`` (G, Ce) for the hierarchy."""
    from repro_torch.data.synthetic import sample_round
    data = fed_data(model, n, PAPER_LM_SEQ, PAPER_LM_BATCH)

    def data_fn(r):
        b = sample_round(data, r, dev)
        if lead is None:
            return b
        return {k: v.reshape(lead + tuple(v.shape[1:])) for k, v in b.items()
                if k in ("tokens", "labels", "mask")}
    return data_fn


def star_rank_phase(rank, model, mesh, dev, devices):
    """Phase 15 in one rank: each STAR_CHAINS chain and the masked twin of
    the EF chain, TOPO_ROUNDS rounds on each backend."""
    from repro_torch.core.engine import Topology, make_round_engine
    from repro_torch.core.types import FLConfig
    C = mesh.shape["data"]
    sizes = model.param_sizes()
    data_fn = paper_data(model, C, dev)
    lines, runs_by = [], {}
    for label, kw, expect in STAR_CHAINS + (STAR_MASKED,):
        runs = {}
        for backend in ("kernel", "jax"):
            fl = FLConfig(backend=backend, **dict(TOPO_FL, **kw))
            eng = make_round_engine(model, fl, Topology.star(),
                                    chunk=PAPER_LM_SEQ, mesh=mesh)
            before = launch_counts()
            st, ms, times, recs = mesh_rounds(eng, eng.init_fn(0), data_fn,
                                              TOPO_ROUNDS)
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            for name, count in ran.items():
                if (count > 0) != (backend == "kernel" and name in expect):
                    rank_fail(rank, f"15 {label} {backend}: {name} launched "
                                    f"{count} times")
            spec = fl.uplink_compressor
            per = payload_per_client(spec, model, dev)
            got = wire_bytes(recs, "wire")
            if got != [per] * TOPO_ROUNDS:
                rank_fail(rank, f"15 {label}: wire bytes {got} != payload "
                                f"{per} a round")
            total = sum_ranks(sum(got))
            scale = 2 if kw.get("algorithm") == "scaffold" else 1
            led = [int(v) for v in ms["ledger"].uplink_wire.tolist()]
            if total != C * per * TOPO_ROUNDS or led != [
                    ledger_bytes(C, scale * per)] * TOPO_ROUNDS:
                rank_fail(rank, f"15 {label}: the ranks' wire bytes {total} "
                                f"over {TOPO_ROUNDS} rounds, x{scale} per "
                                f"client {scale * per}, ledger {led}")
            dts = check_wire_dtypes(rank, recs, "wire", spec, sizes,
                                    f"15 {label}")
            if scale == 2:
                dense = wire_bytes(recs, "dense")
                if dense != [4 * sum(sizes)] * TOPO_ROUNDS:
                    rank_fail(rank, f"15 {label}: dense control bytes "
                                    f"{dense}")
            coll = [sum(r.seconds for r in rr) for rr in recs]
            losses = [float(v) for v in ms["loss"]]
            if not all(v == v and abs(v) < 1e6 for v in losses):
                rank_fail(rank, f"15 {label}: loss {losses}")
            runs[backend] = (st, ms)
            lines.append(
                f"phase 15 star {label} backend={backend}: {C} ranks over "
                f"gloo on {devices}, round times "
                f"{', '.join(f'{t:.3f}' for t in times)} s (collectives "
                f"{shares(coll, times)} of each), loss {fmt(losses)}, wire "
                f"{per:,} B a rank a "
                f"round in {sorted(dts)}, the ranks' sum {C} x that, x{scale} "
                f"in f32 == ledger {led[0]:,} B, launches {ran}")
        loose = "ternary" in label
        n = backend_pairs(runs, f"15 {label}", rank, skip_ctx=True,
                          loose=loose)
        lines.append(f"phase 15 star {label}: kernel and plain backends "
                     + ("agree at engine scope: ledger exact, losses "
                        "within rtol 1e-5, params and EF rows within rtol "
                        "1e-4 on >= 99.9% of each tensor (the kernel's mu "
                        "sums in another order)" if loose
                        else "bit-identical")
                     + f" ({n} tensors)")
        runs_by[label] = runs["kernel"]
    # SecAgg: the masked EF chain equals the clear one bit for bit
    masked, clear = runs_by[STAR_MASKED[0]], runs_by[STAR_CHAINS[1][0]]
    n = backend_pairs({"kernel": masked, "jax": clear},
                      "15 masked vs clear", rank, skip_ctx=True,
                      skip=("uplink_entropy",))
    lines.append(f"phase 15 star {STAR_MASKED[0]}: masked == clear bit for "
                 f"bit ({n} tensors: params, EF rows with the mask context "
                 f"dropped, the ledger but the entropy bill, losses)")
    return lines


def hier_rank_phase(rank, model, mesh, dev, devices):
    """Phase 15c in one rank: hier at pod 2 x data 2, HIER_ROUNDS rounds of
    qsgd:8 on the edge and the pod hop, the cloud hop every 2nd round,
    telemetry on, both backends."""
    from repro_torch.core.engine import Topology, make_round_engine
    from repro_torch.core.types import FLConfig
    G, Ce = mesh.shape["pod"], mesh.shape["data"]
    data_fn = paper_data(model, G * Ce, dev, (G, Ce))
    runs, lines = {}, []
    for backend in ("kernel", "jax"):
        fl = FLConfig(backend=backend, **dict(TOPO_FL, **HIER_FL))
        eng = make_round_engine(model, fl, Topology.hier(fl.sync_every),
                                chunk=PAPER_LM_SEQ, mesh=mesh)
        before = launch_counts()
        st, ms, times, recs = mesh_rounds(eng, eng.init_fn(0), data_fn,
                                          HIER_ROUNDS)
        ran = {k: v - before[k] for k, v in launch_counts().items()}
        for name, count in ran.items():
            on = backend == "kernel" and name == "qsgd_quantize"
            if (count > 0) != on:
                rank_fail(rank, f"15c {backend}: {name} launched {count}")
        cloud = [(r + 1) % fl.sync_every == 0 for r in range(HIER_ROUNDS)]
        div = [float(v) for v in ms["pod_divergence"]]
        if any(c and d != 0.0 for c, d in zip(cloud, div)) or \
                not all(d > 0 for c, d in zip(cloud, div) if not c):
            rank_fail(rank, f"15c: pod_divergence {div} on cloud rounds "
                            f"{cloud}")
        edge = [sum_ranks(b) for b in wire_bytes(recs, "edge")]
        c0 = [sum_ranks(b if mesh.axis_index("data") == 0 else 0)
              for b in wire_bytes(recs, "cloud")]
        t = eng.terms
        want_edge = [int(t["edge_wire"])] * HIER_ROUNDS
        want_cloud = [int(t["cloud_wire"]) if c else 0 for c in cloud]
        led = [float(v) for v in ms["ledger"].uplink_wire]
        if edge != want_edge or c0 != want_cloud or led != [
                float(e + c) for e, c in zip(want_edge, want_cloud)]:
            rank_fail(rank, f"15c: edge bytes {edge} (ledger {want_edge}), "
                            f"cloud bytes over data index 0 {c0} (ledger "
                            f"{want_cloud}), ledger {led}")
        pod_slot = [float(v) for v in ms["round_stats"].up_stage_bytes[:, -1]]
        if pod_slot != [float(c) for c in want_cloud]:
            rank_fail(rank, f"15c: telemetry pod slot {pod_slot}")
        dts = check_wire_dtypes(rank, recs, "edge", "qsgd:8",
                                model.param_sizes(), "15c edge")
        coll = [sum(r.seconds for r in rr) for rr in recs]
        runs[backend] = (st, ms)
        lines.append(
            f"phase 15c hier pod {G} x data {Ce} backend={backend}: ranks "
            f"over gloo on {devices}, round times "
            f"{', '.join(f'{x:.3f}' for x in times)} s (collectives "
            f"{shares(coll, times)}), loss "
            f"{fmt([float(v) for v in ms['loss']])}, "
            f"pod_divergence {div}, edge bytes {edge} == edge_wire, cloud "
            f"bytes over each data index's pod group {c0} == cloud_wire on "
            f"cloud rounds ({sorted(dts)}), telemetry pod slot {pod_slot}, "
            f"launches {ran}")
    n = backend_pairs(runs, "15c", rank)
    lines.append(f"phase 15c: kernel and plain backends bit-identical ({n} "
                 f"tensors)")
    return lines


def gossip_rank_phase(rank, model, mesh, dev, devices):
    """Phase 15d in one rank: the ring and expander_graph(4), each on qsgd:8
    and on EF topk:0.25>>qsgd:8, GOSSIP_ROUNDS rounds from per-node
    perturbed params (lr 0.01, the reference's case), both backends."""
    from repro_torch.core.engine import (Topology, expander_graph,
                                         make_round_engine)
    from repro_torch.core.types import FLConfig
    C = mesh.shape["data"]
    data_fn = paper_data(model, C, dev)
    lines = []
    for graph_name, spec, expect in GOSSIP_RUNS:
        runs = {}
        graph = None if graph_name == "ring" else expander_graph(C)
        for backend in ("kernel", "jax"):
            fl = FLConfig(backend=backend, uplink_compressor=spec,
                          local_lr=0.01, local_steps=1)
            eng = make_round_engine(model, fl, Topology.gossip(graph),
                                    chunk=PAPER_LM_SEQ, mesh=mesh)
            st = eng.init_fn(0)
            g = torch.Generator(device=dev)
            g.manual_seed(9 + rank)
            st.params = {n: (p.float() + 0.1 * torch.randn(
                p.shape, generator=g, device=dev)).to(p.dtype)
                for n, p in st.params.items()}
            before = launch_counts()
            st, ms, times, recs = mesh_rounds(eng, st, data_fn,
                                              GOSSIP_ROUNDS)
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            for name, count in ran.items():
                if (count > 0) != (backend == "kernel" and name in expect):
                    rank_fail(rank, f"15d {graph_name} {spec} {backend}: "
                                    f"{name} launched {count}")
            cons = [float(v) for v in ms["consensus"]]
            if not cons[-1] < 0.7 * cons[0]:
                rank_fail(rank, f"15d {graph_name} {spec}: consensus {cons}")
            mix = [sum_ranks(b) for b in wire_bytes(recs, "mix")]
            if mix != [int(eng.terms["mix_wire"])] * GOSSIP_ROUNDS:
                rank_fail(rank, f"15d {graph_name} {spec}: mix bytes {mix} "
                                f"!= mix_wire {eng.terms['mix_wire']}")
            coll = [sum(r.seconds for r in rr) for rr in recs]
            runs[backend] = (st, ms)
            lines.append(
                f"phase 15d gossip {graph_name} {spec} backend={backend}: "
                f"{C} ranks over gloo, round times "
                f"{', '.join(f'{x:.3f}' for x in times)} s (collectives "
                f"{shares(coll, times)}), consensus {fmt(cons)} (last < "
                f"0.7x first), mix bytes "
                f"{mix[0]:,} a round == mix_wire, launches {ran}")
        n = backend_pairs(runs, f"15d {graph_name} {spec}", rank)
        lines.append(f"phase 15d gossip {graph_name} {spec}: kernel and "
                     f"plain backends bit-identical ({n} tensors)")
    return lines


def store_digest(store_state):
    """A digest of every tensor of a store state, in order (its bytes as
    they lie: replicas equal bit for bit have equal digests)."""
    import hashlib

    from repro_torch.compress.residual_store import _leaves
    h = hashlib.sha256()
    for t in _leaves(store_state):
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def gather_object(value):
    """Every rank's ``value``, in rank order (outside the collective
    wrapper: a check, not a round's traffic)."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def population_star_run(model, mesh, dev, pop, fl_kw, backend, data_fn):
    """POP_STAR_ROUNDS rounds of the star over ``pop`` (None: the dense
    star) with the flight recorder on; each round synchronised and timed,
    its collective records and the store's digest after it."""
    from repro_torch.core import aggregation
    from repro_torch.core.engine import (Topology, make_round_engine,
                                         stack_rows)
    from repro_torch.core.types import FLConfig
    fl = FLConfig(backend=backend, telemetry=True,
                  **dict(TOPO_FL, **fl_kw))
    eng = make_round_engine(model, fl, Topology.star(), chunk=PAPER_LM_SEQ,
                            mesh=mesh, population=pop)
    state = eng.init_fn(0)
    before = launch_counts()
    ms, times, recs, digests = [], [], [], []
    for _ in range(POP_STAR_ROUNDS):
        aggregation.COLLECTIVES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = eng.round_fn(state, eng.local_batch(
            data_fn(state.round)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        recs.append(list(aggregation.COLLECTIVES))
        ms.append(m)
        if pop is not None and state.comm_state is not None:
            digests.append(store_digest(state.comm_state))
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    return eng, state, stack_rows(ms), times, recs, digests, ran


def population_star_phase(rank, model, mesh, dev, devices):
    """Phase 15f in one rank: the star over a ClientPopulation, every rank
    a replica of the residual store.  (a) n_clients = cohort = capacity =
    4 against the dense star bit for bit; (b)-(d) POP_STAR_RUNS.  Each run
    on both backends, POP_STAR_ROUNDS rounds: backends bit-identical (the
    params, the whole store, the ledger, the losses), every rank's
    replica bit-identical after every round, the store counters and
    ``selected`` equal across ranks, the wire's bytes the ledger's for
    the selected clients, the store hop one advanced row a rank a round,
    the kernels launched on the kernel backend alone."""
    from repro_torch.compress.residual_store import _leaves, store_nbytes
    from repro_torch.core.population import ClientPopulation
    from repro_torch.data.pipeline import cohort_data_fn
    C, idx = mesh.shape["data"], mesh.axis_index("data")
    sizes = model.param_sizes()
    row = 4 * sum(sizes)                  # one client's f32 EF residual
    lines = []

    # (a) the degenerate contract, on the dense star's batches
    data4 = paper_data(model, C, dev)
    fl_a = dict(uplink_compressor=CHAINS[0])
    for backend in ("kernel", "jax"):
        _, sd, md, *_ = population_star_run(model, mesh, dev, None, fl_a,
                                            backend, data4)
        _, sp, mp, times, recs, digests, ran = population_star_run(
            model, mesh, dev, ClientPopulation(**POP_STAR_DEGENERATE), fl_a,
            backend, data4)
        for a, b in zip(_tensors(sd.params), _tensors(sp.params)):
            if not torch.equal(a, b):
                rank_fail(rank, f"15f a {backend}: params differ from the "
                                f"dense star")
        slab = _leaves(sp.comm_state["slab"])
        dense = _leaves(sd.comm_state)
        if len(slab) != len(dense) or not all(
                torch.equal(s[idx], d[0]) for s, d in zip(slab, dense)):
            rank_fail(rank, f"15f a {backend}: slab row {idx} differs from "
                            f"the dense star's EF row")
        if not torch.equal(mp["loss"], md["loss"]):
            rank_fail(rank, f"15f a {backend}: losses differ")
        lines.append(f"phase 15f a degenerate n=cohort=capacity={C} "
                     f"backend={backend}: params and slab row {idx} == the "
                     f"dense star's bit for bit ({len(slab)} EF rows), "
                     f"{POP_STAR_ROUNDS} rounds, launches {ran}")

    for label, pop_kw, fl_kw, expect in POP_STAR_RUNS:
        runs = {}
        for backend in ("kernel", "jax"):
            pop = ClientPopulation(**pop_kw)
            data_fn = cohort_data_fn(pop, fed_data(
                model, pop.n_clients, PAPER_LM_SEQ, PAPER_LM_BATCH), dev)
            eng, st, ms, times, recs, digests, ran = population_star_run(
                model, mesh, dev, pop, fl_kw, backend, data_fn)
            what = f"15f {label} {backend}"
            for name, count in ran.items():
                if (count > 0) != (backend == "kernel" and name in expect):
                    rank_fail(rank, f"{what}: {name} launched {count}")
            everyone = gather_object(digests)
            if any(d != digests for d in everyone) or \
                    len(digests) != POP_STAR_ROUNDS:
                rank_fail(rank, f"{what}: the store replicas differ across "
                                f"ranks")
            rs = ms["round_stats"]
            counters = {k: [int(v) for v in getattr(rs, f"store_{k}")]
                        for k in ("hits", "misses", "evictions")}
            sel = [float(v) for v in ms["selected"]]
            if any(o != (counters, sel) for o in gather_object(
                    (counters, sel))):
                rank_fail(rank, f"{what}: store counters or selected "
                                f"differ across ranks")
            # (a million clients' cohorts never meet again in 4 rounds)
            occur = ("misses", "evictions") + (
                ("hits",) if pop.n_clients < 2 * pop.capacity else ())
            if not all(sum(counters[k]) > 0 for k in occur):
                rank_fail(rank, f"{what}: not all of {occur} occur "
                                f"({counters})")
            # every rank sends its payload (a zero-weight client too); the
            # ledger bills the selected clients' wire_bits, which is the
            # payload under @fused and the payload less the staged QSGD
            # plane's padding to whole blocks otherwise
            per = payload_per_client(fl_kw["uplink_compressor"], model, dev)
            term = eng.terms["up_wire"]
            got = wire_bytes(recs, "wire")
            led = [float(v) for v in ms["ledger"].uplink_wire.tolist()]
            want = [float(torch.tensor(n, dtype=torch.float32)
                          * torch.tensor(term, dtype=torch.float32))
                    for n in sel]
            if got != [per] * POP_STAR_ROUNDS or sum_ranks(sum(got)) != \
                    C * per * POP_STAR_ROUNDS or led != want or (
                        "@fused" in fl_kw["uplink_compressor"]
                        and term != per):
                rank_fail(rank, f"{what}: wire bytes {got} (payload {per}), "
                                f"ledger {led} for selected {sel} (billed "
                                f"{term} a client)")
            stored = wire_bytes(recs, "store")
            if stored != [row] * POP_STAR_ROUNDS or sum_ranks(
                    sum(stored)) != C * row * POP_STAR_ROUNDS:
                rank_fail(rank, f"{what}: store bytes {stored} != one row "
                                f"{row} a round")
            losses = [float(v) for v in ms["loss"]]
            if not all(v == v and abs(v) < 1e6 for v in losses):
                rank_fail(rank, f"{what}: loss {losses}")
            by_hop = {h: [sum(r.seconds for r in rr if r.hop == h)
                          for rr in recs] for h in ("wire", "store",
                                                    "metrics")}
            mb = store_nbytes(st.comm_state) / 1e6
            runs[backend] = (st, ms)
            lines.append(
                f"phase 15f {label} backend={backend}: {C} ranks over gloo "
                f"on {devices}, round times "
                f"{', '.join(f'{t:.3f}' for t in times)} s, collectives by "
                f"hop: " + "; ".join(f"{h} {shares(v, times)}"
                                     for h, v in by_hop.items())
                + f"; store replica {mb:.2f} MB a rank, hits/misses/"
                f"evictions a round {counters['hits']}/"
                f"{counters['misses']}/{counters['evictions']}, selected "
                f"{sel}, loss {fmt(losses)}, wire {per:,} B a rank a round "
                f"(the ledger {fmt(led)} == selected x {term:,.0f} B), store "
                f"hop {row:,} B a rank a round, "
                f"replicas bit-identical every round, launches {ran}")
        n = backend_pairs(runs, f"15f {label}", rank)
        lines.append(f"phase 15f {label}: kernel and plain backends "
                     f"bit-identical ({n} tensors: params, the whole store, "
                     f"the ledger, the losses)")
    return lines


def cli_rank_phase(rank, model, mesh, dev, devices, out_dir):
    """Phase 15g in one rank: ``train.main`` with --nproc 4 --dist-backend
    gloo (this process already a rank: it runs its own part) and --trace,
    --profile-dir and --checkpoint, for the star and hier, then the same
    run untraced.  Rank 0's trace validates and its report renders, its
    stage slots sum to the ledger, every rank wrote its own profiler
    trace, the checkpoint restores bit-equal to rank 0's final params and
    every rank's params equal the untraced run's."""
    import contextlib
    import io

    from repro_torch import checkpoint
    from repro_torch.launch import train
    from repro_torch.obs import report
    from repro_torch.obs.trace import validate_file

    world = mesh.shape["data"]
    base = ["--nproc", str(world), "--dist-backend", "gloo", "--device",
            dev.type, "--backend", "kernel", "--rounds", "2", "--seq",
            str(PAPER_LM_SEQ), "--batch-per-client", str(PAPER_LM_BATCH),
            "--local-steps", "1", "--compressor", CHAINS[1]]
    lines = []
    for kind, extra in CLI_RANK_RUNS:
        d = os.path.join(out_dir, f"15g-{kind}")
        trace, prof = os.path.join(d, "run.jsonl"), os.path.join(d, "prof")
        ckpt = os.path.join(d, "ckpt.npz")
        if rank == 0:
            os.makedirs(d, exist_ok=True)
        sum_ranks(0)                                     # a barrier
        before = launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            on, ms = train.main(base + extra + [
                "--trace", trace, "--profile-dir", prof, "--checkpoint",
                ckpt])
        secs_on = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            off, _ = train.main(base + extra)
        secs_off = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in launch_counts().items()}
        for name, count in ran.items():
            if (count > 0) != (name in CLI_RANK_KERNELS):
                rank_fail(rank, f"15g {kind}: {name} launched {count}")
        for n, p in on.params.items():
            if not torch.equal(p, off.params[n]):
                rank_fail(rank, f"15g {kind}: traced params differ from "
                                f"untraced ({n})")
        mine = [f for f in os.listdir(prof) if f.startswith(f"rank{rank}.")]
        if not mine:
            rank_fail(rank, f"15g {kind}: no profiler trace of this rank in "
                            f"{sorted(os.listdir(prof))}")
        sum_ranks(0)
        if rank == 0:
            recs = validate_file(trace)
            kinds = [r["kind"] for r in recs]
            if (recs[0].get("topology"), kinds.count("round"),
                    kinds.count("stages"), kinds.count("checkpoint")) != (
                        kind, 2, 1, 1):
                rank_fail(rank, f"15g {kind}: records {kinds}")
            text = report.render(report.summarize(recs))
            if "uplink byte waterfall" not in text:
                rank_fail(rank, f"15g {kind}: the report:\n{text}")
            check_slots(ms["round_stats"], ms["ledger"], f"15g {kind}")
            for r in (x for x in recs if x["kind"] == "round"):
                acc = torch.zeros((), dtype=torch.float32)
                for v in r["m"]["round_stats.up_stage_bytes"]:
                    acc = acc + torch.tensor(v, dtype=torch.float32)
                if float(acc) != r["m"]["ledger.uplink_wire"]:
                    rank_fail(rank, f"15g {kind}: the trace's slots sum to "
                                    f"{float(acc)}, the ledger "
                                    f"{r['m']['ledger.uplink_wire']}")
            back = checkpoint.restore(ckpt, on.params)
            for n, p in on.params.items():
                if not torch.equal(back[n], p):
                    rank_fail(rank, f"15g {kind}: checkpoint leaf {n}")
            profs = sorted(os.listdir(prof))
            mb = sum(os.path.getsize(os.path.join(prof, f))
                     for f in profs) / 1e6
            lines.append(
                f"phase 15g cli {kind}: --nproc {world} over gloo on "
                f"{devices}, {len(recs)} records "
                f"{ {k: kinds.count(k) for k in sorted(set(kinds))} } "
                f"valid, the report renders, the slots sum to the ledger; "
                f"profiler traces {profs} ({mb:.1f} MB); checkpoint "
                f"restores bit-equal ({len(back)} leaves); traced params "
                f"== untraced on every rank; {secs_on:.2f}s traced and "
                f"profiled, {secs_off:.2f}s untraced (rank 0, with the "
                f"build of the engine); launches {ran}")
        sum_ranks(0)
    return lines


def model_blocks(model, mesh):
    """Each leaf's model dim and its block's element count on ``mesh``
    (``repro_torch.models.sharding``, as the star's engine cuts them)."""
    from repro_torch.models import sharding
    shapes = {n: tuple(d.shape) for n, d in model.defs.items()}
    specs = sharding.tree_specs(shapes, model.logical_axes(), mesh,
                                model.cfg.fsdp)
    dims = {n: sharding.model_dim(sp) for n, sp in specs.items()}
    M = mesh.shape["model"]
    return dims, [int(torch.Size(sharding.block_shape(s, dims[n], M))
                      .numel()) for n, s in shapes.items()]


def block_payload(spec, sizes, dev):
    """One rank's payload bytes for blocks of ``sizes`` (the identity
    wire: its f32 all-reduce operand), from the plain pipeline."""
    from repro_torch.compress.api import make_compressor
    from repro_torch.compress.wire_format import payload_nbytes
    if spec == "none":
        return 4 * sum(sizes)
    up = make_compressor(spec, backend="jax")
    return sum(payload_nbytes(up, n, device=dev) for n in sizes)


def model_axis_run(rank, eng, data_fn, rounds, what, pop=False):
    """``rounds`` rounds of a star engine on a model axis, each
    synchronised and timed, with its collective records; after every
    round a digest of the params (and of the store) is compared across
    the ranks, every one of which must hold the same."""
    from repro_torch.core import aggregation
    from repro_torch.core.engine import stack_rows
    state = eng.init_fn(0)
    before = launch_counts()
    ms, times, recs = [], [], []
    for r in range(rounds):
        aggregation.COLLECTIVES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = eng.round_fn(state, eng.local_batch(
            data_fn(state.round)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        recs.append(list(aggregation.COLLECTIVES))
        ms.append(m)
        mine = (store_digest(state.params),
                store_digest(state.comm_state) if pop else "")
        if any(o != mine for o in gather_object(mine)):
            rank_fail(rank, f"15h {what}: params bit-equal on all ranks "
                            f"failed after round {r} (or the store "
                            f"replicas differ)")
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    return state, stack_rows(ms), times, recs, ran


def model_axis_checks(rank, eng, ms, recs, ran, backend, may, must, per,
                      f32_blocks, what):
    """15h's per-run checks: the kernels launched (on the kernel backend
    those of ``must``, none outside ``may``; on the plain backend none),
    each rank's ``wire`` operand its blocks' payload ``per`` every round,
    the rebuild hop ``model`` (and SCAFFOLD's ``dense``) its f32 blocks,
    the ledger the selected clients' whole-leaf term in f32.  Returns the
    line's byte figures."""
    for name, count in ran.items():
        bad = (count > 0 and (backend != "kernel" or name not in may)) or (
            count == 0 and backend == "kernel" and name in must)
        if bad:
            rank_fail(rank, f"15h {what}: launches: {name} launched "
                            f"{count} times")
    rounds = len(recs)
    got = wire_bytes(recs, "wire")
    if got != [per] * rounds:
        rank_fail(rank, f"15h {what}: wire operand {got} != its blocks' "
                        f"payload {per} a round")
    scaffold = "SCAFFOLD" in what
    identity = "identity" in what
    want = {"model": f32_blocks if (identity or scaffold) else 0,
            "dense": f32_blocks if scaffold else 0}
    for hop, w in want.items():
        b = wire_bytes(recs, hop)
        if b != [w] * rounds:
            rank_fail(rank, f"15h {what}: rebuild hop {hop} bytes {b} != "
                            f"{w} (4 B x the rank's block elements)")
    sel = [float(v) for v in ms["selected"]]
    led = [float(v) for v in ms["ledger"].uplink_wire.tolist()]
    term = eng.terms["up_wire"]
    if led != [float(torch.tensor(n, dtype=torch.float32)
                     * torch.tensor(term, dtype=torch.float32))
               for n in sel]:
        rank_fail(rank, f"15h {what}: ledger {led} != selected {sel} x the "
                        f"whole-leaf term {term}")
    total = sum_ranks(sum(got))
    return (f"wire {per:,} B a rank a round (its blocks' payload), the "
            f"ranks' sum {total:,} B over {rounds} rounds against the "
            f"ledger's {sum(led):,.0f} B of whole leaves (gap "
            f"{total - sum(led):+,.0f} B"
            + ("; the ledger bills SCAFFOLD's control, which crosses the "
               "dense hop" if scaffold else "") + ")"
            + (f", rebuild hop 'model' {want['model']:,} B a rank a round"
               if want["model"] else ""))


def model_axis_phase(rank, model, mesh, dev, devices):
    """Phase 15h in one rank: the star at data 2 x model 2 (rank r is
    client r // 2's model rank r % 2), MODEL_AXIS_CHAINS and the
    population MODEL_AXIS_POP on both backends, MODEL_AXIS_ROUNDS rounds:
    params bit-equal on all 4 ranks every round, backends bit-identical
    (ternary at engine scope), the masked chain equal to the clear one,
    the identity run equal to the same rounds at data 2 x model 1 (the
    port's sim over 2 clients), the population's store replicas
    bit-equal every round."""
    from repro_torch.core.engine import Topology, make_round_engine
    from repro_torch.core.population import ClientPopulation
    from repro_torch.core.types import FLConfig
    from repro_torch.data.pipeline import cohort_data_fn
    C = mesh.shape["data"]
    dims, bsizes = model_blocks(model, mesh)
    f32_blocks = 4 * sum(bsizes)
    data_fn = paper_data(model, C, dev)
    lines, kernel_runs = [], {}
    split = sum(d is not None for d in dims.values())
    lines.append(f"phase 15h star on a model axis: mesh {mesh.shape}, rank "
                 f"{mesh.rank} is client {mesh.axis_index('data')}'s model "
                 f"rank {mesh.axis_index('model')}; {split} of {len(dims)} "
                 f"paper_lm leaves split, a rank's blocks "
                 f"{sum(bsizes):,} of {model.param_count():,} elements")
    for label, kw, may, must in MODEL_AXIS_CHAINS:
        runs = {}
        for backend in ("kernel", "jax"):
            fl = FLConfig(backend=backend, **dict(TOPO_FL, **kw))
            eng = make_round_engine(model, fl, Topology.star(),
                                    chunk=PAPER_LM_SEQ, mesh=mesh)
            what = f"{label} {backend}"
            st, ms, times, recs, ran = model_axis_run(
                rank, eng, data_fn, MODEL_AXIS_ROUNDS, what)
            per = block_payload(fl.uplink_compressor, bsizes, dev)
            figures = model_axis_checks(rank, eng, ms, recs, ran, backend,
                                        may, must, per, f32_blocks, what)
            losses = [float(v) for v in ms["loss"]]
            if not all(v == v and abs(v) < 1e6 for v in losses):
                rank_fail(rank, f"15h {what}: loss {losses}")
            by_hop = {h: [sum(r.seconds for r in rr if r.hop == h)
                          for rr in recs] for h in ("wire", "model", "dense",
                                                    "metrics")}
            runs[backend] = (st, ms)
            lines.append(
                f"phase 15h {label} backend={backend}: round times "
                f"{', '.join(f'{t:.3f}' for t in times)} s, collectives by "
                f"hop: " + "; ".join(f"{h} {shares(v, times)}"
                                     for h, v in by_hop.items() if any(v))
                + f"; loss {fmt(losses)}, {figures}; params bit-equal on "
                f"all {TOPO_RANKS} ranks every round, launches {ran}")
        loose = "ternary" in label
        n = backend_pairs(runs, f"15h {label}", rank, skip_ctx=True,
                          loose=loose)
        lines.append(f"phase 15h {label}: kernel and plain backends "
                     + ("agree at engine scope (the kernel's mu sums in "
                        "another order)" if loose else "bit-identical")
                     + f" ({n} tensors)")
        kernel_runs[label] = runs["kernel"]
    # SecAgg on the blocks: the masked chain equals the clear one
    n = backend_pairs({"kernel": kernel_runs[MODEL_AXIS_CHAINS[5][0]],
                       "jax": kernel_runs[MODEL_AXIS_CHAINS[2][0]]},
                      "15h masked vs clear", rank, skip_ctx=True,
                      skip=("uplink_entropy",))
    lines.append(f"phase 15h {MODEL_AXIS_CHAINS[5][0]}: masked == clear "
                 f"bit for bit ({n} tensors)")
    # the identity wire split by blocks changes nothing: the same rounds
    # at data 2 x model 1, as the port's sim over the 2 clients
    fl = FLConfig(backend="kernel", **dict(TOPO_FL,
                                           **MODEL_AXIS_CHAINS[0][1]))
    sim = make_round_engine(model, fl, Topology.sim(C), chunk=PAPER_LM_SEQ,
                            device=dev)
    ss = sim.init_fn(0)
    for _ in range(MODEL_AXIS_ROUNDS):
        ss, _ = sim.round_fn(ss, data_fn(ss.round))
    star = kernel_runs[MODEL_AXIS_CHAINS[0][0]][0]
    if not all(torch.equal(a, b) for a, b in zip(_tensors(star.params),
                                                 _tensors(ss.params))):
        rank_fail(rank, "15h identity: params at data 2 x model 2 differ "
                        "from the same rounds at data 2 x model 1")
    lines.append(f"phase 15h fedsgd identity: params after "
                 f"{MODEL_AXIS_ROUNDS} rounds at data 2 x model 2 == at "
                 f"data 2 x model 1 (the sim over {C} clients) bit for bit")
    # the population: every rank a replica of the store, whole rows
    label, pop_kw, fl_kw, may, must = MODEL_AXIS_POP
    runs = {}
    for backend in ("kernel", "jax"):
        pop = ClientPopulation(**pop_kw)
        pdata = cohort_data_fn(pop, fed_data(
            model, pop.n_clients, PAPER_LM_SEQ, PAPER_LM_BATCH), dev)
        fl = FLConfig(backend=backend, **dict(TOPO_FL, **fl_kw))
        eng = make_round_engine(model, fl, Topology.star(),
                                chunk=PAPER_LM_SEQ, mesh=mesh,
                                population=pop)
        what = f"population {label} {backend}"
        st, ms, times, recs, ran = model_axis_run(
            rank, eng, pdata, MODEL_AXIS_ROUNDS, what, pop=True)
        per = block_payload(fl.uplink_compressor, bsizes, dev)
        figures = model_axis_checks(rank, eng, ms, recs, ran, backend, may,
                                    must, per, f32_blocks, what)
        stored = wire_bytes(recs, "store")
        if stored != [f32_blocks] * MODEL_AXIS_ROUNDS:
            rank_fail(rank, f"15h {what}: store hop {stored} != the rank's "
                            f"f32 EF blocks {f32_blocks}")
        runs[backend] = (st, ms)
        lines.append(f"phase 15h population {label} backend={backend}: "
                     f"round times {', '.join(f'{t:.3f}' for t in times)} "
                     f"s, {figures}, store hop {f32_blocks:,} B a rank a "
                     f"round, the replicas bit-equal on every rank every "
                     f"round, launches {ran}")
    n = backend_pairs(runs, f"15h population {label}", rank)
    lines.append(f"phase 15h population {label}: kernel and plain backends "
                 f"bit-identical ({n} tensors)")
    return lines


def topology_phase(dev):
    """Phases 15, 15c, 15d, 15f, 15g and 15h: one group of 4 ranks on the card
    over gloo (NCCL cannot put two ranks of one communicator on one card);
    each rank reports its launches per phase, added here to this
    process's counts."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reps = run_group(topology_ranks, TOPO_RANKS, "phase15")
    print(f"phases 15-15d, 15f-15h: {TOPO_RANKS} ranks over gloo on "
          f"{[r['device'] for r in reps]}, {time.perf_counter() - t0:.1f}s "
          f"with the spawn on {card_line()}", flush=True)
    card = card_line()
    for name in ("15", "15c", "15d", "15f", "15g", "15h"):
        for line in reps[0]["phases"][name]["lines"]:
            print(line + (f" [{card}]" if name in ("15f", "15g", "15h")
                          else ""), flush=True)
        total = {k: sum(r["phases"][name]["launches"][k] for r in reps)
                 for k in KERNELS}
        print(f"phase {name}: kernel launches over the ranks {total} "
              f"({max(r['phases'][name]['seconds'] for r in reps):.1f}s)",
              flush=True)
        build.LAUNCHES.update(total)


def llama_star_ranks(rank, world, init, out_dir):
    """One of phase 15b's 2 ranks: llama3_2_1b uncut as one client of the
    star, EF topk:0.05>>qsgd:4@fused through the kernels."""
    dev = rank_setup(rank, world, init)
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import Topology, make_round_engine
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import sample_round
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    model = Model(get_arch("llama3_2_1b"))
    mesh = make_mesh({"data": world, "model": 1}, dev)
    fl = FLConfig(backend="kernel", local_steps=1, local_lr=0.05,
                  **LLAMA_STAR)
    eng = make_round_engine(model, fl, Topology.star(), chunk=LLAMA_SEQ,
                            mesh=mesh)
    data = fed_data(model, world, LLAMA_SEQ, LLAMA_BATCH)
    from repro_torch.kernels import build
    torch.cuda.reset_peak_memory_stats(dev)
    build.LAUNCHES.clear()
    state = eng.init_fn(0)
    state, ms, times, recs = mesh_rounds(
        eng, state, lambda r: sample_round(data, r, dev), LLAMA_ROUNDS)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = dict(launch_counts())
    # llama's top-k carriers are all even: the packed kernel quantizes them
    for name, count in launches.items():
        if (count > 0) != (name in ("threshold_sparsify", "qsgd_pack")):
            rank_fail(rank, f"15b: {name} launched {count}")
    losses = [float(v) for v in ms["loss"]]
    if not all(v == v and abs(v) < 1e6 for v in losses) or not all(
            bool(torch.isfinite(p.float()).all())
            for p in state.params.values()):
        rank_fail(rank, f"15b: loss or params not finite ({losses})")
    per = payload_per_client(fl.uplink_compressor, model, dev)
    got = wire_bytes(recs, "wire")
    total = sum_ranks(sum(got))
    led = [int(v) for v in ms["ledger"].uplink_wire.tolist()]
    if got != [per] * LLAMA_ROUNDS or total != world * per * LLAMA_ROUNDS \
            or led != [ledger_bytes(world, per)] * LLAMA_ROUNDS:
        rank_fail(rank, f"15b: wire bytes {got} (payload {per}), ranks' sum "
                        f"{total}, ledger {led}")
    dts = check_wire_dtypes(rank, recs, "wire", fl.uplink_compressor,
                            model.param_sizes(), "15b")
    coll = [sum(r.seconds for r in rr) for rr in recs]
    if peak >= LLAMA_PEAK_GIB:
        rank_fail(rank, f"15b: peak {peak:.2f} GiB")
    report = {"rank": rank, "device": str(dev), "peak_gib": peak,
              "times": times, "coll": coll, "wire": got, "dtypes":
              sorted(dts), "launches": launches, "losses": losses,
              "ledger": led}
    del state, ms, eng
    report["15i"] = llama_model_axis(rank, world, model, fl, dev)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def llama_model_axis(rank, world, model, fl, dev):
    """Phase 15i in one of 15b's ranks: llama3_2_1b uncut as ONE client at
    data 1 x model ``world``, each rank training the client's whole update
    and encoding its block of every leaf, LLAMA_ROUNDS rounds through the
    kernels: the peak memory, round times, collective seconds and bytes
    by hop, params bit-equal on every rank every round."""
    import gc

    from repro_torch.core.engine import Topology, make_round_engine
    from repro_torch.data.synthetic import sample_round
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh({"data": 1, "model": world}, dev)
    _, bsizes = model_blocks(model, mesh)
    eng = make_round_engine(model, fl, Topology.star(), chunk=LLAMA_SEQ,
                            mesh=mesh)
    data = fed_data(model, 1, LLAMA_SEQ, LLAMA_BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    build.LAUNCHES.clear()
    state, ms, times, recs, ran = model_axis_run(
        rank, eng, lambda r: sample_round(data, r, dev), LLAMA_ROUNDS,
        "15i llama3_2_1b")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for name, count in ran.items():
        if (count > 0 and name not in _FUSED) or (
                count == 0 and name in ("threshold_sparsify", "qsgd_pack")):
            rank_fail(rank, f"15i: {name} launched {count}")
    losses = [float(v) for v in ms["loss"]]
    if not all(v == v and abs(v) < 1e6 for v in losses) or not all(
            bool(torch.isfinite(p.float()).all())
            for p in state.params.values()):
        rank_fail(rank, f"15i: loss or params not finite ({losses})")
    per = block_payload(fl.uplink_compressor, bsizes, dev)
    got = wire_bytes(recs, "wire")
    led = [float(v) for v in ms["ledger"].uplink_wire.tolist()]
    if got != [per] * LLAMA_ROUNDS or led != [float(torch.tensor(
            eng.terms["up_wire"], dtype=torch.float32))] * LLAMA_ROUNDS:
        rank_fail(rank, f"15i: wire bytes {got} (its blocks' payload "
                        f"{per}), ledger {led}")
    if peak >= LLAMA_PEAK_GIB:
        rank_fail(rank, f"15i: peak {peak:.2f} GiB")
    hops = sorted({r.hop for rr in recs for r in rr})
    return {"peak_gib": peak, "times": times, "losses": losses,
            "launches": ran, "ledger": led, "block_elems": sum(bsizes),
            "bytes": {h: wire_bytes(recs, h) for h in hops},
            "seconds": {h: [sum(r.seconds for r in rr if r.hop == h)
                            for rr in recs] for h in hops}}


def llama_star_phase(dev):
    """Phases 15b and 15i: llama3_2_1b uncut as 2 ranks sharing the card
    over gloo, 2 rounds through the kernels: one client each (15b), then
    one client on a model axis of 2 (15i)."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reps = run_group(llama_star_ranks, LLAMA_CLIENTS, "phase15b")
    for r in reps:
        print(f"phase 15b llama3_2_1b star rank {r['rank']} on {r['device']}"
              f" over gloo: peak memory {r['peak_gib']:.2f} GiB (limit "
              f"{LLAMA_PEAK_GIB:.0f}), round times "
              f"{', '.join(f'{t:.3f}' for t in r['times'])} s, collectives "
              f"{shares(r['coll'], r['times'])} of each, gathered "
              f"{r['wire'][0]:,} B a round in "
              f"{r['dtypes']}, loss {fmt(r['losses'])}, launches "
              f"{r['launches']}", flush=True)
    print(f"phase 15b: the ranks' wire bytes {LLAMA_CLIENTS} x "
          f"{reps[0]['wire'][0]:,} a round, in f32 == ledger "
          f"{reps[0]['ledger']}, on {card_line()}", flush=True)
    for r in reps:
        i = r["15i"]
        print(f"phase 15i llama3_2_1b star data 1 x model {LLAMA_CLIENTS} "
              f"rank {r['rank']} (model rank {r['rank']}, its blocks "
              f"{i['block_elems']:,} elements): peak memory "
              f"{i['peak_gib']:.2f} GiB (15b's {r['peak_gib']:.2f}), round "
              f"times {', '.join(f'{t:.3f}' for t in i['times'])} s, "
              f"collectives by hop "
              + "; ".join(f"{h} {shares(v, i['times'])}"
                          for h, v in i["seconds"].items())
              + ", bytes a round by hop "
              + "; ".join(f"{h} {v[0]:,}" for h, v in i["bytes"].items())
              + f", loss {fmt(i['losses'])}, params bit-equal on both "
              f"ranks every round, launches {i['launches']}", flush=True)
    wire = sum(r["15i"]["bytes"]["wire"][0] for r in reps)
    print(f"phase 15i: the ranks' wire {wire:,} B a round against the "
          f"ledger's whole leaves {reps[0]['15i']['ledger'][0]:,.0f} B; "
          f"15b and 15i {time.perf_counter() - t0:.1f}s with the spawn, on "
          f"{card_line()}", flush=True)
    build.LAUNCHES.update({k: sum(r["launches"][k] + r["15i"]["launches"][k]
                                  for r in reps) for k in KERNELS})


def nccl_cli_phase(dev):
    """Phase 15e: the train CLI with --nproc 1 --dist-backend nccl (the
    rank spawned by the CLI, on cuda:0) for the star and for the hierarchy
    at pod 1 x data 1: the NCCL path built and run on the card.  The
    CLI's rank prints; its launches stay in that process."""
    from repro_torch.launch import train
    base = ["--nproc", "1", "--dist-backend", "nccl", "--backend", "kernel",
            "--rounds", "2", "--seq", str(PAPER_LM_SEQ),
            "--batch-per-client", str(PAPER_LM_BATCH), "--local-steps", "1",
            "--compressor", "topk:0.05>>qsgd:4@fused"]
    for extra in ([], ["--hierarchical", "--sync-every", "2"]):
        t0 = time.perf_counter()
        try:
            train.main(base + extra)
        except RuntimeError as e:
            fail(f"15e {extra}: {e}")
        print(f"phase 15e nccl {'hier' if extra else 'star'}: the CLI's "
              f"rank ran, {time.perf_counter() - t0:.1f}s with the spawn",
              flush=True)


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
                                        "EF stc:0.1@fused + lfl8",
                                        profile=False),
                  lambda d: llama_phase(d, LLAMA_SKETCH,
                                        ("count_sketch", "qsgd_quantize"),
                                        "EF sketch>>qsgd:8", profile=False),
                  population_phase, eviction_phase, llama_population_phase,
                  algorithms_phase,
                  lambda d: llama_algorithm_phase(d, "7b"),
                  lambda d: llama_algorithm_phase(d, "7c"),
                  selection_phase, async_phase, llama_async_phase,
                  privacy_phase, llama_privacy_phase, scenario_phase,
                  telemetry_phase, llama_telemetry_phase, families_phase,
                  lambda d: full_width_phase(d, "13b"),
                  lambda d: full_width_phase(d, "13c"),
                  serve_parity_phase, serve_full_phase, train_4k_phase,
                  topology_phase, llama_star_phase, nccl_cli_phase):
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
