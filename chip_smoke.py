#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure (the exit code is non-zero and no result
line is printed):

  1. the card (``nvidia-smi`` name and power limit) and the versions;
  2. the kernel build: every ``kernels/csrc/*.cu`` compiled in parallel;
  3. each CUDA kernel against its plain PyTorch version, bit for bit, at
     the shapes of the main path (the paper_lm leaves and top-k carriers,
     odd and short ones included, and the largest llama3_2_1b leaf,
     ``w_up`` at 268,435,456 elements), with the kernel's, the plain
     version's and the bound's times;
  4. the main path: paper_lm at full width, 8 clients, 3 sim rounds of
     EF ``topk:0.05>>qsgd:8`` and ``topk:0.05>>qsgd:4@fused``, each with
     ``backend="kernel"`` and with the plain backend on the card — params,
     EF residuals and ledgers must be bit-identical between the two;
  5. llama3_2_1b at full width (bf16), 2 clients, 2 rounds of
     ``topk:0.05>>qsgd:4@fused`` through the kernels: finite loss and the
     ledger equal to its static terms, with the peak memory.  The kernel
     runs of phases 4 and 5 go under ``torch.profiler``, which prints the
     device's busy share and device time by launching operator;
  6. the ``kernels`` JSON line (launch counts are those of phases 4-5);
  7. last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""
import json
import os
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

PAPER_LM_CLIENTS, PAPER_LM_SEQ, PAPER_LM_BATCH, PAPER_LM_ROUNDS = 8, 32, 2, 3
LLAMA_CLIENTS, LLAMA_SEQ, LLAMA_BATCH, LLAMA_ROUNDS = 2, 128, 1, 2
LLAMA_W_UP = 268_435_456
CHAINS = ("topk:0.05>>qsgd:8", "topk:0.05>>qsgd:4@fused")
# the CUDA entry points of kernels/csrc, as the profiler names them
OUR_KERNELS = ("threshold_sparsify_vec4", "threshold_sparsify_scalar",
               "qsgd_quantize_rows", "qsgd_pack_rows")


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

def check_kernels(dev):
    from repro_torch.compress.sparsification import _k, top_k_indices
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import bitpack, qsgd, topk_mask
    from repro_torch.models.model import Model

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    leaves = sorted(set(Model(get_arch("paper_lm")).param_sizes()))
    # the top-k carriers each leaf hands to QSGD, with the QSGD block
    # adapted to min(2048, k): short, odd and multi-row carriers
    carriers = sorted({_k(n, 0.05) for n in leaves} | {3001})
    sizes = {"threshold_sparsify": leaves + [3001, LLAMA_W_UP],
             "qsgd_quantize": carriers + [_k(LLAMA_W_UP, 0.05)],
             "qsgd_pack": [k for k in carriers if min(2048, k) % 2 == 0]
             + [_k(LLAMA_W_UP, 0.05)]}
    print(f"paper_lm leaf sizes {leaves}; top-k carriers {carriers}")
    results = {}
    for name, ns in sizes.items():
        worst = 0.0
        for n in ns:
            x = torch.randn(n, generator=g, device=dev) * 2.0
            u = torch.rand(n, generator=g, device=dev)
            blk = max(1, min(2048, n))
            if name == "threshold_sparsify":
                _, t = top_k_indices(x, _k(n, 0.05))
                kern = lambda: topk_mask.threshold_sparsify_cuda(x, t)
                plain = lambda: topk_mask.threshold_sparsify_plain(x, t)
                nbytes = 12 * n + 4
                ops = 3 * n
            elif name == "qsgd_quantize":
                kern = lambda: qsgd.qsgd_quantize_cuda(x, u, 8, blk)
                plain = lambda: qsgd.qsgd_quantize_plain(x, u, 8, blk)
                nb = -(-n // blk)
                nbytes = 8 * n + nb * blk + 4 * nb
                ops = 8 * n
            else:
                kern = lambda: bitpack.qsgd_pack_cuda(x, u, 4, blk)
                plain = lambda: bitpack.qsgd_pack_plain(x, u, 4, blk)
                nb = -(-n // blk)
                nbytes = 8 * n + nb * blk // 2 + 4 * nb
                ops = 10 * n
            err = max_abs_err(kern(), plain())
            torch.cuda.synchronize()
            if err != 0.0:
                fail(f"{name} n={n}: kernel differs from its plain version "
                     f"(max abs err {err})")
            worst = max(worst, err)
            reps = 20 if n > 1 << 24 else 200
            ms, plain_ms = cuda_ms(kern, reps), cuda_ms(plain, reps)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           ops / F32_OPS_PER_S) * 1e3
            print(f"kernel {name:18s} n={n:>11,} bit-equal=yes "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} "
                  f"(bytes={nbytes:,}, {100 * bound_ms / ms:.0f}% of bound)",
                  flush=True)
            results[name] = dict(n=n, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms,
                                 bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                                 >= ops / F32_OPS_PER_S else "operations",
                                 max_abs_err=worst)
            del x, u
    return results


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def run_sim(model, spec, backend, clients, seq, batch, rounds, dev,
            local_steps, local_lr):
    from repro_torch.core.engine import run_rounds
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import FedDataConfig, sample_round

    fl = FLConfig(uplink_compressor=spec, backend=backend,
                  local_steps=local_steps, local_lr=local_lr)
    sim = make_sim_step(model, fl, clients, chunk=seq, device=dev)
    data = FedDataConfig(vocab_size=model.cfg.vocab_size, num_clients=clients,
                         seq_len=seq, batch_per_client=batch,
                         heterogeneity=1.5)
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
    from repro_torch.kernels import bitpack, qsgd, topk_mask
    return {"threshold_sparsify": topk_mask.launches,
            "qsgd_quantize": qsgd.launches, "qsgd_pack": bitpack.launches}


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
                sim, state, ms = run_sim(model, spec, backend,
                                         PAPER_LM_CLIENTS, PAPER_LM_SEQ,
                                         PAPER_LM_BATCH, PAPER_LM_ROUNDS, dev,
                                         2, 0.2)
            secs = time.perf_counter() - t0
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            for name, count in ran.items():
                if (count > 0) != (backend == "kernel" and
                                   name in expect[spec]):
                    fail(f"paper_lm {spec} backend={backend}: {name} "
                         f"launched {count} times")
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


def llama_phase(dev):
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch("llama3_2_1b")
    model = Model(cfg)
    spec = CHAINS[1]
    print(f"llama3_2_1b: {model.param_count():,} params, {cfg.num_layers} "
          f"layers (no depth cut), d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; {LLAMA_CLIENTS} clients, seq "
          f"{LLAMA_SEQ}, batch {LLAMA_BATCH}, {LLAMA_ROUNDS} rounds of "
          f"{spec} backend=kernel", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sim, state, ms = run_sim(model, spec, "kernel", LLAMA_CLIENTS,
                                 LLAMA_SEQ, LLAMA_BATCH, LLAMA_ROUNDS, dev, 1,
                                 0.05)
    secs = time.perf_counter() - t0
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    if not (ran["threshold_sparsify"] and ran["qsgd_pack"]):
        fail(f"llama3_2_1b: the fused chain did not run its kernels {ran}")
    losses = [float(v) for v in ms["loss"]]
    if not all(v == v and abs(v) < 1e6 for v in losses):
        fail(f"llama3_2_1b: loss not finite {losses}")
    check_ledger(sim, ms, LLAMA_CLIENTS, "llama3_2_1b")
    for t in _tensors(state.params):
        if not bool(torch.isfinite(t).all()):
            fail("llama3_2_1b: non-finite parameters")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"llama3_2_1b: loss per round {[round(v, 6) for v in losses]} "
          f"up={float(ms['ledger'].uplink_wire[0]):,.0f} B/round, ledger == "
          f"static terms, launches {ran}, peak memory {peak:.1f} GiB, "
          f"{secs:.2f}s under the profiler", flush=True)
    print_profile(prof, secs, "llama3_2_1b")


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
            if any(f"{k}(" in e.key for k in OUR_KERNELS)]
    for e in ours:
        print(f"  {dev_us(e) / 1e3:9.2f} ms  {e.count:6d} launches  "
              f"{e.key[:90]} (port kernel)")


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
    from repro_torch.kernels import bitpack, build, qsgd, topk_mask

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

    # the main path's launch counts: every counter at 0 just before it,
    # read just after (the comparisons above do not count)
    for mod in (topk_mask, qsgd, bitpack):
        mod.launches = 0
    paper_lm_phase(dev)
    llama_phase(dev)
    launches = launch_counts()
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was never launched on the main path")
    print(f"main-path launches {launches}", flush=True)

    meta = {
        "threshold_sparsify": ("src/repro_torch/kernels/csrc/topk_mask.cu",
                               "src/repro/kernels/topk_mask.py:31"),
        "qsgd_quantize": ("src/repro_torch/kernels/csrc/qsgd.cu",
                          "src/repro/kernels/qsgd.py:35"),
        "qsgd_pack": ("src/repro_torch/kernels/csrc/bitpack.cu",
                      "src/repro/kernels/bitpack.py:108"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        k = kern[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None,
                     "n": k["n"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
