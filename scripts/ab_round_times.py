"""Round times of paper_lm's sim round for two source trees of the port,
read on one card in one call: each tree runs in fresh processes in the
order A, B, B, A, A, B, B, A, so that a drift of the card or the host
across the call falls on both trees alike.

    python3 scripts/ab_round_times.py --a PARENT/src --b src

``PARENT`` is a ``git archive`` of the commit to compare against, unpacked
into a directory that ``.gitignore`` lists.  Every process runs 20
synchronised rounds of ``chip_smoke.py``'s phase 4 (EF
``topk:0.05>>qsgd:8`` on the kernel backend, 8 clients, seq 32, batch 2,
E=2, lr 0.2) and prints one JSON line with its round times, its losses and
the number of ATen operators that one client's local step (the loss and
its gradient on the first client's batch) dispatches.  The script then
prints, for each tree, the median, the quartiles and the mean of the
rounds after the first two of every run (the first builds and warms up)
and that operator count, the card's name and power limit, and whether
the two trees' losses are bit-identical.  It needs one CUDA card.
"""
import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

SPEC = "topk:0.05>>qsgd:8"
CLIENTS, SEQ, BATCH, ROUNDS, WARMUP = 8, 32, 2, 20, 2


def child(args):
    # cuBLAS needs this before its first handle for deterministic GEMMs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    sys.path.insert(0, os.path.abspath(args.child))
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import run_rounds
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import FedDataConfig, sample_round
    from repro_torch.kernels import build
    from repro_torch.models.model import Model

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    build.build()
    model = Model(get_arch("paper_lm"))
    fl = FLConfig(backend="kernel", local_steps=2, local_lr=0.2,
                  uplink_compressor=SPEC)
    sim = make_sim_step(model, fl, CLIENTS, chunk=SEQ, device=dev)
    data = FedDataConfig(vocab_size=model.cfg.vocab_size,
                         num_clients=CLIENTS, seq_len=SEQ,
                         batch_per_client=BATCH, heterogeneity=1.5)
    state = sim.init_fn(0)
    ops = step_ops(model, state.params, sample_round(data, 0, dev))
    times, losses = [], []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run_rounds(sim.engine, state,
                              lambda r: sample_round(data, r, dev), 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"][0]))
    print(json.dumps({"src": args.child, "times": times, "losses": losses,
                      "ops_per_step": ops}), flush=True)


def step_ops(model, params, batch):
    """ATen operators dispatched by the loss and its gradient on client 0's
    batch (each is one launch or less on the card)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, fn, types, args=(), kwargs=None):
            self.n[str(fn)] += 1
            return fn(*args, **(kwargs or {}))

    leaves = [t.detach().requires_grad_(True) for t in params.values()]
    b = {k: batch[k][0] for k in ("tokens", "labels", "mask")}
    with Count() as count:
        loss = model.loss(dict(zip(params, leaves)), b)[0]
        torch.autograd.grad(loss, leaves)
    return sum(count.n.values())


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", help="the first tree's src directory")
    ap.add_argument("--b", help="the second tree's src directory")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args)
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    print(card_line(), flush=True)
    runs = {"a": [], "b": []}
    for tree in ("a", "b", "b", "a") * 2:
        src = getattr(args, tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *sys.argv[1:], "--child", src],
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            print(f"ab_round_times: the run of {src} failed "
                  f"(rc {out.returncode})", file=sys.stderr)
            return 1
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs[tree].append(run)
        print(f"{tree} {src}: round times "
              f"{', '.join(f'{t:.4f}' for t in run['times'])} s", flush=True)
    summary = {"arch": "paper_lm", "spec": SPEC, "card": card_line()}
    for tree, rs in runs.items():
        steady = [t for r in rs for t in r["times"][WARMUP:]]
        q1, med, q3 = statistics.quantiles(steady, n=4)
        summary[tree] = {"src": getattr(args, tree), "median_s": med,
                         "quartiles_s": [q1, q3],
                         "run_medians_s": [statistics.median(
                             r["times"][WARMUP:]) for r in rs],
                         "mean_s": statistics.fmean(steady),
                         "rounds": len(steady),
                         "ops_per_step": sorted({r["ops_per_step"]
                                                 for r in rs})}
    summary["losses_identical"] = all(
        r["losses"] == runs["a"][0]["losses"]
        for r in runs["a"] + runs["b"])
    summary["b_over_a"] = summary["b"]["median_s"] / summary["a"]["median_s"]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
