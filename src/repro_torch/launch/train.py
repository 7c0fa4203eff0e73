"""Federated training CLI, sim path (port of ``repro.launch.train``):
clients run one after another on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_lm \\
        --compressor "topk:0.05>>qsgd:8" --backend kernel

``--downlink lfl8`` QSGD-quantizes the broadcast model (LFL).  ``--device``
defaults to ``cuda`` and the run fails without a card unless ``--device
cpu`` is given.  The reference CLI's mesh, async, population, scenario,
tracing, selection and server-optimizer options are not ported yet.
"""
from __future__ import annotations

import argparse
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_lm")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--algorithm", default="fedavg")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-lr", type=float, default=0.2)
    ap.add_argument("--compressor", default="none")
    ap.add_argument("--downlink", default="none")
    ap.add_argument("--backend", default="jax", choices=["jax", "kernel"],
                    help="encode backend for every wire hop: jax = the "
                         "plain PyTorch path, kernel = the CUDA kernels")
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import run_rounds
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import FedDataConfig, sample_round
    from repro_torch.device import resolve_device
    from repro_torch.models.model import Model

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    model = Model(cfg)
    fl = FLConfig(algorithm=args.algorithm, local_steps=args.local_steps,
                  local_lr=args.local_lr, uplink_compressor=args.compressor,
                  downlink_compressor=args.downlink, backend=args.backend,
                  seed=args.seed)
    sim = make_sim_step(model, fl, args.clients, chunk=args.seq,
                        device=device)
    data = FedDataConfig(vocab_size=cfg.vocab_size, num_clients=args.clients,
                         seq_len=args.seq,
                         batch_per_client=args.batch_per_client,
                         heterogeneity=1.5, seed=args.seed)
    print(f"sim arch={cfg.name} clients={args.clients} "
          f"params={model.param_count():,} device={device} "
          f"uplink={args.compressor} downlink={args.downlink} "
          f"backend={args.backend}", flush=True)
    state = sim.init_fn(args.seed)
    t0 = time.perf_counter()
    state, ms = run_rounds(sim.engine, state,
                           lambda r: sample_round(data, r, device),
                           args.rounds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    for i in range(args.rounds):
        print(f"round {i:>3} loss={float(ms['loss'][i]):.3f} "
              f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB "
              f"ratio={float(ms['ledger'].compression_ratio()[i]):.1f}x",
              flush=True)
    print(f"{args.rounds} rounds in {secs:.2f}s on {device}")
    return state, ms


if __name__ == "__main__":
    main()
