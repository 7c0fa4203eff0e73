"""Federated training CLI, sim path (port of ``repro.launch.train``):
clients run one after another on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_lm \\
        --compressor "topk:0.05>>qsgd:8" --backend kernel

``--downlink lfl8`` QSGD-quantizes the broadcast model (LFL).
``--population N --cohort M`` runs the streaming-cohort path: N clients
exist, M train each round, and per-client pipeline state lives in a
residual store of ``--store-capacity`` slots that evicts by
``--eviction`` (drop or sketch):

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_lm \\
        --population 1000000 --cohort 16 --store-capacity 64 \\
        --compressor "topk:0.05>>qsgd:8" --backend kernel --seq 48 \\
        --batch-per-client 4 --rounds 4

``--algorithm`` takes fedavg, fedsgd, fedprox, scaffold (control
variates) or feddane (a gradient round before the corrected solves);
``--server-opt`` fedavg, fedavgm, fedadam or fedyogi.  The sim path
evaluates the global model on a held-out batch (``eval_batch``) every
``--eval-every`` rounds (0: every 8, the reference's default chunk) and
prints it as ``eval=`` on that round's line:

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_lm \
        --algorithm scaffold --server-opt fedadam --eval-every 2

``--device`` defaults to ``cuda`` and the run fails without a card unless
``--device cpu`` is given.  The reference CLI's mesh, async, scenario
(other than ``--scenario-availability`` under ``--population``), tracing
and selection options are not ported yet; ``--async`` and the other
``--scenario-*`` flags raise.
"""
from __future__ import annotations

import argparse
import time

# the reference's other --scenario-* flags and their defaults
_NOT_PORTED_SCENARIO = (("--scenario-trace", "static"),
                        ("--scenario-period", 24.0),
                        ("--scenario-dropout", 0.0),
                        ("--scenario-epoch-scale", 0.0),
                        ("--scenario-deadline-quantile", 0.0),
                        ("--scenario-seed", 0))


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
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out-eval cadence in rounds "
                         "(FLConfig.eval_every); 0 = every 8 rounds")
    ap.add_argument("--server-opt", default="fedavg",
                    help="fedavg, fedavgm, fedadam or fedyogi")
    ap.add_argument("--population", type=int, default=0,
                    help="simulate this many clients on the streaming "
                         "ClientPopulation path: per-round cohorts and a "
                         "bounded residual store")
    ap.add_argument("--cohort", type=int, default=1024,
                    help="clients sampled per round (population mode)")
    ap.add_argument("--store-capacity", type=int, default=0,
                    help="residual-store slots (0 = min(population, "
                         "2 x cohort))")
    ap.add_argument("--eviction", default="drop", choices=["drop", "sketch"],
                    help="residual-store eviction: drop the evicted "
                         "client's pipeline state, or fold it into the "
                         "count-sketch tail")
    ap.add_argument("--scenario-availability", type=float, default=1.0,
                    help="per-round availability rate in (0, 1] of the "
                         "sampled clients (population mode only)")
    # reference options that the port does not run: set, they raise
    ap.add_argument("--async", dest="async_mode", action="store_true")
    for flag, default in _NOT_PORTED_SCENARIO:
        ap.add_argument(flag, type=type(default), default=default)
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
    from repro_torch.data.synthetic import (FedDataConfig, eval_batch,
                                            sample_round)
    from repro_torch.device import not_ported, resolve_device
    from repro_torch.models.model import Model

    if args.async_mode:
        raise not_ported("--async", "repro.core.async_engine")
    for flag, default in _NOT_PORTED_SCENARIO:
        if getattr(args, flag[2:].replace("-", "_")) != default:
            raise not_ported(flag, "repro.core.scenario")
    if args.scenario_availability != 1.0 and args.population <= 0:
        raise not_ported("--scenario-availability without --population",
                         "repro.core.scenario")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    model = Model(cfg)
    fl = FLConfig(algorithm=args.algorithm, local_steps=args.local_steps,
                  local_lr=args.local_lr, uplink_compressor=args.compressor,
                  downlink_compressor=args.downlink, backend=args.backend,
                  server_opt=args.server_opt,
                  eval_every=args.eval_every if args.eval_every > 0 else 8,
                  seed=args.seed)
    if args.population > 0:
        return _population(args, cfg, model, fl, device)
    sim = make_sim_step(model, fl, args.clients, chunk=args.seq,
                        device=device)
    data = FedDataConfig(vocab_size=cfg.vocab_size, num_clients=args.clients,
                         seq_len=args.seq,
                         batch_per_client=args.batch_per_client,
                         heterogeneity=1.5, seed=args.seed)
    print(f"sim arch={cfg.name} clients={args.clients} "
          f"params={model.param_count():,} device={device} "
          f"uplink={args.compressor} downlink={args.downlink} "
          f"backend={args.backend} algorithm={args.algorithm} "
          f"server_opt={args.server_opt} eval_every={fl.eval_every}",
          flush=True)
    ev = eval_batch(data, 99, batch_size=4, device=device)

    def metrics_fn(st, m):
        # the held-out loss of the global model, on the rounds that
        # run_rounds' cadence gates in
        with torch.no_grad():
            loss = model.loss(st.params, ev, chunk=args.seq)[0]
        return dict(m, eval_loss=loss)

    state = sim.init_fn(args.seed)
    t0 = time.perf_counter()
    state, ms = run_rounds(sim.engine, state,
                           lambda r: sample_round(data, r, device),
                           args.rounds, metrics_fn=metrics_fn)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    for i in range(args.rounds):
        ev_loss = float(ms["eval_loss"][i])
        print(f"round {i:>3} loss={float(ms['loss'][i]):.3f} "
              f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB "
              f"ratio={float(ms['ledger'].compression_ratio()[i]):.1f}x"
              + (f" eval={ev_loss:.3f}" if ev_loss == ev_loss else ""),
              flush=True)
    print(f"{args.rounds} rounds in {secs:.2f}s on {device}")
    return state, ms


def _population(args, cfg, model, fl, device):
    """The streaming-cohort path: --population clients exist, --cohort
    train per round, per-client pipeline state bounded by the store."""
    import torch

    from repro_torch.compress.residual_store import store_nbytes
    from repro_torch.core.engine import Topology, make_round_engine, run_rounds
    from repro_torch.core.population import ClientPopulation
    from repro_torch.data.pipeline import cohort_data_fn
    from repro_torch.data.synthetic import FedDataConfig

    N = args.population
    pop = ClientPopulation(n_clients=N, cohort=min(args.cohort, N),
                           capacity=args.store_capacity,
                           eviction=args.eviction,
                           availability=args.scenario_availability)
    data = FedDataConfig(vocab_size=cfg.vocab_size, num_clients=N,
                         seq_len=args.seq,
                         batch_per_client=args.batch_per_client,
                         heterogeneity=1.5, seed=args.seed)
    data_fn = cohort_data_fn(pop, data, device)
    engine = make_round_engine(model, fl, Topology.sim(N), chunk=args.seq,
                               device=device, population=pop)
    state = engine.init_fn(args.seed)
    mb = (store_nbytes(state.comm_state) / 1e6
          if state.comm_state is not None else 0.0)
    print(f"population={N:,} cohort={pop.cohort} capacity={pop.capacity} "
          f"eviction={pop.eviction} store={mb:.1f}MB "
          f"params={model.param_count():,} sync device={device} "
          f"uplink={args.compressor} backend={args.backend}", flush=True)
    t0 = time.perf_counter()
    state, ms = run_rounds(engine, state, data_fn, args.rounds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    for i in range(args.rounds):
        print(f"round {i:>4} loss={float(ms['loss'][i]):.3f} "
              f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB",
              flush=True)
    print(f"{args.rounds} rounds in {secs:.2f}s on {device}")
    return state, ms


if __name__ == "__main__":
    main()
