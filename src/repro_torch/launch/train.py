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

``--selection`` takes all, random, power_of_choice or multi_criteria, with
``--clients-per-round`` m of the ``--clients``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_lm \
        --clients 16 --selection power_of_choice --clients-per-round 4

``--async`` runs the virtual-clock engine: ``--clients`` slots, FedBuff
with ``--buffer-size`` K (1 = FedAsync, 0 = every slot), staleness decay
``--staleness-alpha``, latencies from ``--latency-profile`` and, with
``--flush-deadline`` > 0, a flush whenever the clock passes the last
flush plus the deadline; ``--rounds`` then counts server events (client
uploads).  With ``--population`` the slots are the cohort:

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_lm \
        --async --clients 8 --buffer-size 4 --latency-profile heavy_tail \
        --compressor "topk:0.05>>qsgd:8" --backend kernel --rounds 32

``--device`` defaults to ``cuda`` and the run fails without a card unless
``--device cpu`` is given.  The reference CLI's mesh, scenario (other
than ``--scenario-availability`` under ``--population``) and tracing
options are not ported yet; the other ``--scenario-*`` flags raise.
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
    ap.add_argument("--selection", default="all",
                    help="all, random, power_of_choice or multi_criteria")
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="clients the selection policy takes per round "
                         "(0 = all)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="AsyncEngine: virtual-clock buffered async FL; "
                         "--rounds then counts server events (client "
                         "uploads), not synchronous rounds")
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="async FedBuff K (1 = FedAsync, 0 = n_clients "
                         "= the synchronous limit)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="async staleness decay (1+tau)^(-alpha); also "
                         "scales the adaptive server-opt moments by the "
                         "flushed buffer's mean staleness")
    ap.add_argument("--latency-profile", default="heavy_tail",
                    choices=["constant", "resource", "uniform", "heavy_tail"])
    ap.add_argument("--flush-deadline", type=float, default=0.0,
                    help="async adaptive buffer sizing: also flush when the "
                         "virtual clock passes the last flush + deadline "
                         "(0 = count-only FedBuff)")
    ap.add_argument("--population", type=int, default=0,
                    help="simulate this many clients on the streaming "
                         "ClientPopulation path (works with --async too): "
                         "per-round cohorts and a bounded residual store")
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
                  server_opt=args.server_opt, selection=args.selection,
                  clients_per_round=args.clients_per_round,
                  eval_every=args.eval_every if args.eval_every > 0 else 8,
                  async_buffer_size=args.buffer_size,
                  staleness_alpha=args.staleness_alpha,
                  latency_profile=args.latency_profile,
                  async_flush_deadline=args.flush_deadline, seed=args.seed)
    if args.population > 0:
        return _population(args, cfg, model, fl, device)
    if args.async_mode:
        return _async(args, cfg, model, fl, device)
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
          f"server_opt={args.server_opt} eval_every={fl.eval_every} "
          f"selection={args.selection}", flush=True)
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
              f"selected={int(ms['selected'][i])} "
              f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB "
              f"ratio={float(ms['ledger'].compression_ratio()[i]):.1f}x"
              + (f" eval={ev_loss:.3f}" if ev_loss == ev_loss else ""),
              flush=True)
    print(f"{args.rounds} rounds in {secs:.2f}s on {device}")
    return state, ms


def _print_events(ms, n):
    for i in range(n):
        print(f"event {i:>4} t={float(ms['clock'][i]):8.2f} "
              f"v={int(ms['server_version'][i]):>3} "
              f"tau={float(ms['staleness'][i]):>3.0f} "
              f"loss={float(ms['loss'][i]):.3f} "
              f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB",
              flush=True)


def _async(args, cfg, model, fl, device):
    """The virtual-clock path: --rounds counts server events."""
    import torch

    from repro_torch.core.async_engine import make_async_step
    from repro_torch.core.engine import run_rounds
    from repro_torch.data.synthetic import FedDataConfig, sample_round

    data = FedDataConfig(vocab_size=cfg.vocab_size, num_clients=args.clients,
                         seq_len=args.seq,
                         batch_per_client=args.batch_per_client,
                         heterogeneity=1.5, seed=args.seed)

    def data_fn(v):
        return sample_round(data, v, device)

    a = make_async_step(model, fl, args.clients, data_fn, chunk=args.seq,
                        device=device)
    print(f"async arch={cfg.name} clients={args.clients} "
          f"K={a.buffer_size} alpha={args.staleness_alpha} "
          f"profile={args.latency_profile} "
          f"deadline={args.flush_deadline or 'off'} "
          f"params={model.param_count():,} device={device} "
          f"uplink={args.compressor} backend={args.backend}", flush=True)
    state = a.init_fn(args.seed)
    t0 = time.perf_counter()
    state, ms = run_rounds(a.engine, state, data_fn, args.rounds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    _print_events(ms, args.rounds)
    print(f"{args.rounds} events, {int(ms['server_version'][-1])} flushes "
          f"in {secs:.2f}s on {device}")
    return state, ms


def _population(args, cfg, model, fl, device):
    """The streaming-cohort path: --population clients exist, --cohort
    train per round (per generation under --async), per-client pipeline
    state bounded by the store."""
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
    topo = Topology.async_(N) if args.async_mode else Topology.sim(N)
    engine = make_round_engine(model, fl, topo, chunk=args.seq,
                               device=device, data_fn=data_fn,
                               population=pop)
    state = engine.init_fn(args.seed)
    mb = (store_nbytes(state.comm_state) / 1e6
          if state.comm_state is not None else 0.0)
    print(f"population={N:,} cohort={pop.cohort} capacity={pop.capacity} "
          f"eviction={pop.eviction} store={mb:.1f}MB "
          f"params={model.param_count():,} "
          f"{'async' if args.async_mode else 'sync'} device={device} "
          f"uplink={args.compressor} backend={args.backend}", flush=True)
    t0 = time.perf_counter()
    state, ms = run_rounds(engine, state, data_fn, args.rounds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    if args.async_mode:
        _print_events(ms, args.rounds)
        print(f"{args.rounds} events in {secs:.2f}s on {device}")
        return state, ms
    for i in range(args.rounds):
        print(f"round {i:>4} loss={float(ms['loss'][i]):.3f} "
              f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB",
              flush=True)
    print(f"{args.rounds} rounds in {secs:.2f}s on {device}")
    return state, ms


if __name__ == "__main__":
    main()
