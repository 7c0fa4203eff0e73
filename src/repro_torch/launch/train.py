"""Federated training CLI, sim path (port of ``repro.launch.train``):
clients run one after another on one card.  ``--arch`` takes every arch
of ``repro_torch.configs`` (an id or its alias) at its full config but
``whisper_base`` and ``internvl2_76b``, whose batches need the stubbed
frontend's embeddings, which the synthetic FL data does not carry.

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

Privacy rides the spec, as in the reference (which has no privacy
flags): ``--compressor "topk:0.05>>qsgd:4>>dpnoise:0.8>>secagg"`` clips
and noises each client's update and masks its integer code planes.  The
``--scenario-*`` flags set the client dynamics (``core.scenario``): an
availability ``--scenario-trace`` (static, square or diurnal, with
``--scenario-period``) at ``--scenario-availability``, mid-round
``--scenario-dropout``, per-client step budgets ``--scenario-epoch-scale``
and, under ``--async``, a flush deadline tracking
``--scenario-deadline-quantile``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_lm \
        --clients 16 --scenario-trace square --scenario-availability 0.5 \
        --scenario-dropout 0.3 --compressor "qsgd:4>>secagg"

``--trace PATH`` turns ``FLConfig.telemetry`` on and writes the flight
recorder's JSONL trace (a ``meta`` header, one span per round, the
``stages`` record, one ``round`` record per round or event, ``eval`` and
``flush`` events, a ``checkpoint`` span); ``--profile-dir DIR`` also runs
the rounds under ``torch.profiler`` and writes its Chrome / TensorBoard
trace into DIR; ``--checkpoint PATH`` saves the final params in the
reference's npz format (``repro_torch.checkpoint``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_lm \
        --compressor "topk:0.05>>qsgd:8" --backend kernel --rounds 4 \
        --trace run.jsonl --profile-dir prof --checkpoint ckpt.npz
    PYTHONPATH=src python -m repro_torch.obs.report run.jsonl

``--nproc N`` (the reference's ``--devices``) runs the deployment path:
N ranks of a ``torch.distributed`` group, spawned here, each one client,
with ``--dist-backend`` nccl (rank r on ``cuda:r``, one card each) or
gloo (every rank on ``cuda:0``, or on the CPU with ``--device cpu``).
Without ``--population`` or ``--async`` that is the star: every round's
uplink is a collective whose operand is the encoded payload.
``--hierarchical`` runs client -> edge -> cloud on a (pod, data) mesh of
2 pods when N is even and above 1 (else 1), the cloud hop every
``--sync-every`` rounds.  Rank 0 prints.  In a process that already is a
rank of an N-rank group, ``main`` runs that rank's part instead of
spawning:

    PYTHONPATH=src python -m repro_torch.launch.train --nproc 4 \
        --device cpu --dist-backend gloo --compressor "topk:0.05>>qsgd:8"
    PYTHONPATH=src python -m repro_torch.launch.train --nproc 2 \
        --dist-backend gloo --hierarchical --sync-every 2

With ``--nproc``, ``--trace`` writes rank 0's trace (topology ``star`` or
``hier``) with every rank's telemetry on, ``--profile-dir`` has every rank
write its own ``torch.profiler`` trace (``rank<r>.*``) into DIR, and
``--checkpoint`` saves rank 0's final params (hier: pod 0's model):

    PYTHONPATH=src python -m repro_torch.launch.train --nproc 4 \
        --device cpu --dist-backend gloo --compressor "topk:0.05>>qsgd:8" \
        --trace run.jsonl --profile-dir prof --checkpoint ckpt.npz

One card cannot hold two NCCL ranks of one communicator, so on one card
several ranks share it over gloo (staging each collective through the
host) and NCCL runs at one rank.  ``--model-parallel M`` puts the star on
the reference's ``make_host_mesh(model=min(M, N))``: N / M clients, each
trained whole by its M model ranks, every rank encoding its block of
each leaf (``repro_torch.models.sharding``); ``--hierarchical`` on a
model axis is not ported.  ``--population`` stays on the single-process path,
as in the reference; a population on the star is built through
``make_round_engine(..., Topology.star(), mesh=, population=)``.

``--device`` defaults to ``cuda`` and the run fails without a card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time


# families whose batches need a stubbed frontend's embeddings
FRONTEND_INPUTS = {"encdec": "frontend", "vlm": "patches"}


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
    ap.add_argument("--scenario-trace", default="static",
                    choices=["static", "diurnal", "square"],
                    help="client availability trace: static = i.i.d. "
                         "Bernoulli, square = phase-shifted duty windows, "
                         "diurnal = sinusoid-modulated Bernoulli")
    ap.add_argument("--scenario-period", type=float, default=24.0,
                    help="availability trace period, in rounds")
    ap.add_argument("--scenario-availability", type=float, default=1.0,
                    help="availability duty-cycle rate in (0, 1]; sets "
                         "both the dense selection hop's rate and the "
                         "population's under --population")
    ap.add_argument("--scenario-dropout", type=float, default=0.0,
                    help="mid-round dropout hazard per unit virtual time; "
                         "dropped clients become zero-weight rows")
    ap.add_argument("--scenario-epoch-scale", type=float, default=0.0,
                    help="floor in (0, 1] of the per-client local-epoch "
                         "scale (FedMCCS capability latency); 0 disables")
    ap.add_argument("--scenario-deadline-quantile", type=float, default=0.0,
                    help="async: the flush deadline tracks this "
                         "completion-time quantile; 0 disables")
    ap.add_argument("--scenario-seed", type=int, default=0,
                    help="seed for the scenario's phase and dropout draws")
    ap.add_argument("--nproc", type=int, default=0,
                    help="run N ranks of a torch.distributed group, one "
                         "client each (the star, or --hierarchical); 0 = "
                         "the single-process sim path")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="process-group backend with --nproc: nccl puts "
                         "rank r on cuda:r, gloo puts every rank on cuda:0 "
                         "(or on the CPU with --device cpu)")
    ap.add_argument("--hierarchical", action="store_true",
                    help="with --nproc: client -> edge (pod) -> cloud")
    ap.add_argument("--sync-every", type=int, default=4,
                    help="hierarchical: the cloud hop's period in rounds")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="with --nproc N: the model axis' size M (the "
                         "star only): N / M clients, each trained by its "
                         "M model ranks, each encoding its block of every "
                         "leaf")
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--checkpoint", default="", metavar="PATH",
                    help="save the final params here (npz, the "
                         "reference's format)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="flight recorder: write a schema-versioned JSONL "
                         "trace here (spans, events and one record per "
                         "round); implies FLConfig.telemetry. Render with "
                         "python -m repro_torch.obs.report PATH")
    ap.add_argument("--profile-dir", default="", metavar="DIR",
                    help="with --trace: also run the rounds under "
                         "torch.profiler and write its trace into DIR")
    return ap.parse_args(argv)


def _tracer(args):
    """The run's Tracer when ``--trace`` was given, else None."""
    if not args.trace:
        return None
    from repro_torch.obs.trace import Tracer
    topo = ("population" if args.population > 0 else
            "async" if args.async_mode else "sim")
    if args.population > 0 and args.async_mode:
        topo = "population-async"
    return Tracer(args.trace, profile_dir=args.profile_dir,
                  meta=dict(arch=args.arch, topology=topo,
                            rounds=args.rounds, compressor=args.compressor,
                            algorithm=args.algorithm))


def _finish(args, tracer, engine, ms, params):
    """The run's records (the ``stages`` record, one ``round`` record per
    round, a ``flush`` event per async flush), then the checkpoint."""
    if tracer is not None:
        tracer.emit_rounds(ms, spec=engine.aux.get("telemetry"))
        if "flushed" in ms:
            for i, v in enumerate(ms["flushed"].tolist()):
                if v > 0:
                    tracer.event("flush", round=i)
    if args.checkpoint:
        from repro_torch import checkpoint
        if tracer is not None:
            with tracer.span("checkpoint", path=args.checkpoint):
                checkpoint.save(args.checkpoint, params)
        else:
            checkpoint.save(args.checkpoint, params)
        print("saved", args.checkpoint)
    if tracer is not None:
        tracer.close()
        print(f"trace: {args.trace} (render: python -m repro_torch.obs.report "
              f"{args.trace})")


def main(argv=None):
    args = _parse(argv)
    if args.nproc > 0 or args.hierarchical:
        return _spawn(args, argv)
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import run_rounds
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import (FedDataConfig, eval_batch,
                                            sample_round)
    from repro_torch.device import resolve_device
    from repro_torch.models.model import Model

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if cfg.family in FRONTEND_INPUTS:
        # before any allocation: internvl2_76b alone is 70 B params
        raise ValueError(
            f"--arch {args.arch}: the {cfg.family} family needs the stubbed "
            f"frontend's {FRONTEND_INPUTS[cfg.family]!r} embeddings in each "
            f"batch, which the synthetic FL data does not carry (nor does "
            f"the reference's); Model.loss runs it on a batch that has them")
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
                  async_flush_deadline=args.flush_deadline,
                  scenario_trace=args.scenario_trace,
                  scenario_period=args.scenario_period,
                  scenario_availability=args.scenario_availability,
                  scenario_dropout=args.scenario_dropout,
                  scenario_epoch_scale=args.scenario_epoch_scale,
                  scenario_deadline_quantile=args.scenario_deadline_quantile,
                  scenario_seed=args.scenario_seed, seed=args.seed,
                  telemetry=bool(args.trace))
    tracer = _tracer(args)
    if args.population > 0:
        return _population(args, cfg, model, fl, device, tracer)
    if args.async_mode:
        return _async(args, cfg, model, fl, device, tracer)
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
                           args.rounds, metrics_fn=metrics_fn, tracer=tracer)
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
        if tracer is not None and ev_loss == ev_loss:
            tracer.event("eval", round=i, loss=ev_loss)
    print(f"{args.rounds} rounds in {secs:.2f}s on {device}")
    _finish(args, tracer, sim.engine, ms, state.params)
    return state, ms


def _spawn(args, argv):
    """--nproc: check the request, then run the ranks (spawned: CUDA does
    not survive fork) and wait for them; rank 0 prints."""
    from repro_torch.device import not_ported, resolve_device
    from repro_torch.launch.mesh import run_ranks
    if args.hierarchical and args.model_parallel > 1:
        raise not_ported("--hierarchical on a model axis "
                         "(--model-parallel > 1)", "repro.models.sharding")
    if args.nproc < 1:
        raise ValueError("--hierarchical runs on a mesh of ranks: give "
                         "--nproc N")
    if args.population > 0 or args.async_mode:
        raise ValueError("--nproc runs the star (or --hierarchical) "
                         "topology; --population and --async run in one "
                         "process")
    resolve_device(args.device)          # no card and no --device cpu: fail
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        # already a rank of a group of --nproc ranks: run this rank's part
        if (dist.get_world_size(), dist.get_backend()) != (
                args.nproc, args.dist_backend):
            raise ValueError(
                f"this process is a rank of a {dist.get_world_size()}-rank "
                f"{dist.get_backend()} group, not --nproc {args.nproc} "
                f"--dist-backend {args.dist_backend}")
        return _rank_main(dist.get_rank(), args.nproc, None, args)
    argv = sys.argv[1:] if argv is None else list(argv)
    run_ranks(_rank_entry, args.nproc, args=(argv,))


def _rank_entry(rank, nproc, init_method, argv):
    _rank_main(rank, nproc, init_method, _parse(argv))


def _rank_main(rank, nproc, init_method, args):
    """One rank of --nproc: join the group (``init_method`` None: the
    process already is a rank of one), build the star or hier engine for
    this rank's client, run the rounds; rank 0 prints.  Returns this
    rank's final state and stacked metrics.

    ``--trace`` turns the telemetry on in every rank; rank 0 alone owns
    the Tracer (topology ``star`` or ``hier``): its round spans, its
    ``eval`` events, the ``stages`` and ``round`` records.
    ``--profile-dir`` (with ``--trace``) runs every rank's rounds under
    ``torch.profiler``, each rank writing its own trace into the
    directory, its file name starting ``rank<r>``.  ``--checkpoint``:
    rank 0 saves the global params (the star's replicated params, hier's
    pod 0 model) while the other ranks wait at a barrier."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import Topology, make_round_engine, \
        run_rounds
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import (FedDataConfig, eval_batch,
                                            sample_round)
    from repro_torch.launch.mesh import init_ranks, make_host_mesh, \
        make_mesh, rank_device
    from repro_torch.models.model import Model
    from repro_torch.obs.trace import Tracer, profiler

    if init_method is None:
        dev = rank_device(args.dist_backend, args.device, rank, nproc)
    else:
        dev = init_ranks(args.dist_backend, args.device, rank, nproc,
                         init_method)
    try:
        cfg = get_arch(args.arch)
        if cfg.family in FRONTEND_INPUTS:
            raise ValueError(f"--arch {args.arch}: the {cfg.family} family "
                             f"needs frontend embeddings the FL data does "
                             f"not carry")
        model = Model(cfg)
        fl = FLConfig(algorithm=args.algorithm, local_steps=args.local_steps,
                      local_lr=args.local_lr,
                      uplink_compressor=args.compressor,
                      downlink_compressor=args.downlink,
                      backend=args.backend, server_opt=args.server_opt,
                      selection=args.selection,
                      clients_per_round=args.clients_per_round,
                      eval_every=args.eval_every if args.eval_every > 0
                      else 8, hierarchical=args.hierarchical,
                      sync_every=args.sync_every,
                      scenario_trace=args.scenario_trace,
                      scenario_period=args.scenario_period,
                      scenario_availability=args.scenario_availability,
                      scenario_dropout=args.scenario_dropout,
                      scenario_epoch_scale=args.scenario_epoch_scale,
                      scenario_seed=args.scenario_seed, seed=args.seed,
                      telemetry=bool(args.trace))
        if args.hierarchical:
            G = 2 if nproc > 1 and nproc % 2 == 0 else 1
            mesh = make_mesh({"pod": G, "data": nproc // G, "model": 1}, dev)
            topo = Topology.hier(args.sync_every)
        else:
            mesh = make_host_mesh(model=min(args.model_parallel, nproc),
                                  device=dev)
            topo = Topology.star()
        engine = make_round_engine(model, fl, topo, chunk=args.seq,
                                   mesh=mesh)
        devices = [None] * nproc
        dist.all_gather_object(devices, str(dev))
        lead = rank == 0
        tracer = None
        if lead and args.trace:
            tracer = Tracer(args.trace, meta=dict(
                arch=args.arch, topology=topo.kind, rounds=args.rounds,
                compressor=args.compressor, algorithm=args.algorithm))
        if lead:
            print(f"{topo.kind} mesh={mesh.shape} ranks={nproc} "
                  f"backend={mesh.backend} devices={devices} "
                  f"arch={cfg.name} params={model.param_count():,} "
                  f"uplink={args.compressor} backend={args.backend}"
                  + (f" pod={fl.pod_compressor} sync_every="
                     f"{args.sync_every}" if args.hierarchical else ""),
                  flush=True)
        data = FedDataConfig(vocab_size=cfg.vocab_size,
                             num_clients=engine.n_clients,
                             seq_len=args.seq,
                             batch_per_client=args.batch_per_client,
                             heterogeneity=1.5, seed=args.seed)
        shape = (mesh.shape.get("pod", 1), mesh.shape["data"])

        def data_fn(r):
            b = sample_round(data, r, dev)
            if args.hierarchical:
                return {k: v.reshape(shape + tuple(v.shape[1:]))
                        for k, v in b.items()
                        if k in ("tokens", "labels", "mask")}
            return b
        ev = eval_batch(data, 99, batch_size=4, device=dev)

        def metrics_fn(st, m):
            with torch.no_grad():
                loss = model.loss(st.params, ev, chunk=args.seq)[0]
            return dict(m, eval_loss=loss)

        state = engine.init_fn(args.seed)
        t0 = time.perf_counter()
        with profiler(args.profile_dir if args.trace else "",
                      worker=f"rank{rank}"):
            state, ms = run_rounds(engine, state, data_fn, args.rounds,
                                   metrics_fn=metrics_fn, tracer=tracer)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        for i in range(args.rounds if lead else 0):
            ev_loss = float(ms["eval_loss"][i])
            extra = (f" pod_divergence={float(ms['pod_divergence'][i]):.3g}"
                     if "pod_divergence" in ms else
                     f" selected={int(ms['selected'][i])}")
            print(f"round {i:>3} loss={float(ms['loss'][i]):.3f}{extra} "
                  f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB "
                  f"ratio={float(ms['ledger'].compression_ratio()[i]):.1f}x"
                  + (f" eval={ev_loss:.3f}" if ev_loss == ev_loss else ""),
                  flush=True)
            if tracer is not None and ev_loss == ev_loss:
                tracer.event("eval", round=i, loss=ev_loss)
        if lead:
            print(f"{args.rounds} rounds in {secs:.2f}s on {nproc} ranks",
                  flush=True)
            _finish(args, tracer, engine, ms, state.params)
        if args.checkpoint:
            # the checkpoint exists once every rank passes
            dist.barrier(**({"device_ids": [dev.index]}
                            if mesh.backend == "nccl" else {}))
        return state, ms
    finally:
        if init_method is not None:
            dist.destroy_process_group()


def _print_events(ms, n):
    for i in range(n):
        print(f"event {i:>4} t={float(ms['clock'][i]):8.2f} "
              f"v={int(ms['server_version'][i]):>3} "
              f"tau={float(ms['staleness'][i]):>3.0f} "
              f"loss={float(ms['loss'][i]):.3f} "
              f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB",
              flush=True)


def _async(args, cfg, model, fl, device, tracer=None):
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
    state, ms = run_rounds(a.engine, state, data_fn, args.rounds,
                           tracer=tracer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    _print_events(ms, args.rounds)
    print(f"{args.rounds} events, {int(ms['server_version'][-1])} flushes "
          f"in {secs:.2f}s on {device}")
    _finish(args, tracer, a.engine, ms, state.params)
    return state, ms


def _population(args, cfg, model, fl, device, tracer=None):
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
    # one availability flag for both paths: the population keeps the
    # rate, the scenario (attached by the engine) shapes the trace
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
    state, ms = run_rounds(engine, state, data_fn, args.rounds,
                           tracer=tracer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    if args.async_mode:
        _print_events(ms, args.rounds)
        print(f"{args.rounds} events in {secs:.2f}s on {device}")
        _finish(args, tracer, engine, ms, state.params)
        return state, ms
    for i in range(args.rounds):
        print(f"round {i:>4} loss={float(ms['loss'][i]):.3f} "
              f"selected={int(ms['selected'][i])} "
              f"up={float(ms['ledger'].uplink_wire[i]) / 1e6:.2f}MB",
              flush=True)
    print(f"{args.rounds} rounds in {secs:.2f}s on {device}")
    _finish(args, tracer, engine, ms, state.params)
    return state, ms


if __name__ == "__main__":
    main()
