"""Ranks, process groups and the named client mesh (port of
``repro.launch.mesh``).

The reference lays FL clients on the axes of a device mesh and runs the
round inside ``shard_map``.  The port makes each (client, model block)
one process (a *rank*) of a ``torch.distributed`` group and keeps the
reference's axis names: ``pod``, ``data`` and ``model``.  Ranks map to
coordinates pod-major, then data, with model minor, ``rank = (pod *
data_size + data) * model_size + model``: the reference's device order,
the order ``aggregation.client_index`` assumes and the order an
``all_gather`` over the client axes (and ``model``) returns.  One
sub-group is made per axis slice: each pod's data ranks (the edge hop of
the hierarchy), each data index's pod ranks (the cloud hop), and on a
model axis each client's model ranks and the client axes together with
``model`` (the star's wire, ``repro_torch.models.sharding``).

:func:`init_ranks` joins the process group.  The caller always names the
backend: ``nccl`` puts rank r on ``cuda:r`` (one card per rank), ``gloo``
puts every rank on ``cuda:0`` when the card is asked for (so one card can
hold several ranks) and on the CPU only when the CPU is asked for.  Nothing
is switched automatically (ranks on the CPU split the host's cores
between them).  A process-group ``timeout`` turns a rank that
hangs into an error on the others.  :func:`run_ranks` starts the ranks as
``spawn`` processes (CUDA does not survive ``fork``) and fails if one of
them fails or outlives its time.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import socket
import time

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    """A free TCP port on ``localhost`` for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(backend: str, device, rank: int, world_size: int):
    """The device of ``rank`` under ``backend`` (made current when it is a
    card): ``device`` is ``None`` / ``"cuda"`` (the default: the card) or
    ``"cpu"``, so that a run without a card fails unless the CPU was asked
    for."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; use "
                             "--dist-backend gloo for ranks on the CPU")
        if rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"nccl puts rank {rank} on cuda:{rank}, but this machine has "
                f"{torch.cuda.device_count()} card(s); NCCL cannot put two "
                f"ranks of one communicator on one card — use gloo, which "
                f"shares cuda:0")
        dev = torch.device("cuda", rank)
    elif dev.type == "cuda":
        dev = torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # ranks on one host's CPU share its cores
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                                  // world_size))
    return dev


def init_ranks(backend: str, device, rank: int, world_size: int,
               init_method: str, timeout: float = DEFAULT_TIMEOUT_S):
    """Join the process group as ``rank`` of ``world_size`` and return this
    rank's device (:func:`rank_device`, resolved before anything joins)."""
    dev = rank_device(backend, device, rank, world_size)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """The named client mesh over the process group: ``shape`` maps each
    axis name (``pod``, ``data``, ``model``) to its size, in the
    reference's axis order; ``groups`` maps each axis subset to this rank's
    ``(process group, its global ranks in axis order)``."""
    shape: dict
    rank: int
    device: torch.device
    backend: str
    groups: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def coords(self, rank: int = None) -> dict:
        """A rank's coordinate on each axis, pod-major and model-minor."""
        r = self.rank if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def axis_index(self, name: str) -> int:
        return self.coords()[name]

    def group(self, axes) -> tuple:
        """``(process group, global ranks)`` of this rank's slice along
        ``axes`` (a tuple of axis names), the ranks in axis order."""
        return self.groups[tuple(axes)]


def _slices(shape: dict, axes: tuple) -> list:
    """Every slice of the mesh along ``axes``: lists of global ranks, each
    in axis order (pod-major)."""
    names = tuple(shape)
    other = [a for a in names if a not in axes]
    out = {}
    for r in range(_prod(shape.values())):
        c, rem = {}, r
        for name in reversed(names):
            c[name] = rem % shape[name]
            rem //= shape[name]
        out.setdefault(tuple(c[a] for a in other), []).append(r)
    return [out[k] for k in sorted(out)]


def _prod(vals) -> int:
    n = 1
    for v in vals:
        n *= v
    return n


def make_mesh(shape: dict, device: torch.device, axes_sets=None) -> Mesh:
    """A mesh of ``shape`` (axis name -> size) over the initialised process
    group, whose world size must equal the product of the sizes.  Every
    rank makes every sub-group, in one order (``dist.new_group`` is
    collective): for each subset in ``axes_sets`` (default: ``("data",)``,
    ``("pod",)`` and ``("pod", "data")``, those present, and with a model
    axis above 1 also ``("model",)`` and the client axes with ``model``),
    one group per slice."""
    shape = {k: int(v) for k, v in shape.items()}
    world = dist.get_world_size()
    if _prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} needs {_prod(shape.values())} ranks; "
                         f"the process group has {world}")
    rank = dist.get_rank()
    if axes_sets is None:
        sets = [("data",), ("pod",), ("pod", "data")]
        if shape.get("model", 1) > 1:
            sets += [("model",), ("data", "model"), ("pod", "data", "model")]
        axes_sets = [a for a in sets if all(x in shape for x in a)]
    groups = {}
    for axes in axes_sets:
        for ranks in _slices(shape, tuple(axes)):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[tuple(axes)] = (g, ranks)
    return Mesh(shape=shape, rank=rank, device=device,
                backend=dist.get_backend(), groups=groups)


def make_host_mesh(model: int = 1, data: int = None, pod: int = 1, *,
                   device: torch.device) -> Mesh:
    """The reference's ``make_host_mesh`` over the process group's ranks:
    ``(pod, data, model)`` when ``pod > 1``, else ``(data, model)``;
    ``data`` defaults to the ranks left over."""
    n = dist.get_world_size()
    if data is None:
        data = n // (model * pod)
    shape = ({"pod": pod, "data": data, "model": model} if pod > 1
             else {"data": data, "model": model})
    return make_mesh(shape, device)


def run_ranks(target, nproc: int, args=(), timeout: float = None,
              start_method: str = "spawn", preload=()):
    """Run ``target(rank, nproc, init_method, *args)`` in ``nproc`` new
    processes and wait for them.  Raises if a rank exits non-zero (the
    others are then stopped) or, with a ``timeout``, if they are not done
    within that many seconds (a rank that hangs in a collective fails the
    others at the process group's own timeout); every process started
    here is stopped before it returns.

    ``start_method`` is ``spawn`` (the default: CUDA does not survive
    ``fork``) or, for ranks that stay on the CPU, ``forkserver`` with the
    modules of ``preload`` imported once in the server instead of once per
    rank."""
    ctx = multiprocessing.get_context(start_method)
    if preload:
        ctx.set_forkserver_preload(list(preload))
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target, args=(r, nproc, init) + tuple(args))
             for r in range(nproc)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                failed = (f"rank {bad[0]} exited with code "
                          f"{procs[bad[0]].exitcode}")
                break
            if deadline is not None and time.monotonic() > deadline:
                failed = f"the ranks did not finish within {timeout:.0f} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                failed = (f"rank {bad[0]} exited with code "
                          f"{procs[bad[0]].exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError(f"{nproc} ranks: {failed}")
