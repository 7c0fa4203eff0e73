"""Compressed FL aggregation over ``torch.distributed`` — the wire (port of
``repro.core.aggregation``).

The reference aggregates inside a ``shard_map`` over the client mesh axes
so that the encoded payload is the collective's operand.  Here each client
is a rank (``repro_torch.launch.mesh``) and the same holds: a compressed
pipeline ``all_gather``s the arrays of its payload (the packed ``uint8``
buffer under ``wire_format="packed"``; the ``int8`` codes, scales and
indices under ``staged``), every rank decodes every row and takes the
weighted mean; only the identity pipeline ``all_reduce``s a dense plane,
in the delta's own dtype.  Pipeline state (error-feedback residuals, DGC
momentum) stays with its client: each rank holds its own row and only the
payload crosses.  A population on the star is the one exception: every
rank keeps a replica of the residual store, and the advanced rows cross
under the ``store`` hop so that the replicas stay equal.

Every collective goes through the wrappers below, which record
a :class:`CollectiveRecord` ``(hop, op, dtype, bytes, seconds)`` in
:data:`COLLECTIVES` per call:
``bytes`` is what this rank hands the collective (its operand; for a point
to point send, the payload per directed edge).  The record is the port's
counterpart of the reference dry-run's HLO collective-byte check.  Under
``gloo`` a CUDA operand is staged through the host explicitly (once, as
gloo would), so the collectives take CPU tensors only; under ``nccl`` it
stays on the card.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.compress.secure_agg import MASK_TAG, has_mask_ctx, \
    inject_mask_ctx
from repro_torch.compress.wire_format import payload_planes
from repro_torch.device import not_ported
from repro_torch.models import sharding


# ---------------------------------------------------------------------------
# The collective wrappers and their record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective call.  ``hop`` names the transport it belongs to:
    ``wire`` (the star's uplink payloads), ``edge`` and ``cloud`` (hier),
    ``mix`` (gossip), ``dense`` (SCAFFOLD's control), ``metrics`` (the
    per-client losses and probes every rank reads) and ``store`` (a
    population's advanced pipeline rows, all-gathered so that every
    rank's replica of the residual store scatters the same rows: the
    simulation's bookkeeping, not the protocol's bytes, which the ledger
    does not bill).  On a model axis ``model`` is the all-gather over the
    model ranks of an identity aggregate's blocks, which rebuilds the
    whole leaf on every rank: bookkeeping too, never billed."""
    hop: str                 # wire, edge, cloud, mix, dense, metrics,
    #                          store, model
    op: str                  # all_gather, all_reduce, send
    dtype: torch.dtype
    nbytes: int              # this rank's operand
    seconds: float           # host clock around the call (synchronised)


# every collective of this process, in call order (a caller clears it)
COLLECTIVES: list = []


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _record(hop, op, t, t0):
    _sync(t)
    COLLECTIVES.append(CollectiveRecord(
        hop, op, t.dtype, t.numel() * t.element_size(),
        time.perf_counter() - t0))


def _staged(mesh, t):
    """The operand as the backend takes it: gloo gets a host copy."""
    t = t.contiguous().reshape(-1)
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t


def all_gather(t: torch.Tensor, mesh, axes, hop: str) -> list:
    """Every rank's ``t`` along ``axes``, in axis order (one tensor each,
    on ``t``'s device)."""
    group, ranks = mesh.group(axes)
    _sync(t)
    t0 = time.perf_counter()
    src = _staged(mesh, t)
    out = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(out, src, group=group)
    res = [o.to(t.device).reshape(t.shape) for o in out]
    _record(hop, "all_gather", t, t0)
    return res


def all_reduce_sum(t: torch.Tensor, mesh, axes, hop: str) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``axes`` (in ``t``'s dtype)."""
    group, _ = mesh.group(axes)
    _sync(t)
    t0 = time.perf_counter()
    buf = _staged(mesh, t).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    res = buf.to(t.device).reshape(t.shape)
    _record(hop, "all_reduce", t, t0)
    return res


def ppermute(tensors: list, mesh, axis: str, pairs, hop: str) -> list:
    """``jax.lax.ppermute`` over ``axis``: every ``(src, dst)`` pair (axis
    indices) sends the source's ``tensors`` to the destination.  Returns
    what this rank received, zeros where no pair targets it.  Point to
    point over gloo takes host tensors; each send is recorded once per
    directed edge."""
    group, ranks = mesh.group((axis,))
    me = mesh.axis_index(axis)
    send_to = [d for s, d in pairs if s == me]
    recv_from = [s for s, d in pairs if d == me]
    out = []
    for k, t in enumerate(tensors):
        _sync(t)
        t0 = time.perf_counter()
        src = _staged(mesh, t)
        ops = [dist.P2POp(dist.isend, src, ranks[d], group, tag=k)
               for d in send_to]
        buf = torch.zeros_like(src)
        ops += [dist.P2POp(dist.irecv, buf, ranks[s], group, tag=k)
                for s in recv_from]
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        out.append(buf.to(t.device).reshape(t.shape))
        for _ in send_to:
            _record(hop, "send", t, t0)
    return out


# ---------------------------------------------------------------------------
# Client axes, client index, per-client pipeline state
# ---------------------------------------------------------------------------

def client_axes(mesh, client_axis: str) -> tuple:
    if client_axis == "pod":
        return ("pod",) if "pod" in mesh.axis_names else ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def client_index(axes, mesh) -> int:
    """This rank's client index over ``axes``, pod-major and data-minor:
    its position in an ``all_gather`` over them."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    return idx


def comm_state_init(pipe, params: dict, lead, device):
    """Zero pipeline state per leaf with leading client dim(s) ``lead``: the
    client count C, or a tuple such as ``(G, Ce)``; on a mesh each rank
    holds its own row, ``lead`` 1 (star, gossip) or ``(1, 1)`` (hier).
    ``params`` maps each leaf to a tensor or to a shape (a model rank's
    block of the leaf on the star's model axis)."""
    lead = (lead,) if isinstance(lead, int) else tuple(lead)

    def zeros(t):
        if isinstance(t, torch.Tensor):
            return torch.zeros(lead + tuple(t.shape), dtype=t.dtype,
                               device=device)
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(zeros(v) for v in t)
        return t
    return tuple(zeros(pipe.init(tuple(getattr(p, "shape", p)),
                                 device="meta"))
                 for p in params.values())


def check_model_axis_state(pipe, shapes) -> None:
    """Raise unless every array of ``pipe``'s per-leaf state is shaped like
    its leaf (error-feedback residuals, DGC's ``u`` and ``v``) or is a
    SecAgg mask context, for each shape of ``shapes``: on a model axis
    such state splits into the rank's block, while other state (DGC
    warm-up's round counter) would be replicated over the model ranks, a
    layout the port does not hold to the reference."""
    def walk(node, shape, key=None):
        if isinstance(node, torch.Tensor):
            if tuple(node.shape) != shape and key not in ("mask_idx",
                                                          "mask_cohort"):
                raise not_ported(
                    f"{pipe.name!r} on a model axis (its state "
                    f"{key!r} is not shaped like the leaf)",
                    "repro.core.aggregation")
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, shape, k)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v, shape, key)
    for shape in shapes:
        walk(pipe.init(tuple(shape), device="meta"), tuple(shape))


def index_state(st, c):
    """Row ``c`` (an int, or a slice) of a (C,)-led state tree."""
    if isinstance(st, torch.Tensor):
        return st[c]
    if isinstance(st, dict):
        return {k: index_state(v, c) for k, v in st.items()}
    if isinstance(st, tuple):
        return tuple(index_state(v, c) for v in st)
    return st


def stack_states(states):
    """Rows of a state tree stacked under a new leading dim."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if isinstance(first, dict):
        return {k: stack_states([s[k] for s in states]) for k in first}
    if isinstance(first, tuple):
        return tuple(stack_states([s[i] for s in states])
                     for i in range(len(first)))
    return first


def all_gather_rows(st, mesh, axes, hop: str, dim=None, shape=None):
    """This rank's (1,)-led state rows ``st`` gathered along ``axes``: the
    same tree with every tensor (C,)-led, client-ordered (one
    ``all_gather`` per tensor; other leaves are kept as they are).

    On a model axis (``mesh.shape["model"]`` M > 1) the gather runs over
    ``axes`` and ``model`` and the rows are one leaf's rank blocks: a
    tensor shaped ``(1, *shape)``, a block along the leaf dim ``dim``, is
    rebuilt from the M model ranks' blocks of each client, any other
    tensor is model rank 0's."""
    M = mesh.shape.get("model", 1)
    if isinstance(st, torch.Tensor):
        if M == 1:
            return torch.cat(all_gather(st, mesh, axes, hop))
        g = all_gather(st, mesh, tuple(axes) + ("model",), hop)
        if dim is not None and tuple(st.shape[1:]) == tuple(shape):
            return torch.cat([sharding.unblock(g[c:c + M], dim, lead=1)
                              for c in range(0, len(g), M)])
        return torch.cat(g[::M])
    if isinstance(st, dict):
        done = {k: all_gather_rows(st[k], mesh, axes, hop, dim, shape)
                for k in sorted(st)}
        return {k: done[k] for k in st}
    if isinstance(st, tuple):
        return tuple(all_gather_rows(v, mesh, axes, hop, dim, shape)
                     for v in st)
    return st


def lead_state(st, ndim: int):
    """``st`` with ``ndim`` leading dims of 1 (a rank's row of the grid)."""
    if isinstance(st, torch.Tensor):
        return st.reshape((1,) * ndim + tuple(st.shape))
    if isinstance(st, dict):
        return {k: lead_state(v, ndim) for k, v in st.items()}
    if isinstance(st, tuple):
        return tuple(lead_state(v, ndim) for v in st)
    return st


# ---------------------------------------------------------------------------
# Moving a payload: its planes through one collective each
# ---------------------------------------------------------------------------

def _rebuild(payload, planes, ctx_idx):
    """``payload``'s structure with its tensors replaced by ``planes`` (in
    :func:`payload_planes` order) and a SecAgg context re-indexed to the
    sending client ``ctx_idx``."""
    it = iter(planes)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            done = {}
            for k in sorted(node):
                if k == "secagg_ctx":
                    done[k] = (node[k] if ctx_idx is None
                               else dict(node[k], idx=ctx_idx))
                else:
                    done[k] = walk(node[k])
            return {k: done[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(payload)


def check_payload(pipe, payload):
    """Raise for a payload the collectives cannot move: one whose leaves
    other than the SecAgg context are not all tensors (UVeQ's and
    RandMask's payloads carry a key object)."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            return
        if isinstance(node, dict):
            for k, v in node.items():
                if k != "secagg_ctx":
                    walk(v)
            return
        if isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
            return
        raise not_ported(f"{pipe.name!r} across ranks (its payload carries "
                         f"a {type(node).__name__}, not a tensor)",
                         "repro.core.aggregation")
    walk(payload)


def gather_payload(pipe, payload, mesh, axes, hop: str,
                   per: int = 1) -> list:
    """Every rank's payload along ``axes``, in axis order: each plane of
    ``payload`` goes through one ``all_gather``.  ``per`` ranks in a row
    send for one client (a client's model ranks, model-minor): the SecAgg
    context of row j is re-indexed to client ``j // per``."""
    check_payload(pipe, payload)
    gathered = [all_gather(t, mesh, axes, hop)
                for t in payload_planes(payload)]
    n = len(mesh.group(axes)[1])
    return [_rebuild(payload, [g[j] for g in gathered], j // per)
            for j in range(n)]


def permute_payload(pipe, payload, mesh, axis, pairs, src_of, hop: str):
    """The payload this rank receives over ``pairs`` (ppermute), with the
    sender's SecAgg index (``src_of``; None when nothing arrives: the zero
    payload, whose context is the zero one)."""
    check_payload(pipe, payload)
    planes = ppermute(payload_planes(payload), mesh, axis, pairs, hop)
    if src_of is None:
        zero = _rebuild(payload, planes, None)
        return _zero_ctx(zero)
    return _rebuild(payload, planes, src_of)


def _zero_ctx(payload):
    if isinstance(payload, dict):
        out = {k: _zero_ctx(v) for k, v in payload.items()}
        if "secagg_ctx" in out:
            out["secagg_ctx"] = dict(out["secagg_ctx"], idx=0, cohort=0)
        return out
    if isinstance(payload, (tuple, list)):
        return type(payload)(_zero_ctx(v) for v in payload)
    return payload


# ---------------------------------------------------------------------------
# The aggregator
# ---------------------------------------------------------------------------

def make_aggregator(mesh, pipe, client_axis: str = "data", hop: str = "wire",
                    specs: dict = None):
    """Returns ``aggregate(deltas, weights, rng, comm_state) -> (agg,
    new_comm_state)``.  ``deltas`` are this rank's ``{leaf name: (1, *leaf
    shape)}`` row, ``weights`` the (C,) aggregation weights (the same on
    every rank), ``comm_state`` this rank's pipeline state rows (None for a
    stateless pipeline); ``agg`` has the leaves' shapes and is the same on
    every rank.

    ``deltas`` is consumed: each leaf leaves the dict once it is sent, so
    that the rows, the new pipeline rows and the aggregate do not all
    peak together.  Zero-weight clients still send (the ledger bills only
    the selected ones): every rank issues the same collectives in the
    same order.  Each
    (leaf, client) encodes with the key ``rng.fold_in(leaf).fold_in(client
    index)``, the reference star's, and a SecAgg stage masks over the
    whole client group (key ``rng.fold_in(MASK_TAG).fold_in(leaf)``, ring
    index the client index, cohort C).

    On a model axis of M > 1 ranks (``specs``: ``{leaf name: spec}`` from
    ``repro_torch.models.sharding``) every model rank holds its client's
    whole delta, and encodes only its block of each leaf
    (:func:`sharding.block` along the leaf's ``model`` dim; a replicated
    leaf whole), with the same key on every model rank, as the
    reference's ``shard_map`` does; its pipeline rows are that block's.
    The payloads go through one ``all_gather`` over the client axes and
    ``model`` (client-major), every rank decodes every (client, block)
    and rebuilds the leaf; a replicated leaf is model rank 0's on every
    rank.  The identity pipeline all-reduces the rank's block over the
    client axes and rebuilds the leaf through an ``all_gather`` over
    ``model`` under the hop ``model``."""
    axes = client_axes(mesh, client_axis)
    if not axes:
        raise not_ported(f"client_axis={client_axis!r} on a mesh without "
                         f"that axis", "repro.core.aggregation")
    C = 1
    for a in axes:
        C *= mesh.shape[a]
    idx = client_index(axes, mesh)
    M = mesh.shape.get("model", 1)
    m = mesh.axis_index("model") if M > 1 else 0
    if M > 1 and specs is None:
        raise ValueError("a model axis needs the leaves' specs")
    dims = ({n: sharding.model_dim(sp) for n, sp in specs.items()}
            if M > 1 else {})
    wire_axes = tuple(axes) + ("model",) if M > 1 else axes
    stateful = pipe.stateful
    masked = has_mask_ctx(pipe)

    def aggregate(deltas, weights, rng, comm_state=None):
        wsum = torch.clamp(weights.sum(), min=1e-9)
        agg, st_out = {}, []
        for li, name in enumerate(list(deltas)):
            leaf = deltas.pop(name)
            dim = dims.get(name)
            local = sharding.block(leaf, dim, m, M, lead=1)
            local_shape = local.shape[1:]         # the local client dim (1)
            flat = local.reshape(-1).to(torch.float32)
            del local
            n = flat.shape[0]
            r = rng.fold_in(li).fold_in(idx)
            if pipe.is_identity:
                # all-reduce in the delta's own dtype: bf16 deltas halve
                # the wire, f32 is the faithful baseline
                contrib = (weights[idx] * flat).to(leaf.dtype)
                tot = all_reduce_sum(contrib, mesh, axes, hop)
                out = (tot.to(torch.float32) / wsum).reshape(local_shape)
                if M > 1:
                    out = sharding.unblock(all_gather(
                        out.to(leaf.dtype), mesh, ("model",), "model"), dim)
            else:
                st = (index_state(comm_state[li], 0) if stateful
                      else pipe.init((n,), device=flat.device))
                if masked:
                    mkey = rng.fold_in(MASK_TAG).fold_in(li)
                    st = inject_mask_ctx(st, mkey, idx, C)
                payload, new_st = pipe.encode(st, r, flat)
                rows = gather_payload(pipe, payload, mesh, wire_axes, hop,
                                      per=M)
                del payload, flat
                blocks = []
                for b in range(M if dim is not None else 1):
                    dec = torch.stack([pipe.decode(p, n)
                                       for p in rows[b::M]])
                    blocks.append(((weights[:, None] * dec).sum(0) / wsum)
                                  .reshape(local_shape))
                    del dec
                del rows
                out = sharding.unblock(blocks, dim)
                del blocks
                if stateful:
                    st_out.append(lead_state(new_st, 1))
            agg[name] = out.reshape(leaf.shape[1:]).to(leaf.dtype)
            del leaf, out
        return agg, (tuple(st_out) if stateful else None)

    return aggregate
