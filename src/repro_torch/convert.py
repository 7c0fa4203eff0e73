"""Parameter conversion between the JAX reference and the port.

``params_from_jax`` takes the reference's parameter pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the port's flat
``dict[str, Tensor]`` in ``jax.tree.leaves`` order; ``params_to_jax`` is
its inverse (nested dicts of numpy arrays).  bfloat16 arrays arrive as
``ml_dtypes`` numpy arrays and cross as their raw 16-bit patterns.

``state_from_jax`` carries pipeline state (EF residuals, DGC momentum and
accumulators, the warm-up round counter) across: it fills the port's state
structure with the reference's arrays, given in ``jax.tree.leaves`` order
(tuples in order, dict keys sorted).  ``hash_params_from_jax`` takes the
reference's count-sketch hash parameters (uint32 arrays) in the port's
int64 form.  ``store_from_jax`` / ``store_to_jax`` carry a
``ResidualStore`` state (slab, client, stamp, clock and the sketch tail;
any dict / tuple pytree of arrays) across unchanged in structure.
``algorithm_state_from_jax`` / ``algorithm_state_to_jax`` carry the
client and server algorithms' state fields of an ``FLState``
(``server_opt_state``'s ``m`` and ``v``, SCAFFOLD's ``control`` and
``client_controls``, CMFL's ``prev_delta``).  ``async_state_from_jax`` /
``async_state_to_jax`` carry the async engine's ``FLState.async_state``
(the scheduler's vectors on the CPU, the buffered rows, losses, pending
pipeline rows and slot table on the device).

A SecAgg stage's state (``mask_key``, ``mask_idx``, ``mask_cohort``,
``inner``) crosses too.  Its context is injected afresh at every
dispatch, so only ``inner`` carries information: the port keeps no key
between dispatches (``mask_key`` is None), and :func:`store_to_jax`
writes the reference's zero context.  No function here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, device="cpu") -> dict:
    """Nested dict of arrays -> flat ``{dotted path: Tensor}`` (sorted keys
    at every level, which is ``jax.tree.leaves`` order)."""
    out = {}

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = _to_tensor(v).to(device)
    walk(tree, "")
    return out


def params_to_jax(params: dict) -> dict:
    """Flat ``{dotted path: Tensor}`` -> nested dict of numpy arrays."""
    out: dict = {}
    for key, t in params.items():
        node = out
        *heads, last = key.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = _to_numpy(t)
    return out


def state_from_jax(template, leaves, device="cpu"):
    """The port's state ``template`` (e.g. ``engine.comm_state_init``'s)
    with each tensor replaced by the next array of ``leaves``, walked in
    ``jax.tree.leaves`` order.  Shapes and dtypes must agree."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, torch.Tensor):
            t = _to_tensor(next(it)).to(device)
            if t.shape != node.shape or t.dtype != node.dtype:
                raise ValueError(f"state leaf {tuple(t.shape)} {t.dtype} "
                                 f"does not fit {tuple(node.shape)} "
                                 f"{node.dtype}")
            return t
        if isinstance(node, dict):
            out = {}
            for k in sorted(node):
                if k == "mask_key" and node[k] is None:
                    next(it)      # the reference's mask key: not carried
                    out[k] = None
                else:
                    out[k] = fill(node[k])
            return out
        if isinstance(node, tuple):
            return tuple(fill(v) for v in node)
        return node

    out = fill(template)
    if next(it, None) is not None:
        raise ValueError("more state leaves than the template holds")
    return out


def hash_params_from_jax(a, b):
    """The reference's ``hash_params`` arrays (uint32, numpy) as the port's
    (a, b): int64 CPU tensors holding the uint32 values."""
    return tuple(torch.from_numpy(np.asarray(v, dtype=np.uint32)
                                  .astype(np.int64)) for v in (a, b))


def store_from_jax(state, device="cpu"):
    """The reference's store state, its arrays as numpy (``jax.tree.map(
    np.asarray, state)``), as the port's: the same dicts and tuples, each
    array a tensor on ``device``."""
    if isinstance(state, dict):
        return {k: None if k == "mask_key" else store_from_jax(v, device)
                for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(store_from_jax(v, device) for v in state)
    return _to_tensor(state).to(device)


def store_to_jax(state):
    """The port's store state as the reference's, with numpy arrays (the
    inverse of :func:`store_from_jax`)."""
    if isinstance(state, dict):
        out = {k: store_to_jax(v) for k, v in state.items()
               if k != "mask_key"}
        if "mask_key" in state:
            # the zero context: key u32[2], index and cohort 0
            lead = out["mask_idx"].shape
            out.update(mask_key=np.zeros(lead + (2,), np.uint32),
                       mask_idx=np.zeros(lead, np.int32),
                       mask_cohort=np.zeros(lead, np.int32))
            out = {k: out[k] for k in state}
        return out
    if isinstance(state, (tuple, list)):
        return tuple(store_to_jax(v) for v in state)
    return _to_numpy(state)


# the FLState fields of the client and server algorithms: params-shaped
# trees (client_controls with a leading client dim; server_opt_state a
# dict of them), or None when the feature is off
ALGORITHM_FIELDS = ("server_opt_state", "control", "client_controls",
                    "prev_delta")


def algorithm_state_from_jax(state, device="cpu") -> dict:
    """The reference's ``FLState`` (its arrays as numpy) -> the port's
    values of :data:`ALGORITHM_FIELDS` by name: each params-shaped tree a
    flat ``{dotted path: Tensor}`` dict as :func:`params_from_jax` makes
    it, ``server_opt_state`` a dict of them, None left None."""
    out = {}
    for f in ALGORITHM_FIELDS:
        v = getattr(state, f)
        if v is not None and f == "server_opt_state":
            v = {k: params_from_jax(t, device) for k, t in v.items()}
        elif v is not None:
            v = params_from_jax(v, device)
        out[f] = v
    return out


def algorithm_state_to_jax(state) -> dict:
    """The inverse of :func:`algorithm_state_from_jax`: the port's state's
    :data:`ALGORITHM_FIELDS` as the reference's nested dicts of numpy
    arrays."""
    out = {}
    for f in ALGORITHM_FIELDS:
        v = getattr(state, f)
        if v is not None and f == "server_opt_state":
            v = {k: params_to_jax(t) for k, t in v.items()}
        elif v is not None:
            v = params_to_jax(v)
        out[f] = v
    return out


# the async scheduler's vectors, which the port keeps on the CPU (the
# scenario's in-flight durations and completion-time quantile among them)
ASYNC_HOST_KEYS = ("clock", "next_done", "version", "server_version",
                   "buf_w", "buf_tau", "next_deadline", "slot_lat", "q_est")


def async_state_from_jax(state, device="cpu") -> dict:
    """The reference's ``FLState.async_state`` (its arrays as numpy) as
    the port's: ``updates`` a flat ``{dotted path: Tensor}`` dict as
    :func:`params_from_jax` makes it, ``pending_comm`` as
    :func:`store_from_jax` makes it, the scheduler's vectors
    (:data:`ASYNC_HOST_KEYS`) on the CPU and the rest on ``device``."""
    out = {}
    for k, v in state.items():
        if k == "updates":
            out[k] = params_from_jax(v, device)
        elif k == "pending_comm":
            out[k] = store_from_jax(v, device)
        else:
            out[k] = _to_tensor(v).to("cpu" if k in ASYNC_HOST_KEYS
                                      else device)
    return out


def async_state_to_jax(state) -> dict:
    """The inverse of :func:`async_state_from_jax`, with numpy arrays."""
    out = {}
    for k, v in state.items():
        if k == "updates":
            out[k] = params_to_jax(v)
        elif k == "pending_comm":
            out[k] = store_to_jax(v)
        else:
            out[k] = _to_numpy(v)
    return out
