"""Logical axis names -> per-dim mesh axes (port of
``repro.models.sharding``).

Every parameter's dims carry the reference's *logical* names
(``ParamDef.logical``); :func:`spec_for` maps them onto the mesh's axes
with the reference's rules:

  * one dim per leaf takes the ``model`` axis, the most preferred by
    ``_MODEL_PREF`` (experts, then heads / ffn / ssm_inner, then vocab,
    then embed); ``_NEVER`` names dims that never do, the stacked
    ``stack`` dim among them;
  * with ``fsdp`` a second dim takes ``data`` (``FSDP_MODE`` ``extend``:
    the model dim widens to ``("model", "data")`` where both divide it,
    else the rightmost eligible dim; ``legacy``: ``_FSDP_PREF``);
  * a dim the axis does not divide stays replicated.

A spec is a plain tuple with one entry per dim: an axis name, a tuple of
names, or ``None``.  The mesh is any object with a ``shape`` dict (axis
name -> size), such as ``repro_torch.launch.mesh.Mesh``.

On the port's star a model rank holds the ``m``-th of ``M`` equal blocks
of a leaf along its ``model`` dim (:func:`block`), the block the
reference's ``shard_map`` hands that device; :func:`unblock` rebuilds the
leaf from the ``M`` blocks.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

# logical axis name -> preference rank for receiving the "model" mesh
# axis (lower is preferred); with fsdp one further dim gets "data"
_MODEL_PREF = {
    "experts": 0,
    "heads": 1,
    "kv_heads": 1,
    "ffn": 1,
    "vocab": 2,
    "ssm_inner": 1,
    "embed": 3,
}
_FSDP_PREF = {
    "embed": 0,
    "ffn": 1,
    "vocab": 1,
    "heads": 2,
    "kv_heads": 2,
    "ssm_inner": 2,
    "experts": 3,
}
_NEVER = {"layers", "stack", None, "ssm_state", "ssm_heads", "conv",
          "pattern"}

FSDP_MODE = "extend"   # "extend" (the default) | "legacy"


def spec_for(shape: Sequence[int], logical: Sequence, mesh,
             fsdp: bool) -> tuple:
    """The spec of one parameter of ``shape`` from its logical axes: the
    reference's ``spec_for``, as a tuple."""
    assert len(shape) == len(logical), (shape, logical)
    axes: list = [None] * len(shape)
    sizes = dict(mesh.shape)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)

    def pick(pref: Mapping[str, int], axis_size: int, taken):
        best, best_rank = None, 99
        for i, (dim, name) in enumerate(zip(shape, logical)):
            if i == taken or name in _NEVER or name not in pref:
                continue
            if dim % axis_size != 0 or axes[i] is not None:
                continue
            if pref[name] < best_rank:
                best, best_rank = i, pref[name]
        return best

    mi = pick(_MODEL_PREF, model_n, None) if model_n > 1 else None
    if mi is not None:
        axes[mi] = "model"
    if fsdp and data_n > 1:
        if FSDP_MODE == "legacy":
            di = pick(_FSDP_PREF, data_n, mi)
            if di is not None:
                axes[di] = "data"
        elif mi is not None and shape[mi] % (model_n * data_n) == 0:
            axes[mi] = ("model", "data")
        else:
            for i in range(len(shape) - 1, -1, -1):
                if (i != mi and logical[i] not in _NEVER
                        and shape[i] % data_n == 0 and axes[i] is None):
                    axes[i] = "data"
                    break
    return tuple(axes)


def tree_specs(shapes: Mapping[str, Sequence[int]],
               logical: Mapping[str, Sequence], mesh, fsdp: bool) -> dict:
    """``spec_for`` over ``{leaf name: shape}`` and ``{leaf name: logical
    axes}`` (``Model.logical_axes()``), in the shapes' order."""
    return {n: spec_for(tuple(s), logical[n], mesh, fsdp)
            for n, s in shapes.items()}


def with_prefix(specs: Mapping[str, tuple], *prefix) -> dict:
    """Every spec with the mesh axes ``prefix`` prepended (e.g. the client
    axes in front of a (C,)-led state)."""
    return {n: tuple(prefix) + tuple(s) for n, s in specs.items()}


def batch_spec(mesh, client_axis: str) -> tuple:
    """The leading-axis spec of client-major batches."""
    names = tuple(mesh.shape)
    if client_axis == "pod" and "pod" in names:
        return ("pod",)
    if "pod" in names and client_axis == "data":
        return (("pod", "data"),)
    return ("data",)


def n_clients(mesh, client_axis: str) -> int:
    sizes = dict(mesh.shape)
    if client_axis == "pod":
        return sizes.get("pod", 1)
    return sizes.get("data", 1) * sizes.get("pod", 1)


# ---------------------------------------------------------------------------
# A model rank's block of a leaf
# ---------------------------------------------------------------------------

def model_dim(spec: Sequence):
    """The dim that ``spec`` gives to the ``model`` axis alone, or None
    (the leaf is replicated over it)."""
    spec = tuple(spec)
    return spec.index("model") if "model" in spec else None


def block(t, dim, m: int, M: int, lead: int = 0):
    """Block ``m`` of ``M`` of ``t`` along the leaf dim ``dim`` (``None``:
    the whole tensor), contiguous; ``lead`` leading dims come before the
    leaf's dims."""
    if dim is None or M == 1:
        return t
    return t.chunk(M, lead + dim)[m].contiguous()


def unblock(blocks: Sequence, dim, lead: int = 0):
    """The tensor whose ``M`` blocks along ``dim`` are ``blocks`` (``dim``
    None: the first block, every block being the whole tensor)."""
    if dim is None or len(blocks) == 1:
        return blocks[0]
    return torch.cat(list(blocks), lead + dim)


def block_shape(shape: Sequence[int], dim, M: int) -> tuple:
    """The shape of one of ``M`` blocks of a leaf of ``shape``."""
    shape = tuple(shape)
    if dim is None:
        return shape
    return shape[:dim] + (shape[dim] // M,) + shape[dim + 1:]
