"""Sparsification stages (port of ``repro.compress.sparsification``).

Only ``topk`` is ported; ``ternary``, ``stc``, ``sbc`` and ``randmask``
raise ``NotImplementedError`` from the spec grammar.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compress.api import CommTransform, register, register_stage


def _k(n, fraction):
    return max(1, int(round(n * fraction)))


def top_k_indices(x, k):
    """Indices of the k largest |x|, magnitude descending, ties broken by
    ascending index — ``lax.top_k``'s order, which the reference relies on.
    Returns (indices int64 (k,), the k-th largest |x| as a (1,) tensor)."""
    order = torch.sort(-x.abs(), stable=True)
    return order.indices[:k], -order.values[k - 1:k]


class TopK(CommTransform):
    """Magnitude top-k with a (values, indices) wire format.

    ``backend="kernel"``: the dense masking pass runs through the fused
    ``threshold_sparsify`` CUDA kernel, the threshold staying on the device;
    the payload values are gathered from its masked vector (``kept[idx] ==
    x[idx]`` bit for bit).  Like the reference, the kernel's residual is
    not used: ``ErrorFeedback`` recomputes it from the decode."""
    biased = True
    carrier_key = "vals"
    kernel_capable = True

    def __init__(self, fraction=0.01, backend="jax"):
        self.fraction = fraction
        self.backend = backend
        self.name = f"topk{fraction:g}" + \
            ("@kernel" if backend == "kernel" else "")

    def encode(self, state, rng, x):
        k = _k(x.shape[0], self.fraction)
        idx, thresh = top_k_indices(x, k)
        if self.backend == "kernel":
            from repro_torch.kernels import ops
            kept, _ = ops.threshold_sparsify(x, thresh)
            return {"vals": kept[idx], "idx": idx.to(torch.int32)}, state
        return {"vals": x[idx], "idx": idx.to(torch.int32)}, state

    def decode(self, payload, n):
        vals = payload["vals"]
        out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
        out[payload["idx"].long()] = vals.to(torch.float32)
        return out

    def carrier_len(self, n):
        return _k(n, self.fraction)

    def meta_bits(self, n):
        return _k(n, self.fraction) * 32.0       # int32 indices

    def meta_entropy_bits(self, n):
        k = _k(n, self.fraction)
        idx_bits = math.log2(max(n / k, 2.0)) + 2      # Golomb-coded gaps
        return k * idx_bits

    def carrier_hint(self, n):
        return {"kind": "top_tail", "fraction": _k(n, self.fraction) / n}


register("topk")(lambda fraction=0.01, backend="jax", **kw:
                 TopK(fraction, backend))
register_stage("topk")(lambda frac=None, fraction=0.01, backend="jax", **kw:
                       TopK(float(frac if frac is not None else fraction),
                            backend))
