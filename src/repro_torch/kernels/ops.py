"""Flat-vector wrappers over the ported kernels (port of
``repro.kernels.ops``), with the reference's layout contract (DESIGN.md §6):

  * payloads have the *logical* row count ``ceil(n / block)`` — the TPU's
    8-row grid padding is a tiling artefact the CUDA kernels never make;
  * the caller adapts the QSGD block to ``min(block, n)``
    (``compress.quantization``), so a short carrier ships one short row;
  * an odd short-carrier block cannot nibble-pack in the row kernel, so it
    quantizes through the staged kernel and packs in PyTorch.

Dispatch: a CPU tensor takes the plain PyTorch version, a CUDA tensor the
CUDA kernel (which raises if it cannot build or launch); any other device
raises.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels import bitpack as _bp
from repro_torch.kernels import qsgd as _qsgd
from repro_torch.kernels import topk_mask as _topk


def _logical_rows(n, block):
    """Rows of the wire payload."""
    return -(-n // block)


def _on_cuda(x) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got "
                     f"{x.device}")


def qsgd_quantize(x, u, bits=8, block=2048):
    """Flat f32 (n,) + uniforms (n,) -> (q int8 (nb, block), scale f32
    (nb,)), nb = ceil(n / block)."""
    impl = _qsgd.qsgd_quantize_cuda if _on_cuda(x) else \
        _qsgd.qsgd_quantize_plain
    return impl(x, u, bits, block)


def qsgd_quantize_packed(x, u, bits=4, block=2048):
    """Fused quantize + nibble pack (``bits <= 4``): flat f32 (n,) +
    uniforms (n,) -> (packed uint8 (ceil(n/2),), scale f32 (nb,))."""
    n = x.shape[0]
    if block % 2:
        from repro_torch.compress.wire_format import pack4
        q, scale = qsgd_quantize(x, u, bits, block)
        return pack4(q.reshape(-1)[:n]), scale
    impl = _bp.qsgd_pack_cuda if _on_cuda(x) else _bp.qsgd_pack_plain
    packed, scale = impl(x, u, bits, block)
    return packed.reshape(-1)[:-(-n // 2)], scale


def threshold_sparsify(x, thresh):
    """Fused (kept, error-feedback residual) in one pass; flat f32 in/out
    (the reference's ``block`` tiling argument has no CUDA counterpart)."""
    impl = _topk.threshold_sparsify_cuda if _on_cuda(x) else \
        _topk.threshold_sparsify_plain
    return impl(x, thresh)
