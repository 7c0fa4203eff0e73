"""Flat-vector wrappers over the ported kernels (port of
``repro.kernels.ops``), with the reference's layout contract (DESIGN.md §6):

  * payloads have the *logical* row count ``ceil(n / block)`` — the TPU's
    8-row grid padding is a tiling artefact the CUDA kernels never make;
  * the caller adapts the QSGD block to ``min(block, n)``
    (``compress.quantization``), so a short carrier ships one short row;
  * an odd short-carrier block cannot nibble-pack in the row kernel, so it
    quantizes through the staged kernel and packs in PyTorch;
  * the ternarize wrappers keep the reference's fixed ``block`` (no
    adaptation), and their thresholds stay on the device (no host sync);
  * the count sketch takes x at its own length: the reference pads n to a
    multiple of its 1024-element chunk, and zero pad lanes add nothing.

Dispatch: a CPU tensor takes the plain PyTorch version, a CUDA tensor the
CUDA kernel (which raises if it cannot build or launch); any other device
raises.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitpack as _bp
from repro_torch.kernels import count_sketch as _cs
from repro_torch.kernels import qsgd as _qsgd
from repro_torch.kernels import ternary as _tern
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


def _k_from_fraction(n, fraction):
    """The top-k count for a static or tensor ``fraction`` (the DGC
    warm-up's annealed fraction): ``clip(round(n * f), 1, n)`` in f32 /
    int32, the same construction as ``MomentumCorrection._anneal_mask``."""
    frac = torch.as_tensor(fraction, dtype=torch.float32)
    return torch.clamp(torch.round(n * frac).to(torch.int32), 1, n)


def _static_k(n, fraction):
    return max(1, min(int(round(n * fraction)), n))


def _stc_threshold(x, fraction, max_fraction=None):
    """The k-th largest |x| as a (1,) f32 tensor on x's device.

    Only the *value* is needed, and it is exact whatever the tie order, so
    one ``torch.topk`` suffices (no stable sort).  A tensor ``fraction``
    (the DGC warm-up) reads its order statistic from the descending prefix
    of the static widest k (``max_fraction``; ``None`` means n) as a
    masked min — the reference's construction."""
    n = x.shape[0]
    mag = x.abs()
    if isinstance(fraction, (int, float)):
        k = _static_k(n, fraction)
        return torch.topk(mag, k, sorted=False).values.min().reshape(1)
    k = _k_from_fraction(n, fraction).to(x.device)
    kmax = n if max_fraction is None else _static_k(n, max_fraction)
    prefix = torch.topk(mag, kmax).values
    live = torch.arange(kmax, device=x.device) < torch.clamp(k, max=kmax)
    inf = torch.full((), float("inf"), dtype=prefix.dtype, device=x.device)
    return torch.where(live, prefix, inf).min().reshape(1)


def _support_mean(psum, pcnt, thresh, n, block):
    """mu = sum(psum) / max(count, 1) over the support of the *logical*
    vector: at t <= 0 the last row's pad lanes (x = 0) pass the threshold
    and are taken back out of the count, so the mean equals the plain
    path's ``sum(|x| * keep) / sum(keep)`` for every threshold.  (The
    reference's kernel path also counts its 8-row grid padding there.)"""
    count = pcnt.sum()
    pad = _logical_rows(n, block) * block - n
    if pad:
        count = count - (thresh.reshape(()) <= 0).to(count.dtype) * pad
    return psum.sum() / torch.clamp(count, min=1.0)


def _ternarize(x, thresh, block):
    impl = _tern.ternarize_cuda if _on_cuda(x) else _tern.ternarize_plain
    return impl(x, thresh, block)


def _ternarize_pack(x, thresh, block):
    impl = _bp.ternarize_pack_cuda if _on_cuda(x) else \
        _bp.ternarize_pack_plain
    return impl(x, thresh, block)


def _zero_thresh(x):
    return torch.zeros((1,), dtype=torch.float32, device=x.device)


def stc_ternarize(x, fraction=0.01, block=2048, max_fraction=None):
    """Full STC compress: top-k threshold + one ternarize pass.  Returns
    (code int8 flat (n,), mu f32 scalar).  ``fraction`` may be a tensor
    (the DGC warm-up); pass the schedule's static ``max_fraction`` so the
    threshold costs one top-k over the widest prefix."""
    n = x.shape[0]
    thresh = _stc_threshold(x, fraction, max_fraction)
    code, psum, pcnt = _ternarize(x, thresh, block)
    return code.reshape(-1)[:n], _support_mean(psum, pcnt, thresh, n, block)


def stc_ternarize_packed(x, fraction=0.01, block=2048, max_fraction=None):
    """The fused dense-STC wire format: top-k threshold + ONE ternarize +
    2-bit pack pass.  Returns (packed uint8 flat (ceil(n/4),), mu f32
    scalar); the bytes are ``wire_format.pack2`` of ``stc_ternarize``'s
    codes, and the int8 codes never reach device memory."""
    n = x.shape[0]
    thresh = _stc_threshold(x, fraction, max_fraction)
    packed, psum, pcnt = _ternarize_pack(x, thresh, block)
    return (packed.reshape(-1)[:-(-n // 4)],
            _support_mean(psum, pcnt, thresh, n, block))


def ternarize_signs(x, block=2048):
    """The Ternary stage's pass: full-support ternarize (threshold 0; pad
    lanes are sign(0) = 0).  Returns (sign int8 flat (n,), sum|x| f32
    scalar); the caller finishes mu = sum|x| / n over the logical n."""
    n = x.shape[0]
    code, psum, _ = _ternarize(x, _zero_thresh(x), block)
    return code.reshape(-1)[:n], psum.sum()


def ternarize_signs_packed(x, block=2048):
    """Ternary's packed wire format in one pass: full-support ternarize +
    2-bit pack.  Returns (packed uint8 flat (ceil(n/4),), sum|x| f32
    scalar); pad lanes pack as zero bits, so the bytes are
    ``wire_format.pack2`` of the signs."""
    n = x.shape[0]
    packed, psum, _ = _ternarize_pack(x, _zero_thresh(x), block)
    return packed.reshape(-1)[:-(-n // 4)], psum.sum()


def pack_codes(codes, bits=2, block=2048):
    """Flat int8 codes (n,) -> packed uint8 (ceil(n * bits / 8),) through
    the standalone pack pass over (ceil(n / block), block) rows; equals
    ``wire_format.pack2`` / ``pack4`` of the codes."""
    n = codes.shape[0]
    nb = _logical_rows(n, block)
    cb = torch.zeros((nb * block,), dtype=torch.int8, device=codes.device)
    cb[:n] = codes
    impl = _bp.pack_codes_cuda if _on_cuda(codes) else _bp.pack_codes_plain
    return impl(cb.reshape(nb, block), bits).reshape(-1)[:-(-n * bits // 8)]


def unpack_codes(packed, n, bits=2, block=2048):
    """Inverse of :func:`pack_codes`: packed uint8 -> flat int8 codes (n,),
    each field sign-extended."""
    per = 8 // bits
    nb = _logical_rows(n, block)
    pb = torch.zeros((nb * block // per,), dtype=torch.uint8,
                     device=packed.device)
    pb[:packed.shape[0]] = packed
    impl = _bp.unpack_codes_cuda if _on_cuda(packed) else \
        _bp.unpack_codes_plain
    return impl(pb.reshape(nb, block // per), bits).reshape(-1)[:n]


def sketch(x, rows=5, cols=4096, seed=17):
    """Count sketch of flat f32 x (n,) -> S (rows, cols) f32, with the
    hash parameters of ``compress.sketch.hash_params(rows, seed)``."""
    from repro_torch.compress.sketch import hash_params
    a, b = hash_params(rows, seed)
    impl = _cs.count_sketch_cuda if _on_cuda(x) else _cs.count_sketch_plain
    return impl(x, a, b, rows, cols)
