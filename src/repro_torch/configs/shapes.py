"""The four input shapes and their abstract inputs (port of
``repro.configs.shapes``): ``meta`` tensors stand in for the reference's
``ShapeDtypeStruct``s, shapes and dtypes without memory.  The serving
rules ``decode_cache_len`` and ``decode_window`` size the decode cache
and its attention window."""
from __future__ import annotations

import torch

from repro_torch.core.types import ArchConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256,
                            mode="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768,
                               global_batch=32, mode="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768,
                              global_batch=128, mode="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1,
                             mode="decode"),
}

# the sliding window that makes full-attention archs sub-quadratic for
# long_500k (the one shape where window attention substitutes)
LONG_WINDOW = 8_192


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def model_extras(cfg: ArchConfig, B: int, dtype) -> dict:
    """The stubbed modality frontend's inputs: ``patches`` (vlm) or
    ``frontend`` (encdec)."""
    out = {}
    if cfg.family == "vlm":
        out["patches"] = _meta((B, cfg.num_patches, cfg.d_model), dtype)
    if cfg.family == "encdec":
        out["frontend"] = _meta((B, cfg.frontend_tokens, cfg.d_model), dtype)
    return out


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig, n_clients: int):
    """The client-major FL batch: each leaf (C, B, ...) with B the global
    batch over the clients."""
    C = max(n_clients, 1)
    B = shape.global_batch // C
    if B < 1:
        raise ValueError(f"{shape.name}: global batch {shape.global_batch} "
                         f"under {C} clients")
    S = shape.seq_len
    batch = {
        "tokens": _meta((C, B, S), torch.int32),
        "labels": _meta((C, B, S), torch.int32),
        "mask": _meta((C, B, S), torch.float32),
        "sizes": _meta((C,), torch.float32),
        "resources": _meta((C, 4), torch.float32),
    }
    for k, v in model_extras(cfg, B, cfg.dtype).items():
        batch[k] = _meta((C,) + tuple(v.shape), v.dtype)
    return batch


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32)}
    batch.update(model_extras(cfg, B, cfg.dtype))
    return batch


def decode_cache_len(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """The KV cache's length for a decode shape: ``long_500k`` on a
    full-attention arch is the sliding window's ring buffer; SSM and
    hybrid archs keep the full length (their memory is the state and the
    rare attention layer)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return LONG_WINDOW
    return shape.seq_len


def decode_window(cfg: ArchConfig, shape: ShapeConfig) -> int:
    if cfg.sliding_window:
        return cfg.sliding_window
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return LONG_WINDOW
    return 0


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig,
                       quantized: bool = False):
    from repro_torch.models.model import init_cache
    B = shape.global_batch
    enc_len = cfg.frontend_tokens if cfg.family == "encdec" else 0
    cache = init_cache(cfg, B, decode_cache_len(cfg, shape), enc_len,
                       quantized=quantized, device="meta")
    return {"cache": cache, "token": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}
