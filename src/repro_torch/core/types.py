"""Configuration and state dataclasses (port of ``repro.core.types``).

``ArchConfig`` keeps the field names and defaults of the JAX reference so
configs read the same; ``repro_torch.models`` builds every family of them
(dense, moe, ssm, hybrid, encdec, vlm).  ``dtype`` is a ``torch.dtype``.
``FLConfig`` is a verbatim copy of the reference's fields and defaults:
knobs this slice does not run are rejected where the engine reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A transformer architecture (the reference's field set)."""

    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0                 # default: d_model // num_heads

    num_experts: int = 0
    experts_per_token: int = 0
    expert_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0
    long_context_window: int = 8192

    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    block_pattern: tuple = ("attn",)

    encoder_layers: int = 0
    frontend_tokens: int = 0
    num_patches: int = 0

    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    remat: bool = True

    fsdp: bool = False
    client_axis: str = "data"

    citation: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads and not self.num_kv_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    @property
    def num_superblocks(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}")
        return self.num_layers // len(self.block_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """The smoke-test variant of the same family (2 superblocks, small
        dims) — the reference's ``ArchConfig.reduced``."""
        pat = self.block_pattern
        small = dict(
            num_layers=2 * len(pat),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.experts_per_token else 0),
            head_dim=0,
            encoder_layers=(min(self.encoder_layers, 2)
                            if self.encoder_layers else 0),
            frontend_tokens=(min(self.frontend_tokens, 16)
                             if self.frontend_tokens else 0),
            num_patches=min(self.num_patches, 8) if self.num_patches else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            dtype=torch.float32,
            fsdp=False,
            client_axis="data",
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-smoke", **small)


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The reference's FL knobs, same names and defaults."""

    algorithm: str = "fedavg"         # fedavg|fedsgd|fedprox|scaffold|feddane
    local_steps: int = 1
    local_lr: float = 0.05
    fedprox_mu: float = 0.0
    cmfl_threshold: float = 0.0
    uplink_compressor: str = "none"
    downlink_compressor: str = "none"
    backend: str = "jax"              # "jax" = the plain PyTorch path | "kernel"
    wire_format: str = "staged"       # "staged" | "packed"
    topk_fraction: float = 0.01
    sketch_rows: int = 5
    sketch_cols: int = 4096
    qsgd_block: int = 2048
    error_feedback: bool = True
    secure_agg: bool = False
    dp_sigma: float = 0.0
    dp_clip: float = 0.0
    dgc_momentum: float = 0.0
    dgc_warmup_rounds: int = 0
    selection: str = "all"
    clients_per_round: int = 0
    hierarchical: bool = False
    sync_every: int = 4
    pod_compressor: str = "qsgd8"
    delta_dtype: str = "f32"          # f32 | bf16
    eval_every: int = 1
    telemetry: bool = False
    async_buffer_size: int = 0
    staleness_alpha: float = 0.5
    latency_profile: str = "constant"
    async_flush_deadline: float = 0.0
    server_opt: str = "fedavg"
    server_lr: float = 1.0
    server_beta1: float = 0.9
    server_beta2: float = 0.99
    server_eps: float = 1e-3
    scenario_trace: str = "static"
    scenario_period: float = 24.0
    scenario_availability: float = 1.0
    scenario_dropout: float = 0.0
    scenario_epoch_scale: float = 0.0
    scenario_deadline_quantile: float = 0.0
    scenario_seed: int = 0
    seed: int = 0


@dataclasses.dataclass
class FLState:
    """Server-side state threaded through a round.

    ``params`` is the flat ordered ``dict[str, Tensor]`` of
    ``repro_torch.models.model``; ``comm_state`` is a tuple over parameter
    leaves (in that order) of the pipeline state, each tensor with a leading
    client dim; ``rng`` is a :class:`repro_torch.core.rng.Key`; ``round`` is
    a host int (the port's round loop runs in Python)."""
    params: PyTree
    server_opt_state: PyTree
    control: PyTree | None
    client_controls: PyTree | None
    comm_state: PyTree | None
    rng: Any
    round: int
    prev_delta: PyTree | None = None
    async_state: PyTree | None = None


@dataclasses.dataclass
class CommLedger:
    """Per-round communication accounting: float32 0-dim tensors."""
    uplink_wire: torch.Tensor
    uplink_entropy: torch.Tensor
    downlink_wire: torch.Tensor
    uplink_dense: torch.Tensor
    downlink_dense: torch.Tensor
    virtual_time: Any = None
    dp_rho: Any = None

    def fields(self) -> dict:
        """The ledger's tensors by name (``None`` fields left out)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    def compression_ratio(self) -> torch.Tensor:
        total = self.uplink_wire + self.downlink_wire
        dense = self.uplink_dense + self.downlink_dense
        return dense / torch.clamp(total, min=1.0)
