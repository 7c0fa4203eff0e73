"""moonshot-v1-16b-a3b [dense spec, MoE 64e top-6 — Moonlight]
[hf:moonshotai/Moonlight-16B-A3B] (port of
``repro.configs.moonshot_v1_16b_a3b``). d_ff=1408 is per-expert."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    num_experts=64, experts_per_token=6,
    block_pattern=("attn+moe",), rope_theta=5e4,
    dtype=torch.bfloat16, fsdp=False, client_axis="data",
    citation="[hf:moonshotai/Moonlight-16B-A3B]",
)
SMOKE = CONFIG.reduced()
