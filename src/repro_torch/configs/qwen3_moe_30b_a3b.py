"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B]
(port of ``repro.configs.qwen3_moe_30b_a3b``). d_ff=768 is the per-expert
hidden size."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936,
    num_experts=128, experts_per_token=8,
    block_pattern=("attn+moe",), rope_theta=1e6,
    dtype=torch.bfloat16, fsdp=False, client_axis="data",
    citation="[hf:Qwen/Qwen3-30B-A3B]",
)
SMOKE = CONFIG.reduced()
