"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E] (port of
``repro.configs.llama4_scout_17b_a16e``). ~101B total params => FSDP in the
reference; one card runs its ``SMOKE`` config."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    num_experts=16, experts_per_token=1,
    block_pattern=("attn+moe",), rope_theta=5e5,
    dtype=torch.bfloat16, fsdp=True, client_axis="pod",
    citation="[hf:meta-llama/Llama-4-Scout-17B-16E]",
)
SMOKE = CONFIG.reduced()
