"""jamba-1.5-large-398b [hybrid] — Mamba:attention 7:1 interleave, MoE
every other layer, 16e top-2 [arXiv:2403.19887] (port of
``repro.configs.jamba_1_5_large_398b``). 398B total => FSDP in the
reference; one card runs its ``SMOKE`` config. Jamba uses d_state=16 mamba
layers (mamba-1 sized state): the SSD block is instantiated with N=16."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    num_experts=16, experts_per_token=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    block_pattern=("mamba+mlp", "mamba+moe", "mamba+mlp", "attn+moe",
                   "mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe"),
    dtype=torch.bfloat16, fsdp=True, client_axis="pod",
    citation="[arXiv:2403.19887]",
)
SMOKE = CONFIG.reduced()
