"""deepseek-67b [dense] — llama-arch, 95 layers [arXiv:2401.02954] (port of
``repro.configs.deepseek_67b``). 134 GB bf16 params => FSDP in the
reference; one card runs its ``SMOKE`` config."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400,
    block_pattern=("attn+mlp",), rope_theta=1e4,
    dtype=torch.bfloat16, fsdp=True, client_axis="pod",
    citation="[arXiv:2401.02954]",
)
SMOKE = CONFIG.reduced()
