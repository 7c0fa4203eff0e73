"""qwen2.5-32b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B family card,
scaled per assignment] (port of ``repro.configs.qwen2_5_32b``)."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064, qkv_bias=True,
    block_pattern=("attn+mlp",), rope_theta=1e6,
    dtype=torch.bfloat16, fsdp=False, client_axis="data",
    citation="[hf:Qwen/Qwen2.5-0.5B]",
)
SMOKE = CONFIG.reduced()
