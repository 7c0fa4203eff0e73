"""llama3.2-1b [dense] — small llama3, GQA kv=8, tied embeddings
[hf:meta-llama/Llama-3.2-1B] (port of ``repro.configs.llama3_2_1b``)."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, tie_embeddings=True,
    block_pattern=("attn+mlp",), rope_theta=5e5,
    dtype=torch.bfloat16, fsdp=False, client_axis="data",
    citation="[hf:meta-llama/Llama-3.2-1B]",
)
SMOKE = CONFIG.reduced()
