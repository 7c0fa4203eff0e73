"""internvl2-76b [vlm] — InternViT (stub frontend: 256 patch embeddings in
the batch's ``patches``) + InternLM2-76B-style decoder [arXiv:2404.16821]
(port of ``repro.configs.internvl2_76b``). ~70B params => FSDP in the
reference; one card runs its ``SMOKE`` config."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, num_patches=256,
    block_pattern=("attn+mlp",), rope_theta=1e6,
    dtype=torch.bfloat16, fsdp=True, client_axis="pod",
    citation="[arXiv:2404.16821]",
)
SMOKE = CONFIG.reduced()
