"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060]
(port of ``repro.configs.mamba2_370m``). Attention-free: 48 Mamba-2
blocks, d_state=128, headdim=64."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    block_pattern=("mamba",),
    dtype=torch.bfloat16, fsdp=False, client_axis="data",
    citation="[arXiv:2405.21060]",
)
SMOKE = CONFIG.reduced()
