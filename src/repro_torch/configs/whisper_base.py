"""whisper-base [audio] — enc-dec; the conv/mel frontend is a stub: the
batch carries precomputed frame embeddings ``frontend`` (B, 1500, 512)
[arXiv:2212.04356] (port of ``repro.configs.whisper_base``). The
transformer backbone only."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    num_layers=6, encoder_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, frontend_tokens=1500,
    block_pattern=("attn+cross+mlp",),
    dtype=torch.bfloat16, fsdp=False, client_axis="data",
    citation="[arXiv:2212.04356]",
)
SMOKE = CONFIG.reduced(frontend_tokens=16)
