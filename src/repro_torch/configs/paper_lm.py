"""paper_lm — the paper-faithful small FL workload (port of
``repro.configs.paper_lm``): a ~0.36M-param dense transformer LM over the
synthetic non-iid bigram corpus (``repro_torch.data.synthetic``)."""
import torch

from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="paper_lm", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256,
    block_pattern=("attn+mlp",),
    dtype=torch.float32, remat=False, fsdp=False, client_axis="data",
    citation="[McMahan et al. 2017 scale-equivalent]",
)
SMOKE = CONFIG
