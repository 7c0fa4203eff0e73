"""--arch registry (port of ``repro.configs.registry``): one module per
architecture, the reference's ids and aliases."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2_5_32b",
    "llama4_scout_17b_a16e",
    "qwen3_moe_30b_a3b",
    "mamba2_370m",
    "moonshot_v1_16b_a3b",
    "jamba_1_5_large_398b",
    "whisper_base",
    "llama3_2_1b",
    "internvl2_76b",
    "deepseek_67b",
    "paper_lm",          # the paper-faithful small FL config
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIAS.update({
    "qwen2.5-32b": "qwen2_5_32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-370m": "mamba2_370m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-base": "whisper_base",
    "llama3.2-1b": "llama3_2_1b",
    "internvl2-76b": "internvl2_76b",
    "deepseek-67b": "deepseek_67b",
})


def _module(name: str):
    mod_name = _ALIAS.get(name, name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_arch(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    mod = _module(name)
    return getattr(mod, "SMOKE", mod.CONFIG.reduced())
