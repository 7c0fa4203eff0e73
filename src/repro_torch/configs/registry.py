"""--arch registry (port of ``repro.configs.registry``): the dense archs
this slice of the port builds."""
from __future__ import annotations

import importlib

from repro_torch.device import not_ported

ARCH_IDS = ["llama3_2_1b", "paper_lm"]

# archs the JAX reference registers that the port does not build yet
JAX_ONLY = ["qwen2_5_32b", "llama4_scout_17b_a16e", "qwen3_moe_30b_a3b",
            "mamba2_370m", "moonshot_v1_16b_a3b", "jamba_1_5_large_398b",
            "whisper_base", "internvl2_76b", "deepseek_67b"]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS + JAX_ONLY}
_ALIAS.update({"llama3.2-1b": "llama3_2_1b", "qwen2.5-32b": "qwen2_5_32b",
               "jamba-1.5-large-398b": "jamba_1_5_large_398b"})


def _module(name: str):
    mod_name = _ALIAS.get(name, name)
    if mod_name in JAX_ONLY:
        raise not_ported(f"arch {name!r}", f"repro.configs.{mod_name}")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_arch(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    mod = _module(name)
    return getattr(mod, "SMOKE", mod.CONFIG.reduced())
