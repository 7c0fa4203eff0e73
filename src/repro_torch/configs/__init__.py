from repro_torch.configs.registry import ARCH_IDS, get_arch, get_smoke

__all__ = ["ARCH_IDS", "get_arch", "get_smoke"]
