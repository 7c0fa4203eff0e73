from repro_torch.checkpoint.checkpoint import restore, save

__all__ = ["restore", "save"]
