from repro_torch.core.types import ArchConfig, CommLedger, FLConfig, FLState

__all__ = ["ArchConfig", "CommLedger", "FLConfig", "FLState"]
