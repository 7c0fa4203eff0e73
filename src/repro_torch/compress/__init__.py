from repro_torch.compress.api import CommTransform, Identity, make_compressor
from repro_torch.compress.pipeline import chain, error_feedback
from repro_torch.compress import quantization, sketch, sparsification  # registers

__all__ = ["CommTransform", "Identity", "chain", "error_feedback",
           "make_compressor"]
