from repro_torch.optim.sgd import sgd, apply_updates
from repro_torch.optim.adamw import adamw
