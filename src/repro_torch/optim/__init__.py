"""Optimizers and schedules (counterpart of `repro/optim`): functions over
dicts of tensors, not `torch.optim`."""
from repro_torch.optim.optimizers import (Optimizer, adam, adamax,  # noqa: F401
                                          apply_updates, clip_by_global_norm,
                                          sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,  # noqa: F401
                                         warmup_cosine)
