"""Parameter counts of a module (counterparts of `repro/nn/module.py`'s
`param_count` / `param_bytes`, over an `nn.Module`'s parameters)."""
from __future__ import annotations

from torch import nn


def param_count(module: nn.Module) -> int:
    """Total number of scalar parameters."""
    return sum(p.numel() for p in module.parameters())


def param_bytes(module: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())
