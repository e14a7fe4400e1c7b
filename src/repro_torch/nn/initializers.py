"""Weight initializers the graph zoo draws from, f32.

Counterparts of `repro/nn/initializers.py`'s `lecun_normal` and
`normal(std)`, drawn with a `torch.Generator` (torch cannot reproduce
`jax.random`: the parity tests convert the JAX `init`'s parameters
instead). Each returns a new f32 tensor of `shape` on `device`; the
generator must live on that device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

# JAX's lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
TRUNC_STD = 0.87962566103423978


def fans(shape: tuple, in_axis: int = -2, out_axis: int = -1):
    """(fan_in, fan_out) as JAX's `_fans`: the in and out axes times the
    product of the other (receptive) axes; a vector counts its length."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    axes = {in_axis % len(shape), out_axis % len(shape)}
    receptive = int(np.prod([s for i, s in enumerate(shape)
                             if i not in axes]))
    return shape[in_axis] * receptive, shape[out_axis] * receptive


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """Fill w in place: a normal truncated at 2 sigma, scaled to variance
    1 / fan_in."""
    std = math.sqrt(1.0 / max(1, fan_in)) / TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def lecun_normal(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """JAX's lecun_normal for any shape (fan_in from `fans`)."""
    shape = tuple(shape)
    return lecun_normal_(torch.empty(shape, device=device), fans(shape)[0],
                         generator)


def normal(std: float = 0.02):
    """An initializer drawing N(0, std^2): init(shape, generator, device)."""
    def init(shape, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        return std * torch.randn(tuple(shape), generator=generator,
                                 device=device)

    return init
