"""Linear layer, kept in the JAX package's layout.

Counterpart of `repro/nn/layers.py:Linear`. The weight is stored [in, out]
exactly as the JAX pytree holds it (y = x @ w + b), so
`convert.params_from_numpy` copies arrays without transposing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# JAX's lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.w = nn.Parameter(lecun_normal_(torch.empty(in_dim, out_dim),
                                            in_dim, generator))
        self.b = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x):
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y
