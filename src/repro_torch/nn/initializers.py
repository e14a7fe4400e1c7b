"""Weight initializers (lecun / glorot / he / normal), f32.

Counterparts of `repro/nn/initializers.py`, drawn with a
`torch.Generator` (torch cannot reproduce `jax.random`: the parity tests
convert the JAX `init`'s parameters instead, and hold the draws here to
their statistics). Each returns a new f32 tensor of `shape` on `device`;
the generator must live on that device.
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


def variance_scaling(scale: float, mode: str, distribution: str,
                     in_axis: int = -2, out_axis: int = -1):
    """JAX's variance_scaling: init(shape, generator=None, device=None,
    in_axis=, out_axis=, batch_axes=()) draws with variance scale /
    max(1, fan), the fan ("fan_in", "fan_out" or "fan_avg") taken over
    the shape without its `batch_axes` (a stack of E matrices [E, d, h]
    with batch_axes=(0,) has fan_in d, not E d). "truncated_normal" cuts
    at 2 sigma and rescales to the variance (TRUNC_STD), "normal" and
    "uniform" (on +-sqrt(3 var)) draw it directly."""
    if mode not in ("fan_in", "fan_out", "fan_avg"):
        raise ValueError(mode)
    if distribution not in ("truncated_normal", "normal", "uniform"):
        raise ValueError(distribution)

    def init(shape, generator: Optional[torch.Generator] = None,
             device=None, in_axis: int = in_axis, out_axis: int = out_axis,
             batch_axes: tuple = ()) -> torch.Tensor:
        shape = tuple(shape)
        batch = {a % len(shape) for a in batch_axes}
        fan_in, fan_out = fans(tuple(s for i, s in enumerate(shape)
                                     if i not in batch), in_axis, out_axis)
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2}[mode]
        var = scale / max(1.0, denom)
        w = torch.empty(shape, device=device)
        with torch.no_grad():
            if distribution == "truncated_normal":
                std = math.sqrt(var) / TRUNC_STD
                return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std,
                                             2.0 * std, generator=generator)
            if distribution == "normal":
                return w.normal_(0.0, math.sqrt(var), generator=generator)
            lim = math.sqrt(3 * var)
            return w.uniform_(-lim, lim, generator=generator)

    return init


lecun_normal = variance_scaling(1.0, "fan_in", "truncated_normal")
glorot_uniform = variance_scaling(1.0, "fan_avg", "uniform")
glorot_normal = variance_scaling(1.0, "fan_avg", "truncated_normal")
he_normal = variance_scaling(2.0, "fan_in", "truncated_normal")


def normal(std: float = 0.02):
    """An initializer drawing N(0, std^2): init(shape, generator, device)."""
    def init(shape, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        return std * torch.randn(tuple(shape), generator=generator,
                                 device=device)

    return init
