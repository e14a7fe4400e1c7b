"""Core layers kept in the JAX package's layout: Linear, RMSNorm,
LayerNorm, Embedding, MLP, SwiGLU.

Counterparts of `repro/nn/layers.py`. Weights are stored [in, out] exactly
as the JAX pytree holds them (y = x @ w + b), so `convert` copies arrays
without transposing. The LM layers draw each parameter in f32 on its own
device with a `torch.Generator` and store it in the model's dtype
(`init_param`): JAX keeps f32 parameters and casts each to the activation
dtype at use, so storing them cast gives the matmuls the same operands.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.initializers import lecun_normal_


def init_param(shape, fill: Callable, dtype, device,
               generator: Optional[torch.Generator] = None) -> nn.Parameter:
    """A parameter drawn by `fill(t, generator)` into an f32 tensor on
    `device`, then cast to `dtype`. Inference-only: no gradient."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    fill(t, generator)
    return nn.Parameter(t.to(dtype), requires_grad=False)


def lecun(t, generator):
    """JAX's lecun_normal for an [in, out] matrix."""
    lecun_normal_(t, t.shape[-2], generator)


def ones(t, generator):
    t.fill_(1.0)


class Linear(nn.Module):
    """y = x @ w + b; w [in, out] drawn by lecun_normal on `device` (the
    generator must live there too), b zeros."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.w = nn.Parameter(lecun_normal_(
            torch.empty(in_dim, out_dim, device=device), in_dim, generator))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device)) \
            if use_bias else None

    def forward(self, x):
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = init_param((dim,), ones, dtype, device)

    def forward(self, x):
        # variance in f32; rsqrt cast to x.dtype before the product, as JAX
        var = x.float().square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return y * self.scale.to(x.dtype)


class LayerNorm(nn.Module):
    """Normalise over the last dim in f32 (population variance), cast
    back, then `scale` (ones) and `bias` (zeros)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return y * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class Embedding(nn.Module):
    """Token table, normal(0, 0.02); a lookup returns the table's dtype
    (the caller casts, as transformer.py does)."""

    def __init__(self, vocab: int, dim: int, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.table = init_param(
            (vocab, dim), lambda t, g: t.normal_(0.0, 0.02, generator=g),
            dtype, device, generator)

    def forward(self, ids):
        return F.embedding(ids, self.table)

    def attend(self, x):
        """Tied-output-head logits: x @ table.T."""
        return x @ self.table.to(x.dtype).T


class MLP(nn.Module):
    """Linear layers of widths dims = (in, h1, ..., out) with `act`
    (relu unless given) between them, and after the last too when
    `final_act`: JAX's MLP. Layer i is `layers.<i>` (JAX's "l<i>")."""

    def __init__(self, dims, act: Callable = torch.relu,
                 final_act: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act, self.final_act = act, final_act
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], generator=generator, device=device)
            for i in range(len(dims) - 1))

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1 or self.final_act:
                x = self.act(x)
        return x


class SwiGLU(nn.Module):
    """Gated FFN: (silu(x W_g) * x W_u) W_d — the LLaMA-family FFN."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.wg = init_param((dim, hidden), lecun, dtype, device, generator)
        self.wu = init_param((dim, hidden), lecun, dtype, device, generator)
        self.wd = init_param((hidden, dim), lecun, dtype, device, generator)

    def forward(self, x):
        g = F.silu(x @ self.wg.to(x.dtype))
        u = x @ self.wu.to(x.dtype)
        return (g * u) @ self.wd.to(x.dtype)
