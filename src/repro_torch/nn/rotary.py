"""Rotary position embeddings (RoPE), half-rotation convention.

Counterpart of `repro/nn/rotary.py`: computed in f32 and cast back.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (f32)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate the last dim of x ([..., seq, heads, head_dim]) by position.

    positions: [..., seq] integers. Computed in f32 and cast back."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [half]
    angles = positions[..., :, None].float() * freqs           # [..., seq, half]
    cos = torch.cos(angles)[..., None, :]                      # [..., seq, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
