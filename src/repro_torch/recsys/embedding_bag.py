"""EmbeddingBag: ragged multi-hot gather + per-bag reduce.

Counterpart of `repro/recsys/embedding_bag.py`. Input is a padded
[B, max_ids] id matrix, any negative id = padding. Modes: sum / mean.
The JAX module calls its plain lookup; here `forward` goes through
`kernels/embedding_bag/ops.embedding_bag`, which runs the plain version on
the CPU and the fused CUDA kernel (`csrc/embedding_bag.cu`) on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.embedding_bag import ops
# the plain padded-form lookup is the kernel's plain version
from repro_torch.kernels.embedding_bag.ref import \
    embedding_bag_ref as embedding_bag_lookup  # noqa: F401
from repro_torch.nn.layers import init_param


class EmbeddingBag(nn.Module):
    """A [vocab, dim] f32 table drawn normal(0, init_std) on `device`."""

    def __init__(self, vocab: int, dim: int, mode: str = "mean",
                 init_std: float = 0.01, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab, self.dim, self.mode = vocab, dim, mode
        self.table = init_param(
            (vocab, dim), lambda t, g: t.normal_(0.0, init_std, generator=g),
            torch.float32, device, generator)

    def forward(self, ids):
        """ids [B, max_ids] int32/int64 on the table's device -> [B, dim]."""
        return ops.embedding_bag(self.table, ids, self.mode)


def embedding_bag_segment(table, flat_ids, segment_ids, n_bags: int,
                          mode: str = "mean"):
    """Offsets-form EmbeddingBag: flat ids [N] and their bag ids [N] ->
    [n_bags, d], with `jnp.take` / `jax.ops.segment_sum` semantics: a flat
    id in [-V, 0) counts from the end, one outside [-V, V) gathers a NaN
    row, and a bag id outside [0, n_bags) is dropped. Plain PyTorch;
    nothing on the serve path calls it."""
    V, d = table.shape
    inside = (flat_ids >= -V) & (flat_ids < V)
    emb = table[torch.where(inside, flat_ids, 0)]
    emb = emb.masked_fill(~inside[:, None], float("nan"))
    keep = (segment_ids >= 0) & (segment_ids < n_bags)
    seg = segment_ids[keep]
    s = torch.zeros(n_bags, d, dtype=table.dtype, device=table.device)
    s.index_add_(0, seg, emb[keep])
    if mode == "sum":
        return s
    n = torch.zeros(n_bags, dtype=table.dtype, device=table.device)
    n.index_add_(0, seg, torch.ones_like(seg, dtype=table.dtype))
    return s / torch.clamp(n, min=1.0)[:, None]
