"""Plain PyTorch version of the embedding-bag kernel.

Counterpart of `repro/kernels/embedding_bag/ref.py`, which is
`repro/recsys/embedding_bag.py:embedding_bag_lookup`. The wrapper in
`ops.py` runs it for CPU tensors; `chip_smoke.py` holds the CUDA kernel
against it on the card.
"""
from __future__ import annotations

import torch

MODES = ("sum", "mean")


def embedding_bag_ref(table, ids, mode: str = "mean"):
    """table [V, d]; ids [B, W], any negative id = padding -> [B, d].

    sum adds the rows of the bag's valid ids; mean divides that sum by
    max(#valid, 1), so an all-padding bag reads 0 in both modes. A bag
    holding an id >= V reads NaN, as `jnp.take`'s fill mode gives it: torch
    indexing would raise, so the index is clamped and NaN written after.
    The [B, W, d] gathered rows are masked in place, to hold one copy."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    V = table.shape[0]
    valid = ids >= 0
    oob = ids >= V
    emb = table[ids.clamp(0, max(V - 1, 0))]
    emb.masked_fill_(~(valid & ~oob)[..., None], 0.0)
    s = emb.sum(dim=-2)
    if mode == "mean":
        n = valid.sum(dim=-1, keepdim=True).to(s.dtype)
        s = s / torch.clamp(n, min=1.0)
    return s.masked_fill_(oob.any(dim=-1, keepdim=True), float("nan"))
