"""Plain PyTorch version of the embedding-bag kernel.

Counterpart of `repro/kernels/embedding_bag/ref.py`, which is
`repro/recsys/embedding_bag.py:embedding_bag_lookup`. The wrapper in
`ops.py` runs it for CPU tensors; `chip_smoke.py` holds the CUDA kernel
against it on the card. `embedding_bag_grad_ref` is the plain version of
the table gradient (the backward of `ops.embedding_bag`).
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


def bag_counts(ids):
    """[B] f32 divisors of the mean: max(#ids >= 0, 1) per bag, as the
    forward counts them (an id >= V counts, padding does not)."""
    return torch.clamp((ids >= 0).sum(dim=-1).to(torch.float32), min=1.0)


def embedding_bag_grad_ref(grad_out, ids, n_rows: int, mode: str = "mean"):
    """The table gradient of `embedding_bag_ref`: grad_out [B, d], ids
    [B, W] -> dense [n_rows, d] f32. Each id in [0, n_rows) of bag b adds
    grad_out[b] (sum) or grad_out[b] / max(#ids >= 0, 1) (mean) to its
    row; padding and ids past the table add nothing (`jnp.take`'s
    gradient drops them). Zeros + `index_add_` of the expanded rows."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    B, W = ids.shape
    g = grad_out.to(torch.float32)
    if mode == "mean":
        g = g / bag_counts(ids)[:, None]
    live = (ids >= 0) & (ids < n_rows)
    rows = g[:, None, :].expand(B, W, g.shape[1])[live]
    out = torch.zeros(n_rows, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, ids[live].to(torch.int64), rows)
