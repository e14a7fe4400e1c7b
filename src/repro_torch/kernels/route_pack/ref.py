"""Plain PyTorch versions of the route_pack op.

`route_pack_ref` is what the `ops.route_pack` wrapper runs for CPU
tensors; `chip_smoke.py` holds the CUDA kernel against it on the card.
`route_plan_ref` is the O(N * D) membership-cumsum plan (the JAX
package's oracle), kept for the tests.
"""
from __future__ import annotations

import torch


def route_plan_ref(dst, ok, n_dev: int, cap: int):
    """(ship, slot, left) per record in ORIGINAL order: rank = the
    record's position among the live records of its destination."""
    live = ok & (dst >= 0) & (dst < n_dev)
    member = (torch.where(live, dst, n_dev)[:, None]
              == torch.arange(n_dev, device=dst.device)[None, :])
    pos = torch.cumsum(member.to(torch.int64), dim=0) - 1
    rank = torch.where(member, pos, 0).sum(dim=1)
    ship = live & (rank < cap)
    slot = torch.where(ship, dst * cap + rank, n_dev * cap)
    return ship, slot, live & ~ship


def route_pack_ref(rows, slots, n_slots: int):
    """Place rows [N, W] at slots [N] of a zeroed [n_slots, W] buffer;
    slot == n_slots drops (each live slot receives at most one row)."""
    buf = torch.zeros((n_slots + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return buf.index_copy_(0, slots, rows)[:-1]
