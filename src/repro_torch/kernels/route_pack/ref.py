"""Plain PyTorch versions of the route_pack ops.

`route_pack_ref` and `route_lane_ref` are what the `ops.route_pack` and
`ops.route_lane` wrappers run for CPU tensors; `chip_smoke.py` holds the
CUDA kernel against them on the card. `route_plan_ref` is the O(N * D)
membership-cumsum plan (the JAX package's oracle), kept for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.dist.wire import pack_lane


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


def route_lane_ref(ring, lane, plan, n_dev: int, cap: int):
    """ops.route_lane as a chain of plain passes (what the router ran
    before the fused kernel): pack the lane, put the ring's rows in front,
    place the sorted rows at their send slots, then gather the ring's
    refill. ring [K, W] f32; plan = route_plan(dst, ok, n_dev, cap) over
    the K + C rows. Returns (send [n_dev * cap, W], new ring [K, W])."""
    order, _, slot_s, left_s, _ = plan
    K = ring.shape[0]
    packed = pack_lane(lane)                               # [C, W]
    allp = torch.cat([ring, packed]) if K else packed
    send = route_pack_ref(allp[order], slot_s, n_dev * cap)
    if not K:
        return send, ring
    # ring slot j <- the (j+1)-th overflowing row in sorted (FIFO) order;
    # a gather of K rows, not of all N
    cum = torch.cumsum(left_s, 0)
    j = torch.arange(K, device=ring.device)
    pos = torch.clamp(torch.searchsorted(cum, j + 1), max=cum.shape[0] - 1)
    return send, allp[order[pos]].masked_fill_((j >= cum[-1])[:, None], 0.0)
