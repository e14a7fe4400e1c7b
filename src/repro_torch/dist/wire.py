"""Wire format of the routing plane: one packed f32 buffer per lane.

Counterpart of `repro/dist/wire.py` (lane_width, field_col, pack_lane,
unpack_lane, pad_lane, init_defer). A lane's fields ride ONE [C, W] float32 buffer,
so a whole lane crosses the mesh in one collective, and the same packed
rows are what the lane's defer ring carries across ticks.

Layout: columns follow the batch dataclass's field order; a [C] field
takes one column, a [C, d] field takes d. Integer fields are VALUE-cast
(exact for |v| < 2**24: parts, slots and counts by construction), bools
ride as 0.0 / 1.0 and unpack as `> 0.5`. A zero row therefore unpacks as
an invalid record.
"""
from __future__ import annotations

from dataclasses import fields
from functools import lru_cache

import torch


@lru_cache(maxsize=None)
def _field_names(cls):
    return tuple(f.name for f in fields(cls))


def _width(leaf) -> int:
    if leaf.ndim == 1:
        return 1
    if leaf.ndim != 2:
        raise ValueError(f"wire leaves are [C] or [C, d], got "
                         f"{tuple(leaf.shape)}")
    return leaf.shape[1]


def lane_fields(batch):
    """The layout of a batch's packed row: [(name, tensor, first column,
    width)] in field order. pack_lane, field_col and the fused route_lane
    kernel's field descriptors (kernels/route_pack/ops.py) all read it."""
    out, off = [], 0
    for name in _field_names(type(batch)):
        leaf = getattr(batch, name)
        w = _width(leaf)
        out.append((name, leaf, off, w))
        off += w
    return out


def lane_width(batch) -> int:
    """Total packed row width W of a part-addressed batch."""
    return sum(w for _, _, _, w in lane_fields(batch))


def field_col(batch, name: str) -> int:
    """First packed column of field `name`."""
    for fname, _, col, _ in lane_fields(batch):
        if fname == name:
            return col
    raise KeyError(f"{type(batch).__name__} has no field {name!r}")


def pack_lane(batch) -> torch.Tensor:
    """Batch (capacity C) -> packed [C, W] float32 wire rows."""
    layout = lane_fields(batch)
    C = layout[0][1].shape[0]
    out = torch.empty((C, lane_width(batch)), dtype=torch.float32,
                      device=layout[0][1].device)
    for _, leaf, col, w in layout:
        out[:, col:col + w] = leaf.reshape(C, w)    # value cast to f32
    return out


def unpack_lane(buf: torch.Tensor, proto):
    """Packed [R, W] rows -> a batch like `proto` with capacity R (proto
    contributes only field dtypes and widths)."""
    out = {}
    for name, leaf, c, w in lane_fields(proto):
        col = buf[:, c:c + w]
        if leaf.ndim == 1:
            col = col[:, 0]
        if leaf.dtype == torch.bool:
            col = col > 0.5
        else:
            col = col.to(leaf.dtype)      # exact: ints ride as exact floats
        out[name] = col
    if lane_width(proto) != buf.shape[1]:
        raise ValueError(f"wire width mismatch: proto wants "
                         f"{lane_width(proto)}, buffer has {buf.shape[1]}")
    return type(proto)(**out)


def pad_lane(rows: torch.Tensor, capacity: int) -> torch.Tensor:
    """Zero-pad packed wire rows [C, W] up to [capacity, W]. Zero rows
    unpack as invalid records, so padding is inert at delivery. The
    inter-stage ring gives the host feature inbox (feat_cap rows) and a
    layer's outbox (P_loc * cap_pp rows) one slot shape this way."""
    C, W = rows.shape
    if C > capacity:
        raise ValueError(f"pad_lane: {C} rows exceed the slot capacity "
                         f"{capacity}")
    if C == capacity:
        return rows
    return torch.cat([rows, rows.new_zeros((capacity - C, W))])


def init_defer(rows: int, width: int, device):
    """An empty defer ring: (packed rows [rows, width] f32, occupied
    [rows] bool). rows == 0 disables backpressure for the lane."""
    return (torch.zeros((rows, width), dtype=torch.float32, device=device),
            torch.zeros((rows,), dtype=torch.bool, device=device))
