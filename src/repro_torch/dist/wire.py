"""Wire format of the routing plane: one packed f32 buffer per lane.

Counterpart of `repro/dist/wire.py` (lane_width, field_col, pack_lane,
unpack_lane, init_defer). A lane's fields ride ONE [C, W] float32 buffer,
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

import torch


def _leaves(batch):
    return [getattr(batch, f.name) for f in fields(batch)]


def _width(leaf) -> int:
    if leaf.ndim == 1:
        return 1
    if leaf.ndim != 2:
        raise ValueError(f"wire leaves are [C] or [C, d], got "
                         f"{tuple(leaf.shape)}")
    return leaf.shape[1]


def lane_width(batch) -> int:
    """Total packed row width W of a part-addressed batch."""
    return sum(_width(l) for l in _leaves(batch))


def field_col(batch, name: str) -> int:
    """First packed column of field `name`."""
    off = 0
    for f in fields(batch):
        if f.name == name:
            return off
        off += _width(getattr(batch, f.name))
    raise KeyError(f"{type(batch).__name__} has no field {name!r}")


def pack_lane(batch) -> torch.Tensor:
    """Batch (capacity C) -> packed [C, W] float32 wire rows."""
    leaves = _leaves(batch)
    C = leaves[0].shape[0]
    out = torch.empty((C, lane_width(batch)), dtype=torch.float32,
                      device=leaves[0].device)
    off = 0
    for leaf in leaves:
        w = _width(leaf)
        out[:, off:off + w] = leaf.reshape(C, w)    # value cast to f32
        off += w
    return out


def unpack_lane(buf: torch.Tensor, proto):
    """Packed [R, W] rows -> a batch like `proto` with capacity R (proto
    contributes only field dtypes and widths)."""
    out, off = {}, 0
    for f in fields(proto):
        leaf = getattr(proto, f.name)
        w = _width(leaf)
        col = buf[:, off:off + w]
        off += w
        if leaf.ndim == 1:
            col = col[:, 0]
        if leaf.dtype == torch.bool:
            col = col > 0.5
        else:
            col = col.to(leaf.dtype)      # exact: ints ride as exact floats
        out[f.name] = col
    if off != buf.shape[1]:
        raise ValueError(f"wire width mismatch: proto wants {off}, buffer "
                         f"has {buf.shape[1]}")
    return type(proto)(**out)


def init_defer(rows: int, width: int, device):
    """An empty defer ring: (packed rows [rows, width] f32, occupied
    [rows] bool). rows == 0 disables backpressure for the lane."""
    return (torch.zeros((rows, width), dtype=torch.float32, device=device),
            torch.zeros((rows,), dtype=torch.bool, device=device))
