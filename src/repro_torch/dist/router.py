"""The routing plane on one device.

Counterpart of `repro/dist/router.py` (LocalRouter, RouteReceipt,
zero_receipt, add_receipts). Every part is local, so transport is the
identity and the wire counters stay zero; the sharded MeshRouter is ROADMAP
Queue 1 item 13.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RouteReceipt:
    """Measured wire telemetry of one route_lanes call (0-d int64)."""
    rows: torch.Tensor
    deferred: torch.Tensor
    dropped: torch.Tensor
    peak: torch.Tensor


def zero_receipt(device) -> RouteReceipt:
    z = torch.zeros((), dtype=torch.int64, device=device)
    return RouteReceipt(rows=z, deferred=z, dropped=z, peak=z)


def add_receipts(a: RouteReceipt, b: RouteReceipt) -> RouteReceipt:
    """Counters add, the peak gauge maxes."""
    return RouteReceipt(rows=a.rows + b.rows, deferred=a.deferred + b.deferred,
                        dropped=a.dropped + b.dropped,
                        peak=torch.maximum(a.peak, b.peak))


@dataclass(frozen=True)
class LocalRouter:
    """Single-device router: every part is local, delivery is identity."""
    n_parts: int

    def part0(self) -> int:
        """Global id of the first locally-owned part."""
        return 0

    def route_lanes(self, lanes, device):
        """No wire: lanes deliver as-is."""
        return tuple(lanes), zero_receipt(device)

    def psum(self, x):
        return x
