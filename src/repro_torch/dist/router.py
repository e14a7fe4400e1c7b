"""The routing plane: transport of part-addressed record batches.

Counterpart of `repro/dist/router.py` (RouteReceipt, zero_receipt,
add_receipts, LocalRouter and the 1-D MeshRouter):

  LocalRouter : one device owns every part; transport is the identity.
  MeshRouter  : parts are block-sharded over the ranks of a 1-D
                `dist/mesh.py:StreamMesh`; each `route_lanes` call
                compacts the records of all its lanes by destination rank
                and exchanges them with ONE packed all_to_all
                (`dist/wire.py`). A lane's step after the plan (pack,
                place, ring refill) is one `kernels/route_pack` route_lane
                call that reads the lane's fields in place.

Capped exchange: a lane's per-destination send bucket holds
`lane_cap(C)` rows (route_cap, default None = the lane's capacity C, the
dense exchange under which nothing can overflow). Live records past their
bucket are deferred into the lane's ring (packed rows carried in the
LayerState) and re-enter the next tick's exchange AHEAD of fresh ones:
FIFO per destination, so a replica's feature broadcasts apply in emission
order. Only a full ring drops rows, counted in RouteReceipt.dropped.
Invalid destinations are masked out of the exchange, never clipped onto
the last rank.

With the telemetry plane on (`MeshRouter(telemetry=True)`), a receipt's
`peak` is the largest per-destination demand of any of the call's lanes
before the cap (ring rows included): the route_cap at which the call
would defer nothing. It is read off the plan's destination run starts,
so it costs no pass over the rows. Off, and under the LocalRouter, it is
0, as in JAX. The stage-axis methods of the 2-D mesh are not ported
(ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.dist.wire import field_col, lane_width, unpack_lane
from repro_torch.kernels.route_pack import ops as route_ops
from repro_torch.kernels.route_pack.ref import route_lane_ref


@dataclass(frozen=True)
class RouteReceipt:
    """Measured wire telemetry of one route_lanes call (0-d int64, local
    to the calling rank — the tick body psums them into TickStats):
    rows shipped, rows deferred into rings, rows lost to a full ring, and
    the peak gauge (the largest per-destination demand before the cap,
    with telemetry on; 0 otherwise)."""
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

    n_devices = 1

    @property
    def n_local_parts(self) -> int:
        return self.n_parts

    def part0(self) -> int:
        """Global id of the first locally-owned part."""
        return 0

    def route_lanes(self, lanes, defers):
        """No wire: lanes deliver as-is, the (empty) rings pass through."""
        return tuple(lanes), tuple(defers), zero_receipt(lanes[0].part.device)

    def psum(self, x):
        return x

    def psum_vote(self, x):
        """A quiescence / silence vote over every rank: the identity."""
        return x

    def pmax(self, x):
        return x


@dataclass(frozen=True)
class MeshRouter:
    """Sharded router over a 1-D StreamMesh: rank r owns parts
    [r * Pl, (r + 1) * Pl), Pl = n_parts // mesh.size (validated by
    PipelineConfig.validate).

    route_cap   : per-destination send-bucket rows (None = each lane's
                  full capacity, the dense never-overflow exchange).
    pack_backend: "kernel" (the fused CUDA route_lane on the card) or
                  "scatter" (its plain chain, ref.route_lane_ref: pack,
                  concatenate, place, gather the ring); follows
                  PipelineConfig's delivery_backend.
    telemetry   : fill the receipt's peak gauge (PipelineConfig.telemetry).
    """
    n_parts: int
    mesh: object
    route_cap: Optional[int] = None
    pack_backend: str = "kernel"
    telemetry: bool = False

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def n_local_parts(self) -> int:
        return self.n_parts // self.mesh.size

    def part0(self) -> int:
        return self.mesh.rank * self.n_local_parts

    def psum(self, x):
        return self.mesh.all_reduce(x)

    def psum_vote(self, x):
        """A quiescence / silence vote over every rank (the 1-D mesh's
        one axis: `psum`)."""
        return self.psum(x)

    def pmax(self, x):
        """Elementwise maximum over the ranks (the telemetry gauges)."""
        return self.mesh.all_reduce(x, op=dist.ReduceOp.MAX)

    def lane_cap(self, capacity: int) -> int:
        """Resolved per-destination bucket rows for a lane of the given
        local emission capacity."""
        if self.route_cap is None:
            return capacity
        return max(1, min(self.route_cap, capacity))

    def route_lanes(self, lanes, defers):
        """Deliver several record lanes with ONE all_to_all.

        lanes : part-addressed batches (MsgBatch, ...) with `part`/`valid`
                fields, local capacities C_i.
        defers: matching (packed rows [K_i, W_i] f32, occupied [K_i] bool)
                rings; K_i = 0 disables backpressure for the lane (then an
                overflow, impossible at the dense default, drops, counted).

        Returns (delivered lanes — capacity D * cap_i each, block j = what
        rank j sent here, in its emission order; new rings; RouteReceipt).
        """
        D = self.n_devices
        dev = lanes[0].part.device
        if D == 1:
            return tuple(lanes), tuple(defers), zero_receipt(dev)
        Pl = self.n_local_parts
        lane_step = (route_ops.route_lane if self.pack_backend == "kernel"
                     else route_lane_ref)
        sends, metas, new_defers, counts, peaks = [], [], [], [], []
        for lane, (dbuf, dok) in zip(lanes, defers):
            C, W = lane.part.shape[0], lane_width(lane)
            K = dbuf.shape[0]
            cap = self.lane_cap(C)
            # carried rows re-enter first; their occupancy flag is the
            # live mask (they only ever hold valid records)
            fresh_ok = (lane.valid & (lane.part >= 0)
                        & (lane.part < self.n_parts))
            parts = lane.part
            if K:
                ok = torch.cat([dok, fresh_ok])
                parts = torch.cat([dbuf[:, field_col(lane, "part")]
                                   .to(torch.int64), parts])
            else:
                ok = fresh_ok
            dst = torch.where(ok, torch.div(parts, Pl, rounding_mode="floor"),
                              D)
            plan = route_ops.route_plan(dst, ok, D, cap)
            if self.telemetry:
                # each destination's demand before the cap: its run in
                # the plan's sorted order
                peaks.append((plan[4][1:] - plan[4][:-1]).max())
            send, nbuf = lane_step(dbuf, lane, plan, D, cap)
            sends.append(send.reshape(D, cap * W))
            metas.append((lane, cap, W))
            ship_s, left_s = plan[1], plan[3]
            n_left = left_s.sum()
            if K:
                new_defers.append((nbuf, torch.arange(K, device=dev) < n_left))
                n_defer = torch.clamp(n_left, max=K)
            else:
                new_defers.append((dbuf, dok))
                n_defer = torch.zeros_like(n_left)
            counts.append(torch.stack([ship_s.sum(), n_defer,
                                       n_left - n_defer]))
        buf = sends[0] if len(sends) == 1 else torch.cat(sends, dim=1)
        got = self.mesh.all_to_all(buf)                        # [D, X]
        outs, off = [], 0
        for proto, cap, W in metas:
            blk = got[:, off:off + cap * W].reshape(D * cap, W)
            off += cap * W
            outs.append(unpack_lane(blk, proto))
        n = torch.stack(counts).sum(dim=0)
        peak = (torch.stack(peaks).max() if peaks
                else torch.zeros_like(n[0]))
        receipt = RouteReceipt(rows=n[0], deferred=n[1], dropped=n[2],
                               peak=peak)
        return tuple(outs), tuple(new_defers), receipt
