"""The routing plane: transport of part-addressed record batches.

Counterpart of `repro/dist/router.py` (RouteReceipt, zero_receipt,
add_receipts, LocalRouter and MeshRouter):

  LocalRouter : one device owns every part; transport is the identity.
  MeshRouter  : parts are block-sharded over the data axis of a
                `dist/mesh.py:StreamMesh`; each `route_lanes` call
                compacts the records of all its lanes by destination rank
                and exchanges them with ONE packed all_to_all
                (`dist/wire.py`) inside the rank's stage row. A lane's
                step after the plan (pack, place, ring refill) is one
                `kernels/route_pack` route_lane call that reads the
                lane's fields in place.

On a 2-D ("stage", "data") mesh the router also carries the stage axis:
`stage_shift` (the circular hand-off s -> s + 1 within a data column),
`stage_last`, `stage_gather`, `psum_stage` / `pmax_stage` and the
quiescence vote `psum_vote` over both axes. `psum`, `pmax`, `part0` and
`route_lanes` stay on the data axis. On a 1-D mesh (and the LocalRouter)
every stage method degrades as the reference's does: the stage
reductions are the identity, `stage_gather` adds a [1] axis and
`psum_vote` is `psum`. Each stage collective counts under its own kind in
`StreamMesh.calls`.

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
0, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
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
    n_stages = 1

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

    def stage_index(self) -> int:
        return 0

    def psum_stage(self, x):
        return x

    def pmax_stage(self, x):
        return x

    def stage_gather(self, x):
        """All stages' copies of `x`, leading [S] axis ([1] here)."""
        return x[None]


@dataclass(frozen=True)
class MeshRouter:
    """Sharded router over a StreamMesh: data shard d owns parts
    [d * Pl, (d + 1) * Pl), Pl = n_parts // mesh.n_data (validated by
    PipelineConfig.validate); on a 2-D mesh every stage row holds the
    same blocks.

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

    @cached_property
    def data(self):
        """The data axis: this rank's stage row (the mesh itself on 1-D)."""
        return self.mesh if self.n_stages == 1 else self.mesh.data_view()

    @cached_property
    def stage(self):
        """The stage axis: this rank's data column (2-D only)."""
        return self.mesh.stage_view()

    @property
    def n_stages(self) -> int:
        return self.mesh.n_stages

    @property
    def n_devices(self) -> int:
        """Ranks on the DATA axis (parts shard within a stage row)."""
        return self.mesh.size // self.n_stages

    @property
    def n_local_parts(self) -> int:
        return self.n_parts // self.n_devices

    def part0(self) -> int:
        return (self.mesh.rank % self.n_devices) * self.n_local_parts

    def psum(self, x):
        """Sum over the data axis."""
        return self.data.all_reduce(x)

    def psum_vote(self, x):
        """A quiescence / silence vote over every rank: both axes on a
        2-D mesh, `psum` on a 1-D one."""
        if self.n_stages == 1:
            return self.psum(x)
        return self.mesh.all_reduce(x, kind="psum_vote")

    def pmax(self, x):
        """Elementwise maximum over the data axis (the telemetry gauges)."""
        return self.data.all_reduce(x, op=dist.ReduceOp.MAX)

    # ---- the stage axis (a 2-D mesh; the identity forms on 1-D)
    def stage_index(self) -> int:
        return self.mesh.rank // self.n_devices

    def psum_stage(self, x):
        """Sum over the stage axis only."""
        if self.n_stages == 1:
            return x
        return self.stage.all_reduce(x, kind="psum_stage")

    def pmax_stage(self, x):
        """Maximum over the stage axis only: peak gauges cross the stage
        axis with max, never sum."""
        if self.n_stages == 1:
            return x
        return self.stage.all_reduce(x, op=dist.ReduceOp.MAX,
                                     kind="pmax_stage")

    def stage_shift(self, rows):
        """Post packed rows to the next stage: stage s -> s + 1 (mod S)
        within the data column. Called right after each round's compute,
        as in the reference."""
        return self.stage.shift(rows, kind="stage_shift")

    def stage_last(self, rows):
        """Every stage's copy of the LAST stage's rows: the final layer
        lives on stage S - 1, and its outbox must reach every stage's
        replica of the sink in the same tick."""
        return self.stage.all_gather(rows, kind="stage_last")[
            self.n_stages - 1]

    def stage_gather(self, x):
        """Every stage's copy of `x`, leading [S] axis: the training plane
        gathers all rounds' layer caches so each stage row runs the full
        (stage-replicated) layered backward."""
        if self.n_stages == 1:
            return x[None]
        return self.stage.all_gather(x, kind="stage_gather")

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
        got = self.data.all_to_all(buf)                        # [D, X]
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
