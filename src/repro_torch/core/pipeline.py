"""The D3-GNN dataflow pipeline driver (paper Fig. 1).

Counterpart of `repro/core/pipeline.py`:

Dataset -> Partitioner -> Splitter -> GraphStorage_1 .. GraphStorage_L -> sink

The host cuts the stream into micro-ticks, assigns parts/slots
(partitioner.py) and builds padded batches; the device runs one tick per
GraphStorage operator per tick, layer l's outbox being layer l+1's inbox,
and the final outbox materializes into the embedding sink.

Distributed execution: pass `mesh=` (a `dist/mesh.py:StreamMesh`, one
process per rank) and the same program runs on every rank over its block
of parts (MeshRouter). The host batches are replicated: every rank runs
the same seeded partitioner over the same stream, as JAX feeds its
shard_map replicated inputs, and each rank's state tables hold only its
[Pl, ...] rows. Every method that touches the device is then collective:
all ranks call it, in the same order.

Hybrid parallelism: a 2-D ("stage", "data") mesh
(`launch/mesh.py:make_stream_mesh(stage=S)` with PipelineConfig.n_stages
= S) also pipelines the LAYER axis. Layer l lives on stage l % S; each
tick every stage runs its R = L // S rounds on data one hop behind, and
the inter-stage hops ride a packed ring (`stage_ring`, [R, C_buf, W] on
each rank) posted with one `stage_shift` right after each round's compute
(`_tick_program_2d`). Per tick the schedule is skewed against the 1-D
program, but the quiescent state after `flush` is the same fixed point.
At n_stages = 1 none of this code runs: the 1-D program is unchanged.
`reshard` moves a live pipeline onto another mesh (or off it); it is
collective over the process group's world.

Two drivers share ONE device program (`_tick_program`: topology apply + L
layer ticks + sink update):

  * `tick()` — the per-tick REFERENCE path: build the tick's batches, run
    the program, read the tick's stats back (one host sync per tick).
  * `run_super_tick()` — the SUPER-TICK path: the host stages T micro-ticks
    of batches (their valid rows, one host-to-device copy per batch
    class, the padded lanes built on the device), the device
    runs the T tick programs back to back with the stats sums and the
    quiescence counter kept ON THE DEVICE, and the host reads them once
    per super-tick (exactly one device-to-host sync on one device; on a
    mesh each collective waits for the device too). Capturing the T ticks
    as one CUDA graph is a later step (ROADMAP).

The query plane (`serve/query.py`, query_cap > 0) rides both drivers:
admissions and link head hops at the start of each tick, the link-tail
wire as a second lane of layer 0's round-B exchange, answers after the
sink update. Answers come back in the same read as the stats (the tick's,
or the super-tick's one read); `drain_answers()` pops them and
`serve/session.py:ServeSession` drives the whole thing. query_cap=0 runs
exactly the program without the plane.

Delta-gated propagation (PipelineConfig.delta_eps > 0) gates each layer's
re-emissions and coalesces its RMIs (core/tick.py); StreamMetrics counts
the suppressed out-edge messages. delta_eps = 0 runs the exact program.

The training plane (`train=TrainConfig(...)` with train_cap > 0,
core/train_plane.py): label events ride a per-tick LabelBatch, and every
tick ENDS with a windowed online training step over the live state; the
forward of the next tick reads the trained parameters (mirrored into the
model's modules). Progress stays on the device until `train_stats()`
reads it; `serve/train_session.py:TrainSession` drives both drivers.
train_cap=0 runs exactly the program without the plane.

The telemetry plane (`telemetry/`) has two parts. The device occupancy
trace (PipelineConfig.telemetry=True): the tick's occupancy gauges carry
exact values and every tick appends one row to a `TraceRecorder`
(`save_trace()` -> .npz): the [21] device occupancy row, host timings,
wire bytes and ingest counts. The rows (and the per-part busy vector)
ride the drivers' one stats read, so the super-tick driver still syncs
once a super-tick; `_trace_ticks` also feeds the `ft/stragglers.py`
mitigator. Telemetry observes and changes nothing: every other stat and
the state are bit-equal to a run without it. The launch log
(`telemetry/spans.py`), always on: each driver call writes one record a
launch with its five contiguous host phases (stage, upload, dispatch,
wait, post), the staging spans inside `stage` (stage.partition,
stage.features, stage.queries, stage.labels, stage.pack) and the
launch's counters (edges, feats, queries, labels, upload.bytes,
upload.live_bytes, upload.lane_bytes); the construction writes one
"build" record.
StreamMetrics' host_seconds and wall_seconds are read from these
records. While torch's profiler is on, the phases, the spans and the
tick program's stages (`d3.tick`, `d3.tick.*`, `d3.layer.*`) are also
`record_function` ranges; off, none is entered and no device value is
read.
Checkpoints of the whole pipeline are `ft/checkpoint.py`'s
(`CheckpointManager.save_pipeline` / `restore_pipeline`).
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field, replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import events as ev
from repro_torch.core import state as st
from repro_torch.core import windowing as win
from repro_torch.core.delivery import BACKENDS as DELIVERY_BACKENDS
from repro_torch.core.delivery import make_delivery
from repro_torch.core.explosion import layer_parallelisms, physical_busy
from repro_torch.core.partitioner import StreamingPartitioner
from repro_torch.core.termination import (TerminationCoordinator, moved_msgs,
                                          quiet_update)
from repro_torch.core.tick import (SCALAR_FIELDS, TickStats, add_stats,
                                   layer_tick_body, zero_stats)
from repro_torch.core.train_plane import (TrainConfig, init_train_state,
                                          train_stage)
from repro_torch.device import resolve_device
from repro_torch.dist.mesh import StreamMesh
from repro_torch.dist.router import LocalRouter, MeshRouter
from repro_torch.dist.wire import (field_col, lane_width, pack_lane,
                                   pad_lane, unpack_lane)
from repro_torch.ft.stragglers import StragglerMitigator
from repro_torch.graph.sage import linear_tree, load_linear_tree
from repro_torch.serve.query import (KIND_LINK, QSTAT_FIELDS,
                                     add_query_stats, empty_query_batch,
                                     init_query_state, query_admit_stage,
                                     query_answer_stage,
                                     query_batch_from_numpy, wire_width,
                                     zero_query_stats)
from repro_torch.telemetry import spans
from repro_torch.telemetry.trace import TRACE_DEVICE_COLS, TraceRecorder


@dataclass(frozen=True)
class Capacities:
    """Resolved per-tick budgets of a (config, mesh) pair. Defer-ring rows
    are GLOBAL (n_devices x per-rank) and 0 whenever the capped exchange
    cannot overflow (dense default, one device, or route_cap >= the lane
    capacity)."""
    outbox: int            # per-tick emission budget (rows, all parts)
    outbox_per_part: int   # emission slots per part (outbox // n_parts)
    query_admissions: int  # query rows admitted per tick (0: plane off)
    train_cap: int         # label rows admitted per tick (0: plane off)
    bc_defer_rows: int     # broadcast-lane defer-ring rows
    rmi_defer_rows: int    # RMI-lane defer-ring rows
    query_defer_rows: int  # query wire lane's defer-ring rows


@dataclass
class PipelineConfig:
    n_parts: int = 8                  # logical parts (= max_parallelism)
    node_cap: int = 512               # per-part vertex slots
    edge_cap: int = 2048              # per-part edge slots
    repl_cap: int = 1024              # per-part replication records
    feat_cap: int = 1024              # host-inbox feature rows per tick
    outbox_cap: Optional[int] = None  # per-tick emission budget (default:
                                      # feat_cap), split evenly over parts
    edge_tick_cap: int = 1024         # new-edge records per tick
    query_cap: int = 0                # query plane: pending-query slots
                                      # per part (0 = the plane is off;
                                      # serve/query.py)
    query_tick_cap: Optional[int] = None  # query rows admitted per tick
                                      # (None = query_cap * n_parts)
    train_cap: int = 0                # training plane: label rows
                                      # admitted per tick (0 = the plane
                                      # is off; needs D3Pipeline(train=))
    route_cap: Optional[int] = None   # per-destination all_to_all bucket
                                      # rows (None = each lane's capacity:
                                      # the dense, never-overflow wire);
                                      # overflow defers (dist/router.py)
    route_defer_cap: Optional[int] = None  # per-rank defer-ring rows per
                                      # lane (default: the lane's local
                                      # capacity; 0 = overflow drops)
    window: win.WindowConfig = field(default_factory=win.WindowConfig)
    delta_eps: float = 0.0            # delta-gated propagation: 0 =
                                      # exact; > 0 suppresses re-emissions
                                      # whose message moved <= eps
    delivery_backend: str = "kernel"  # "kernel" (CUDA kernels) | "scatter"
    n_stages: int = 1                 # pipeline stages on a 2-D mesh
                                      # (layer l on stage l % n_stages;
                                      # must match make_stream_mesh(
                                      # stage=...)); 1 = the 1-D program
    telemetry: bool = False           # telemetry plane: exact occupancy
                                      # gauges, the per-tick trace and the
                                      # straggler feed (telemetry/)
    partitioner: str = "hdrf"
    base_parallelism: int = 2         # p  (physical, for stats/sharding)
    explosion: float = 1.0            # lambda (core/explosion.py)
    max_nodes: int = 100_000          # global id space for the host tables
    seed: int = 0

    def capacities(self, n_devices: int = 1) -> Capacities:
        """Every resolved per-tick budget for a mesh of n_devices ranks
        (1 covers the LocalRouter)."""
        outbox = self.feat_cap if self.outbox_cap is None else self.outbox_cap
        p_loc = self.n_parts // max(n_devices, 1)
        return Capacities(
            outbox=outbox, outbox_per_part=max(1, outbox // self.n_parts),
            query_admissions=self._query_admissions(),
            train_cap=self.train_cap,
            bc_defer_rows=self._defer_rows(p_loc * self.repl_cap, n_devices),
            rmi_defer_rows=self._defer_rows(
                self.edge_tick_cap + p_loc * self.edge_cap, n_devices),
            query_defer_rows=self._defer_rows(p_loc * self.query_cap,
                                              n_devices))

    def _query_admissions(self) -> int:
        if self.query_cap <= 0:
            return 0
        return (self.query_cap * self.n_parts if self.query_tick_cap is None
                else self.query_tick_cap)

    def _defer_rows(self, lane_capacity: int, n_devices: int) -> int:
        if n_devices <= 1 or self.route_cap is None:
            return 0
        if self.route_cap >= lane_capacity:    # bucket >= lane: no overflow
            return 0
        per_dev = (lane_capacity if self.route_defer_cap is None
                   else self.route_defer_cap)
        return n_devices * per_dev

    def validate(self, n_devices: int = 1, n_layers: Optional[int] = None,
                 local: bool = False) -> None:
        """Fail fast with a clear message (ValueError, as the JAX
        package's validate). n_devices counts the WHOLE mesh (stage x data
        on a 2-D mesh; 1 for the LocalRouter); n_layers enables the
        layer-placement check; local flags a pipeline without a mesh,
        which cannot host pipeline stages."""
        if self.n_stages < 1:
            raise ValueError(
                f"PipelineConfig.n_stages={self.n_stages} must be >= 1 "
                "(1 = the layer-sequential 1-D program)")
        if self.n_stages > 1:
            if local:
                raise ValueError(
                    f"PipelineConfig.n_stages={self.n_stages} needs a 2-D "
                    "('stage','data') mesh (make_stream_mesh(stage=...)): "
                    "the LocalRouter has no stage axis to place layers on "
                    "and would silently run them layer-sequentially — "
                    "pass mesh= or set n_stages=1")
            if n_devices % self.n_stages:
                raise ValueError(
                    f"n_devices={n_devices} is not divisible by "
                    f"n_stages={self.n_stages}: the mesh factors as "
                    "(stage, data) = (n_stages, n_devices // n_stages), "
                    "so pick a device count that is a multiple of the "
                    "stage count")
            if n_layers is not None and n_layers % self.n_stages:
                raise ValueError(
                    f"n_layers={n_layers} is not divisible by "
                    f"n_stages={self.n_stages}: layers are placed "
                    "round-robin on stages (layer l on stage l % S) and "
                    "every stage must carry the same number of rounds — "
                    "use a stage count that divides the layer count")
        caps = {"n_parts": self.n_parts, "node_cap": self.node_cap,
                "edge_cap": self.edge_cap, "repl_cap": self.repl_cap,
                "feat_cap": self.feat_cap,
                "outbox_cap (capacities().outbox)": self.capacities().outbox,
                "edge_tick_cap": self.edge_tick_cap}
        for name, v in caps.items():
            if v <= 0:
                raise ValueError(f"PipelineConfig.{name}={v} must be > 0")
        if self.query_cap < 0:
            raise ValueError(f"PipelineConfig.query_cap={self.query_cap} "
                             "must be >= 0 (0 disables the query plane)")
        if self.query_cap == 0 and self.query_tick_cap:
            raise ValueError(
                "PipelineConfig.query_tick_cap is set but query_cap=0 — "
                "the query plane is disabled; set query_cap > 0 to serve")
        if self.query_cap > 0 and self._query_admissions() <= 0:
            raise ValueError(
                f"PipelineConfig.query_tick_cap={self.query_tick_cap} "
                "must be > 0 (capacities().query_admissions) when the "
                "query plane is enabled")
        if self.train_cap < 0:
            raise ValueError(
                f"PipelineConfig.train_cap={self.train_cap} must be >= 0 "
                "(0 disables the training plane)")
        if not (self.delta_eps >= 0.0):   # rejects negatives AND NaN
            raise ValueError(
                f"PipelineConfig.delta_eps={self.delta_eps} must be a "
                "finite value >= 0 (0 = exact/ungated propagation)")
        if self.route_cap is not None and self.route_cap <= 0:
            raise ValueError(
                f"PipelineConfig.route_cap={self.route_cap} must be > 0 "
                "(or None for the dense never-overflow exchange)")
        if self.route_defer_cap is not None and self.route_defer_cap < 0:
            raise ValueError(
                f"PipelineConfig.route_defer_cap={self.route_defer_cap} "
                "must be >= 0 (0 disables deferral: bucket overflow then "
                "drops, counted in TickStats.route_dropped)")
        # parts shard over the DATA axis only: on a 2-D mesh each stage
        # row holds the same part blocks over n_devices // n_stages ranks
        data_devs = (n_devices // self.n_stages if self.n_stages > 1
                     else n_devices)
        if (self.route_defer_cap == 0 and self.query_cap > 0
                and self.route_cap is not None and data_devs > 1
                and self.route_cap < (self.n_parts // data_devs)
                * self.query_cap):
            raise ValueError(
                "route_defer_cap=0 with a capped query wire lane "
                f"(route_cap={self.route_cap} < per-device wire capacity "
                f"{(self.n_parts // n_devices) * self.query_cap}): a "
                "dropped link-tail record would strand its qid with no "
                "ok=False answer — MsgBatch lanes may drop loudly, the "
                "wire lane must be able to defer. Leave route_defer_cap "
                "unset (defaults to the lane capacity) or raise route_cap")
        if self.delivery_backend not in DELIVERY_BACKENDS:
            raise ValueError(
                f"PipelineConfig.delivery_backend="
                f"{self.delivery_backend!r} is not registered: pick one of "
                f"{sorted(DELIVERY_BACKENDS)} (core/delivery.py)")
        if self.capacities().outbox % self.n_parts:
            raise ValueError(
                f"the emission budget capacities().outbox="
                f"{self.capacities().outbox} must be a multiple of "
                f"n_parts={self.n_parts}")
        if data_devs > 1 and self.n_parts % data_devs:
            raise ValueError(
                f"n_parts={self.n_parts} is not divisible by the mesh's "
                f"{data_devs} devices: the part axis is block-sharded over "
                "the ranks, so pick n_parts as a multiple of the device "
                "count (each rank owns n_parts // n_devices parts)")


@dataclass
class StreamMetrics:
    ticks: int = 0
    emitted_total: int = 0
    reduce_msgs: int = 0
    broadcast_msgs: int = 0
    cross_part_msgs: int = 0
    dropped: int = 0
    suppressed: int = 0                # out-edge RMIs the delta gate saved
    queries_admitted: int = 0
    queries_answered: int = 0
    queries_dropped: int = 0
    query_hold_ticks: int = 0          # pending-query-ticks (backlog integral)
    # measured routing-plane wire counters, summed over every all_to_all
    # of every tick (0 under the LocalRouter)
    wire_rows: int = 0                 # live records shipped on the wire
    wire_bytes: int = 0                # exchanged send-buffer bytes
    route_deferred: int = 0            # records carried by backpressure
    route_dropped: int = 0             # records lost to FULL defer rings
    stage_idle: int = 0                # pipeline bubbles: device-rounds
                                       # that saw an EMPTY inbox, summed
                                       # over ticks (0 on a 1-D mesh;
                                       # D3Pipeline.bubble_fraction())
    # telemetry plane (all 0 unless PipelineConfig.telemetry)
    occ_defer_ticks: int = 0           # defer-ring backlog integral
                                       # (end-of-tick ring rows, summed
                                       # over ticks)
    route_peak: int = 0                # max per-tick route bucket demand
                                       # before the cap
    outbox_peak: int = 0               # max per-tick per-layer emission
                                       # demand (emitted + dropped)
    outbox_part_peak: int = 0          # max per-tick PER-PART eviction
                                       # demand (outbox_cap >= n_parts x
                                       # this drops nothing)
    host_seconds: float = 0.0          # host staging: the launch
                                       # records' stage + upload phases
                                       # (telemetry/spans.py)
    wall_seconds: float = 0.0          # the launch records' walls
    busy_logical: Optional[np.ndarray] = None

    @property
    def throughput(self) -> float:
        return (self.emitted_total / self.wall_seconds if self.wall_seconds
                else 0.0)


_OCC = {c: i for i, c in enumerate(TRACE_DEVICE_COLS)}


def _ingest_counts(edges, feats, queries, labels):
    """One tick's (edges, feats, queries, labels) ingest counts."""
    return (len(edges) if edges is not None else 0,
            len(feats) if feats else 0, len(queries) if queries else 0,
            len(labels) if labels else 0)


def _occ_row(stats_all, qstats, ts, router, stage: bool = False):
    """The telemetry plane's per-tick device occupancy row: int64
    [len(TRACE_DEVICE_COLS)] in `telemetry/trace.py`'s column order. The
    TickStats scalars are reduced over the ranks already; the training
    table's two populations take one more psum (with training on).
    stage=True (the 2-D program) also folds each stage's partial stats
    over the stage axis: the counters with one psum_stage, the peak
    gauges with one pmax_stage, the final layer's emissions taken from
    stage S - 1 (layer L - 1 lives there). The query and training entries
    are stage-replicated already."""
    z = torch.zeros((), dtype=torch.int64, device=stats_all[0].busy.device)
    fsum = lambda f: sum(getattr(s, f) for s in stats_all)
    fmax = lambda vals: torch.stack(vals).max()
    if ts is not None:
        labeled, dirty = router.psum(torch.stack([
            ts.label_mask.sum(), (ts.dirty & ts.label_mask).sum()]))
    else:
        labeled = dirty = z
    q = (lambda f: getattr(qstats, f)) if qstats is not None else \
        (lambda f: z)
    last = stats_all[-1].emitted
    if stage:
        last = last * int(router.stage_index() == router.n_stages - 1)
    adds = torch.stack([torch.as_tensor(v).to(torch.int64) for v in (
        last,                                           # emitted_final
        fsum("emitted"),                                # emitted_sum
        fsum("reduce_msgs"), fsum("broadcast_msgs"), fsum("wire_rows"),
        fsum("route_deferred"), fsum("route_dropped"), fsum("dropped"),
        fsum("n_suppressed"),                           # suppressed
        fsum("occ_bc_defer"), fsum("occ_rmi_defer"))])
    peaks = torch.stack([torch.as_tensor(v).to(torch.int64) for v in (
        fmax([s.route_peak for s in stats_all]),        # route_peak
        fmax([s.emitted + s.dropped for s in stats_all]),  # outbox_demand
        fmax([s.outbox_part_peak for s in stats_all]))])  # outbox_part_peak
    if stage:
        adds, peaks = router.psum_stage(adds), router.pmax_stage(peaks)
    rest = torch.stack([torch.as_tensor(v).to(torch.int64) for v in (
        q("held_ticks"),                                # query_pending
        q("wire_backlog"),                              # query_backlog
        labeled, dirty,                                 # train_labeled/dirty
        q("admitted"), q("answered"), q("dropped"))])
    return torch.cat([adds, peaks, rest])


def _sink_update_body(sink, seen, fb: ev.FeatBatch, part0=0):
    P, N, d = sink.shape
    idx, _ = st.local_index(fb.part, fb.slot, part0, P, N, fb.valid)
    sink = st.scatter_set(sink.reshape(P * N, d), idx, fb.feat)
    seen = seen.reshape(P * N) | st.mark_rows(P * N, idx, idx.device)
    return sink.reshape(P, N, d), seen.reshape(P, N)


def _tree_map(fn, *trees):
    """fn over the leaves of same-shaped pipeline trees (dicts, lists,
    dataclasses; the checkpoint's tree order)."""
    from repro_torch.ft.checkpoint import tree_flatten, tree_unflatten
    cols = [[l for _, l in tree_flatten(t)] for t in trees]
    return tree_unflatten(trees[0], [fn(*xs) for xs in zip(*cols)])


def _sent_bytes(mesh) -> int:
    """Bytes this rank has sent into reshard relays over `mesh`."""
    return mesh.calls.get("reshard", [0, 0.0, 0])[2] if mesh else 0


def _tree_to(tree, device):
    return None if tree is None else _tree_map(lambda a: a.to(device), tree)


@dataclass(frozen=True)
class StagedActLayer:
    """One pipeline ROUND's layer on this rank's stage, in the reference's
    SPMD-uniform form: GraphSAGE stacks put act=False on the final layer
    only, and the staged layer carries that flag as data, a 0/1 float leaf
    `params["act"]` beside the layer's parameter tree `params["p"]`, so
    the relu rides a `torch.where` instead of a per-layer branch. `base`
    supplies the arithmetic (its own act flag is not read); valid for any
    layer whose activation is exactly a final relu (SAGELayer).
    D3Pipeline enforces the rest of the uniformity contract
    (`_check_uniform_layers`)."""
    base: object
    params: dict = None

    def message(self, x):
        return self.message_params(self.params, x)

    def update(self, x, agg):
        return self.update_params(self.params, x, agg)

    def message_params(self, params, x):
        return self.base.message_params(params["p"], x)

    def update_params(self, params, x, agg):
        h = self.base.linear_params(params["p"], x, agg)
        return torch.where(params["act"] > 0, torch.relu(h), h)


class D3Pipeline:
    """L chained GraphStorage operators + the host driver."""

    def __init__(self, model, cfg: PipelineConfig, mesh=None,
                 train: Optional[TrainConfig] = None, device=None):
        """model: graph/sage.GraphSAGE (an nn.Module whose `layers` have
        message/update); it is moved to the pipeline's device.
        mesh: optional `dist/mesh.py:StreamMesh` — this process is one
        rank of a 1-D mesh that shards the part axis (MeshRouter), or of a
        2-D ("stage", "data") mesh that also pipelines the layer axis
        (cfg.n_stages must equal mesh.n_stages); the pipeline runs on the
        mesh's device. On a process outside the mesh (rank -1) the
        pipeline is DORMANT: it holds the host side only and takes part
        in `reshard` alone.
        train: optional TrainConfig — the online training plane (needs
        cfg.train_cap > 0 and a model with a head, n_classes > 0).
        device: where a pipeline without a mesh runs — CUDA unless given;
        raises without CUDA.
        The construction's seconds go to the launch log as one "build"
        record (`telemetry/spans.py`), under this pipeline's `span_id`."""
        self.span_id = spans.new_pipeline()
        with spans.build(self.span_id):
            self._build(model, cfg, mesh, train, device)

    def _build(self, model, cfg, mesh, train, device) -> None:
        if mesh is not None and not isinstance(mesh, StreamMesh):
            raise TypeError(f"mesh must be a dist.mesh.StreamMesh, got "
                            f"{type(mesh).__name__}")
        S = mesh.n_stages if mesh is not None else 1
        n_dev = mesh.n_data if mesh is not None else 1
        if mesh is not None and S != cfg.n_stages:
            raise ValueError(
                f"mesh has stage={S} but PipelineConfig.n_stages="
                f"{cfg.n_stages}: the stage counts must agree — build the "
                "mesh with make_stream_mesh(stage=n_stages)")
        cfg.validate(n_devices=S * n_dev, n_layers=len(model.layers),
                     local=mesh is None)
        if (train is not None) != (cfg.train_cap > 0):
            raise ValueError(
                f"train={'set' if train is not None else 'None'} but "
                f"PipelineConfig.train_cap={cfg.train_cap}: the online "
                "training plane needs BOTH a TrainConfig (the knobs) and "
                "train_cap > 0 (the per-tick label admission budget, "
                "capacities().train_cap) — set both or neither")
        if train is not None and getattr(model, "head", None) is None:
            raise ValueError(
                "train= needs an output operator: build the model with "
                "n_classes > 0 (GraphSAGE(dims, n_classes=...)) so it "
                "carries a 'head' to train")
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device={device} but the mesh's rank runs "
                                 f"on {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.layers = list(model.layers)
        self.train_cfg = train
        self._head = model.head if train is not None else None
        self.delivery = make_delivery(cfg.delivery_backend)
        self.part = StreamingPartitioner(
            cfg.n_parts, cfg.max_nodes, method=cfg.partitioner,
            seed=cfg.seed, node_cap=cfg.node_cap, edge_cap=cfg.edge_cap,
            repl_cap=cfg.repl_cap)
        dims = self._dims()
        self.d_in, self.d_out = dims[0], dims[-1]
        # the per-layer 0/1 activation flags (the staged layers' act leaf)
        self._acts = tuple(1.0 if getattr(l, "act", False) else 0.0
                           for l in self.layers)
        self._answer_log: list = []    # host-side answered-row columns
        self.now = 0
        self.metrics = StreamMetrics(
            busy_logical=np.zeros(cfg.n_parts, np.int64))
        self._empty_edge_rows = {
            k: np.zeros(0, np.int64) for k in
            ("part", "edge_slot", "src_slot", "dst_slot",
             "dst_master_part", "dst_master_slot")}
        self._set_grid(mesh, cfg)
        if self.mesh is None or self.mesh.member:
            self._alloc_state()
        else:
            self._drop_state()
        # telemetry plane: the trace recorder and the straggler feed. The
        # lane list and the all_to_all multiplier let the cost model
        # re-price the wire at other route_caps (the constants of
        # _static_wire_bytes)
        if cfg.telemetry:
            lanes = self._wire_lane_list(dims, n_dev, S)
            a2a_mult = 4 * S * n_dev * n_dev if lanes else 0
            a2a = a2a_mult * sum(self._lane_cap(c) * w for c, w in lanes)
            self.trace = TraceRecorder(meta={
                "n_parts": cfg.n_parts, "n_devices": n_dev, "n_stages": S,
                "n_layers": len(self.layers), "dims": list(dims),
                "window": cfg.window.kind,
                "delivery_backend": cfg.delivery_backend,
                "delta_eps": cfg.delta_eps,
                "route_cap": cfg.route_cap,
                "route_defer_cap": cfg.route_defer_cap,
                "node_cap": cfg.node_cap, "edge_cap": cfg.edge_cap,
                "repl_cap": cfg.repl_cap, "feat_cap": cfg.feat_cap,
                "edge_tick_cap": cfg.edge_tick_cap,
                "query_cap": cfg.query_cap,
                "query_tick_cap": cfg.query_tick_cap,
                "train_cap": cfg.train_cap,
                "caps": asdict(cfg.capacities(n_dev)),
                "wire_bytes_per_tick": self._wire_bytes_per_tick,
                "wire_lanes": [list(l) for l in lanes],
                "a2a_mult": a2a_mult,
                "fixed_wire_bytes": self._wire_bytes_per_tick - a2a})
            self.straggler = StragglerMitigator(n_shards=n_dev)
        else:
            self.trace = None
            self.straggler = None

    # ------------------------------------------------- grid and layout
    def _dims(self) -> list:
        return [l.in_dim for l in self.layers] + [self.layers[-1].out_dim]

    def _set_grid(self, mesh, cfg) -> None:
        """Install (mesh, cfg): the router, the stage layout and every
        constant derived from the grid (no state moves here)."""
        S = mesh.n_stages if mesh is not None else 1
        n_dev = mesh.n_data if mesh is not None else 1
        dims = self._dims()
        if S > 1:
            self._check_uniform_layers(dims, S)
        self.mesh, self.cfg = mesh, cfg
        self.n_stages, self._n_data = S, n_dev
        self._n_rounds = len(self.layers) // S
        self.router = (MeshRouter(cfg.n_parts, mesh, route_cap=cfg.route_cap,
                                  pack_backend=cfg.delivery_backend,
                                  telemetry=cfg.telemetry)
                       if mesh is not None and mesh.member
                       else LocalRouter(cfg.n_parts))
        caps = cfg.capacities(n_dev)
        p_loc = cfg.n_parts // n_dev
        # the inter-stage ring: one packed-FeatBatch slot shape carries
        # both the host inbox (feat_cap rows) and any round's outbox
        # (p_loc * cap_pp rows) between stages
        self._ring_caps = (max(cfg.feat_cap, p_loc * caps.outbox_per_part),
                           dims[0] + 3)
        self._wire_bytes_per_tick = self._static_wire_bytes(dims, n_dev, S)
        dev = self.device
        self._act_leaves = [torch.tensor(a, dtype=torch.float32, device=dev)
                            for a in self._acts]
        self._empty_queries = empty_query_batch(caps.query_admissions,
                                                self.d_out, dev)
        self._empty_queries_np = empty_query_batch(caps.query_admissions,
                                                   self.d_out)
        self._empty_labels = ev.empty_label_batch(cfg.train_cap, dev)
        self._empty_labels_np = ev.empty_label_batch(cfg.train_cap)

    def _stage_layers(self) -> list:
        """The layers this rank runs, round by round: l = r * S + s for
        its stage s (every layer on a 1-D mesh)."""
        S, s = self.n_stages, self.router.stage_index()
        return [r * S + s for r in range(self._n_rounds)]

    def _alloc_state(self) -> None:
        """Fresh device state for this rank's block of parts and its
        stage's layers; the defer rings are sized per lane from the
        rank's local emission capacities."""
        cfg, dev, n_dev = self.cfg, self.device, self._n_data
        caps = cfg.capacities(n_dev)
        p_loc = cfg.n_parts // n_dev
        dims = self._dims()
        self.topo = st.init_topo(p_loc, cfg.edge_cap, cfg.repl_cap,
                                 cfg.node_cap, dev)
        self.states = [st.init_layer(
            p_loc, cfg.node_cap, dims[l], dims[l], dev,
            bc_defer_rows=caps.bc_defer_rows // n_dev,
            rmi_defer_rows=caps.rmi_defer_rows // n_dev)
            for l in self._stage_layers()]
        self.sink = torch.zeros((p_loc, cfg.node_cap, self.d_out),
                                dtype=torch.float32, device=dev)
        self.sink_seen = torch.zeros((p_loc, cfg.node_cap),
                                     dtype=torch.bool, device=dev)
        # the query plane's pending table (and, on a capped mesh, its wire
        # lane's defer ring); [p_loc, 0] tables when the plane is off
        self.queries = init_query_state(
            p_loc, cfg.query_cap, self.d_out, dev,
            wire_defer_rows=caps.query_defer_rows // n_dev)
        # the training plane's device state: labels/dirty window, live
        # params, per-part optimizer state (core/train_plane.py); on a 2-D
        # mesh every stage holds the same copy
        self.train_state = (init_train_state(
            p_loc, cfg.node_cap, self.params, linear_tree(self.model.head),
            self.train_cfg, dev) if self.train_cfg is not None else None)
        self.stage_ring = (torch.zeros(
            (self._n_rounds,) + self._ring_caps, dtype=torch.float32,
            device=dev) if self.n_stages > 1 else None)

    def _drop_state(self) -> None:
        self.topo = self.states = self.sink = self.sink_seen = None
        self.queries = self.train_state = self.stage_ring = None

    @property
    def active(self) -> bool:
        """Does this process hold pipeline state (False: a dormant rank
        outside the mesh)?"""
        return self.states is not None

    def _need_active(self) -> None:
        if not self.active:
            raise RuntimeError(
                "this process is outside the pipeline's mesh (a dormant "
                "rank): it holds no state and takes part only in reshard")

    def _lane_cap(self, capacity: int) -> int:
        route_cap = self.cfg.route_cap
        return capacity if route_cap is None else max(1, min(route_cap,
                                                             capacity))

    def _check_uniform_layers(self, dims, n_stages: int) -> None:
        """Stage parallelism runs one round body per stage, so the stack
        must be SPMD-uniform: same layer class, same aggregator, and
        in_dim == out_dim == d on every layer (one ring row width serves
        all rounds). The activation flag is exempt: StagedActLayer turns
        it into data."""
        base = self.layers[0]
        uniform = (len(set(dims)) == 1 and all(
            type(l) is type(base) and hasattr(l, "act")
            and getattr(l, "agg_kind", "mean")
            == getattr(base, "agg_kind", "mean")
            for l in self.layers))
        if not uniform:
            raise ValueError(
                f"PipelineConfig.n_stages={n_stages} needs an "
                "SPMD-uniform layer stack (same class/aggregator, in_dim "
                "== out_dim on every layer, differing at most in the "
                f"activation flag), got dims={dims} over "
                f"{[type(l).__name__ for l in self.layers]} — pipeline "
                "stages run one shared round body per stage")

    def _staged_params(self) -> dict:
        """This rank's stage slice of the reference's staged params: round
        r's entry is {"p": the parameter tree of layer r * S + s, "act":
        its 0/1 activation flag} (detached views of the modules' weights,
        so the training plane's in-place updates show through)."""
        return {f"r{r}": {"p": self.layers[l].param_tree(),
                          "act": self._act_leaves[l]}
                for r, l in enumerate(self._stage_layers())}

    def _unstack_stats(self, rows, n_rounds: int):
        """Gathered per-rank stats rows [ranks, X] (each rank's per-round
        scalars, then its per-round busy vectors) -> the drivers'
        per-LAYER host TickStats: layer l = r * S + s is round r on stage
        s, its scalars read from the first rank of stage row s (reduced
        over the row already), its busy vector the row's data shards'
        blocks concatenated. The 1-D mesh is S = 1, one round a layer."""
        S, D = self.n_stages, rows.shape[0] // self.n_stages
        F = len(SCALAR_FIELDS)
        P = self.cfg.n_parts // self._n_data
        out = []
        for l in range(len(self.layers)):
            r, s = divmod(l, S)
            sc = rows[s * D, r * F:(r + 1) * F]
            busy = rows[s * D:(s + 1) * D, n_rounds * F + r * P:
                        n_rounds * F + (r + 1) * P].reshape(-1)
            out.append(TickStats(**dict(zip(SCALAR_FIELDS, sc)), busy=busy))
        return out

    def layer_state(self, l: int):
        """Layer l's LayerState on this rank: the 1-D engine keeps one per
        layer; on a 2-D mesh layer l = r * S + s lives at round r on the
        ranks of stage s (other stages hold no copy, and raise)."""
        r, s = divmod(l, self.n_stages)
        if s != self.router.stage_index():
            raise ValueError(f"layer {l} lives on stage {s}, not on this "
                             f"rank's stage {self.router.stage_index()}")
        return self.states[r]

    def set_layer_state(self, l: int, ls) -> None:
        """Write layer l's LayerState back (the coordinator's rebuild;
        on a 2-D mesh, on a rank of the layer's stage)."""
        self.layer_state(l)
        self.states[l // self.n_stages] = ls

    def _ring_occupancy(self) -> torch.Tensor:
        """This rank's valid rows in flight between stages (0-d int64; 0
        on a 1-D mesh). The valid flag packs LAST in a FeatBatch row."""
        if self.stage_ring is None:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return (self.stage_ring[..., -1] > 0.5).sum()

    def _ring_occupancy_host(self) -> int:
        """Valid rows in flight between stages over the whole mesh (0 on
        a 1-D mesh): the flush must not terminate over them. Collective on
        a 2-D mesh."""
        if self.stage_ring is None:
            return 0
        return int(self.router.psum_vote(self._ring_occupancy()))

    def bubble_fraction(self) -> float:
        """Measured pipeline-bubble fraction: device-rounds that saw an
        empty inbox over all device-rounds (0.0 on a 1-D mesh)."""
        total = self.metrics.ticks * len(self.layers) * self._n_data
        if self.n_stages <= 1 or total == 0:
            return 0.0
        return self.metrics.stage_idle / total

    def _wire_lane_list(self, dims, n_dev: int, n_stages: int = 1):
        """The capped-exchange lanes of one tick as (local emission
        capacity, wire width) pairs: the constants `_static_wire_bytes`
        prices (its all_to_all term is 4 S D^2 * sum lane_cap(c) * w),
        recorded in the trace meta so the cost model can replay the wire
        at another route_cap. Empty without a mesh. On a 2-D mesh a stage
        row runs R = L // S rounds of width dims[0]."""
        if self.mesh is None or n_dev <= 1:
            return []
        cfg = self.cfg
        p_loc = cfg.n_parts // n_dev
        lanes = []
        n_lay = self._n_rounds if n_stages > 1 else len(self.layers)
        for li in range(n_lay):
            d = dims[0] if n_stages > 1 else dims[li]
            lanes.append((p_loc * cfg.repl_cap, d + 5))
            lanes.append((cfg.edge_tick_cap + p_loc * cfg.edge_cap, d + 5))
        if cfg.query_cap > 0:
            lanes.append((p_loc * cfg.query_cap, wire_width(dims[-1])))
        return lanes

    def save_trace(self, path) -> None:
        """Write the recorded telemetry trace (needs cfg.telemetry)."""
        if self.trace is None:
            raise ValueError("telemetry plane disabled "
                             "(PipelineConfig.telemetry=False)")
        self.trace.save(path)

    def reshard(self, new_mesh, cfg: Optional[PipelineConfig] = None):
        """LIVE elastic reshard (Alg. 5): relay the whole carry (layer
        tables, defer rings, the inter-stage ring, QueryState, TrainState
        with its optimizer state) from the current mesh onto `new_mesh`
        (another D-shard or S' x D' grid of the same world, or None for a
        local pipeline on the old mesh's rank 0) without dropping
        in-flight work. Collective over the process group's WORLD when a
        mesh is involved: every process calls it, with its own view of
        `new_mesh` (members of the old mesh, of the new one, and dormant
        ones). A process outside the new mesh keeps nothing (dormant).

        State is keyed by LOGICAL part, so the [P, ...] tables move
        between owners in the reference's global layout: the old mesh
        gathers it (`ft/checkpoint.py:gather_tree`, as a checkpoint does)
        and every new rank takes its block (`local_block`); a process
        outside the old mesh receives the carry and the host side (the
        partitioner's tables, the clock, the metrics and answer log) from
        the old mesh's rank 0. Only the packed buffers whose LAYOUT
        depends on the grid are re-blocked (ft/elastic.py): the defer
        rings compact into the new global capacities (their rows are
        destination-addressed), and the inter-stage ring's slabs re-block
        by part ownership under the new p_loc. Held `consistent` queries
        ride the QueryState tables and answer after the move as without
        it.

        `cfg` optionally replaces the config (default: the current one
        with n_stages matched to the new mesh); it is validated against
        the new grid and installed, and the previous config object is
        never mutated. A stage-count change needs an empty inter-stage
        ring (flush() first); a reshard that would overflow the new defer
        capacities raises instead of dropping rows; the training and
        telemetry planes cannot be switched on or off. Every process that
        holds the carry checks these alike, before anything moves.
        Returns the installed config; `last_reshard` records the seconds
        and the bytes this rank sent."""
        if new_mesh is not None and not isinstance(new_mesh, StreamMesh):
            raise TypeError(f"new_mesh must be a dist.mesh.StreamMesh or "
                            f"None, got {type(new_mesh).__name__}")
        from repro_torch.ft.checkpoint import (_leaf_kind, gather_tree,
                                               install_tree, local_block,
                                               pipeline_tree, tree_flatten,
                                               tree_unflatten)
        from repro_torch.ft.elastic import repack_defer_ring, repack_stage_slab

        t0 = time.perf_counter()
        L = len(self.layers)
        S = new_mesh.n_stages if new_mesh is not None else 1
        n_dev = new_mesh.n_data if new_mesh is not None else 1
        if cfg is None:
            cfg = replace(self.cfg, n_stages=S)
        if new_mesh is not None and S != cfg.n_stages:
            raise ValueError(
                f"new mesh has stage={S} but cfg.n_stages={cfg.n_stages}: "
                "the stage counts must agree")
        cfg.validate(n_devices=S * n_dev, n_layers=L,
                     local=new_mesh is None)
        if (self.train_cfg is not None) != (cfg.train_cap > 0):
            raise ValueError(
                "reshard cannot turn the training plane on or off: "
                f"train_state is "
                f"{'set' if self.train_cfg is not None else 'None'} "
                f"but cfg.train_cap={cfg.train_cap}")
        if cfg.telemetry != self.cfg.telemetry:
            raise ValueError("reshard cannot turn the telemetry plane on "
                             "or off")
        dims = self._dims()
        if S > 1:
            self._check_uniform_layers(dims, S)
        old = self.mesh
        if old is None and new_mesh is None:
            # local -> local: the carry stays where it is
            self._set_grid(None, cfg)
            self._after_reshard(t0, 0)
            return cfg

        # (1) the global carry and the host side where they are needed
        sent0 = _sent_bytes(old)
        if old is not None and old.member:
            gtree = tree_unflatten(pipeline_tree(self), [
                l for _, l in gather_tree(self, kind="reshard")])
        else:
            gtree = None
        old_S, old_D = self.n_stages, self._n_data
        old_ranks = set(old.world_ranks) if old is not None else None
        new_ranks = (set(new_mesh.world_ranks) if new_mesh is not None
                     else None)
        if old is None:
            # a local pipeline (or a dormant process after a reshard to
            # local): the process holding the carry is the source
            t = torch.tensor([dist.get_rank() if self.active
                              else dist.get_world_size()])
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            src, relay = int(t[0]), True
        else:
            src = old.world_ranks[0]
            relay = new_ranks is not None and not new_ranks <= old_ranks
        if relay:
            box = [None]
            if dist.get_rank() == src:
                box = [{"tree": _tree_to(gtree, "cpu"), "S": old_S,
                        "D": old_D, "host": (self.part, self.now,
                                             self.metrics, self._answer_log,
                                             self.trace)}]
            dist.broadcast_object_list(box, src=src)
            got = box[0]
            if gtree is None:
                gtree, old_S, old_D = got["tree"], got["S"], got["D"]
                (self.part, self.now, self.metrics, self._answer_log,
                 self.trace) = got["host"]
        stays = (new_mesh.member if new_mesh is not None
                 else (old is None and self.active)
                 or (old is not None and old.rank == 0))
        if not stays:
            self._set_grid(new_mesh, cfg)
            self._drop_state()
            self._after_reshard(t0, _sent_bytes(old) - sent0)
            return cfg

        # (2) re-block the global carry for the new grid (JAX's reshard on
        # global arrays; every holder computes the same, refusals too)
        dev = new_mesh.device if new_mesh is not None else self.device
        caps = cfg.capacities(n_dev)
        p_loc = cfg.n_parts // n_dev

        def _lost(n, what):
            if int(n):
                raise RuntimeError(
                    f"reshard would drop {int(n)} in-flight {what} rows — "
                    "flush() to quiescence first or raise route_defer_cap")

        if old_S > 1:
            layer_states = [_tree_map(lambda a, s=l % old_S: a[s],
                                      gtree["layers"][l // old_S])
                            for l in range(L)]
        else:
            layer_states = list(gtree["layers"])
        for i, ls in enumerate(layer_states):
            b, bok, lb = repack_defer_ring(ls.bc_defer, ls.bc_defer_ok,
                                           caps.bc_defer_rows)
            r, rok, lr = repack_defer_ring(ls.rmi_defer, ls.rmi_defer_ok,
                                           caps.rmi_defer_rows)
            _lost(lb, f"layer {i} broadcast-defer")
            _lost(lr, f"layer {i} RMI-defer")
            layer_states[i] = replace(ls, bc_defer=b, bc_defer_ok=bok,
                                      rmi_defer=r, rmi_defer_ok=rok)
        q = gtree["queries"]
        qw, qok, lq = repack_defer_ring(q.wire_defer, q.wire_defer_ok,
                                        caps.query_defer_rows)
        _lost(lq, "query-wire-defer")
        queries = replace(q, wire_defer=qw, wire_defer_ok=qok)
        # the inter-stage ring: a stage-count change cannot relabel rows'
        # (stage, round) coordinates, so it needs an empty ring; a
        # data-axis-only reshard re-blocks rows by part ownership
        ring = gtree["stage_ring"]
        in_flight = int((ring[..., -1] > 0.5).sum()) if ring is not None \
            else 0
        if S != old_S and in_flight:
            raise RuntimeError(
                f"reshard {old_S}->{S} stages with {in_flight} rows in the "
                "inter-stage ring — flush() to quiescence first "
                "(data-axis-only reshards keep in-flight rows)")
        new_ring = None
        if S > 1:
            C = max(cfg.feat_cap, p_loc * caps.outbox_per_part)
            R = L // S
            new_ring = torch.zeros((S, R, n_dev * C, dims[0] + 3),
                                   dtype=torch.float32, device=ring.device
                                   if ring is not None else dev)
            if old_S == S and ring is not None:
                for s_i in range(S):
                    for r_i in range(R):
                        slab, lost = repack_stage_slab(
                            ring[s_i, r_i], 0, dims[0] + 2, p_loc, n_dev, C)
                        _lost(lost, f"stage-ring ({s_i},{r_i})")
                        new_ring[s_i, r_i] = slab
            rounds = [_tree_map(lambda *xs: torch.stack(xs),
                                *[layer_states[r * S + s] for s in range(S)])
                      for r in range(R)]
        else:
            rounds = layer_states
        gnew = dict(gtree, layers=rounds, queries=queries,
                    stage_ring=new_ring)
        del gtree, layer_states

        # (3) install the new grid and this rank's block
        self.device = dev
        self._set_grid(new_mesh, cfg)
        grid = ((S, n_dev, new_mesh.stage_index, new_mesh.data_index)
                if new_mesh is not None else (1, 1, 0, 0))
        pairs = tree_flatten(gnew)
        install_tree(self, tree_unflatten(gnew, [
            local_block(_leaf_kind(p), x, *grid).to(dev).clone()
            for p, x in pairs]))
        self._after_reshard(t0, _sent_bytes(old) - sent0)
        return cfg

    def _after_reshard(self, t0, sent) -> None:
        """Telemetry bookkeeping of a reshard and its measurements."""
        n_dev, S = self._n_data, self.n_stages
        if self.trace is not None:
            self.trace.meta["n_devices"] = n_dev
            self.trace.meta["n_stages"] = S
            self.trace.meta.setdefault("reshards", []).append(
                {"tick": int(self.now), "n_devices": n_dev, "n_stages": S})
        if self.cfg.telemetry:
            self.straggler = StragglerMitigator(n_shards=n_dev)
        self.last_reshard = {"seconds": time.perf_counter() - t0,
                             "sent_bytes": sent}

    def mitigate_stragglers(self):
        """Consume the straggler mitigator's persistent flags (fed live by
        the telemetry plane): a shard that stays flagged past `patience`
        is treated as fail-slow == fail-stop and the pipeline LIVE-reshards
        onto fewer data shards, re-mapping `parts_per_shard()` so the slow
        shard owns nothing. Returns the RescalePlan when a reshard
        happened, else None (no mitigator, no mesh, one data shard, no
        persistent straggler).

        Block sharding keeps parts contiguous, so the survivor count is
        the largest divisor of n_parts below the current D that keeps the
        stage grid. Collective over the world, as `reshard`: every process
        calls it, and every one takes the decision of the mesh's first
        world rank. Each rank feeds its mitigator its own wall clock, so a
        wall spike on one rank flags on that rank alone: deciding from
        each rank's own flags would send some ranks into the reshard's
        collectives and not the others (JAX decides once, in its one
        host process)."""
        from repro_torch.ft.elastic import rescale_parts
        from repro_torch.launch.mesh import survivor_mesh
        if self.straggler is None or self.mesh is None:
            return None
        slow = (self.straggler.persistent_stragglers()
                if self.active and self._n_data > 1 else [])
        box = [slow]
        dist.broadcast_object_list(box, src=self.mesh.world_ranks[0])
        slow = box[0]
        if not slow or self._n_data <= 1:
            return None
        old_d = self._n_data
        new_d = old_d - len(set(slow))
        while new_d > 1 and self.cfg.n_parts % new_d:
            new_d -= 1
        new_d = max(new_d, 1)
        new_mesh = survivor_mesh(self.mesh, slow, n_data=new_d)
        plan = rescale_parts(old_d, new_d, self.cfg.n_parts)
        self.reshard(new_mesh)
        return plan

    def parts_per_shard(self) -> list:
        """Logical parts owned by each data shard (block sharding)."""
        D = self._n_data
        p_loc = self.cfg.n_parts // D
        return [np.arange(d * p_loc, (d + 1) * p_loc) for d in range(D)]

    def _static_wire_bytes(self, dims, n_dev: int, n_stages: int = 1) -> int:
        """EXACT collective bytes per tick across the whole mesh: every
        rank ships a [D, cap * W] f32 send buffer per lane per route_lanes
        call, so a tick moves D * sum_lanes D * cap * W * 4 bytes (host
        int arithmetic, as in JAX). MsgBatch lanes are d + 5 wide; the
        query wire lane (layer 0's round B) d_out + 10. The training plane
        adds two DENSE lanes a layer (hop A: repl_cap rows of dagg, hop B:
        node_cap rows of source gradients a part; route_cap does not apply
        to gradient lanes).

        On a 2-D mesh the data-axis exchange runs once per ROUND per stage
        row, the query wire rides round 0 on every stage, and the stage
        axis adds its own wires, priced as the reference prices them: one
        [C_buf, W_fb] slot a round a rank (stage_shift) and the final
        round's gather feeding the replicated sinks (S - 1 foreign slots
        a rank); with training, the per-round stage gather of the layer
        caches (feat, agg, agg_cnt)."""
        if self.mesh is None:
            return 0
        cfg = self.cfg
        p_loc = cfg.n_parts // n_dev
        lanes = self._wire_lane_list(dims, n_dev, n_stages)
        total = n_stages * n_dev * sum(n_dev * self._lane_cap(c) * w * 4
                                       for c, w in lanes)
        if n_stages > 1:
            C_buf, W_fb = self._ring_caps
            slot = C_buf * W_fb * 4
            total += n_stages * n_dev * self._n_rounds * slot
            total += n_stages * n_dev * (n_stages - 1) * slot
            if self.train_cfg is not None:
                d = dims[0]
                if n_dev > 1:
                    total += (n_stages * n_dev * len(self.layers) * n_dev
                              * (p_loc * cfg.repl_cap + p_loc * cfg.node_cap)
                              * (d + 5) * 4)
                total += (n_stages * n_dev * (n_stages - 1) * self._n_rounds
                          * p_loc * cfg.node_cap * (2 * d + 1) * 4)
        elif self.train_cfg is not None and n_dev > 1:
            total += n_dev * sum(
                n_dev * (p_loc * cfg.repl_cap + p_loc * cfg.node_cap)
                * (dims[li] + 5) * 4 for li in range(len(self.layers)))
        return total

    def _stats_to_host(self, stats_all, *extra, answers=None, occ=None):
        """Per-round TickStats (+ extra 0-d int64 tensors, + the answer
        rows of one or T ticks, + the telemetry occupancy rows of one or T
        ticks) to the host in ONE device-to-host copy; on a mesh every
        rank's copy is gathered first (one all_gather over the mesh).
        stats_all holds one entry a layer on a 1-D mesh, one a round on a
        2-D mesh (`_unstack_stats` puts the layers back together).
        answers: a list of per-tick AnswerBatches; they ride the copy
        packed as f32 wire rows (`dist/wire.py`, ints exact below 2**24)
        whose bits fill int64 words; on a 2-D mesh every stage answers
        alike and stage 0's rows are read. occ: a list of per-tick int64
        occupancy rows (already reduced over the mesh). Extras are read
        from rank 0 (reduced already).
        Returns (list of host TickStats a layer, extra ints, host
        AnswerBatch rows tick by tick then rank by rank or None, [T, C]
        numpy occupancy rows or None)."""
        nR = len(stats_all)
        parts = [torch.stack([getattr(s, f) for f in SCALAR_FIELDS])
                 for s in stats_all] + [s.busy for s in stats_all]
        if extra:
            parts.append(torch.stack(list(extra)))
        n_occ = 0
        if occ:
            parts.append(torch.stack(occ).reshape(-1))
            n_occ = parts[-1].numel()
        n_int = sum(p.numel() for p in parts)
        if answers:
            words = torch.stack([pack_lane(a) for a in answers]).reshape(-1)
            n_words = words.numel()
            if n_words % 2:
                words = torch.cat([words, words.new_zeros(1)])
            parts.append(words.view(torch.int64))
        flat = torch.cat(parts)
        spans.phase("wait")
        if self.mesh is None:
            rows = flat.cpu()[None]
        else:
            rows = self.mesh.all_gather(flat).cpu()
        spans.phase("post")
        out = self._unstack_stats(rows, nR)
        F, P = len(SCALAR_FIELDS), stats_all[0].busy.shape[0]
        host_extra = [int(v) for v in rows[0, nR * (F + P):n_int - n_occ]]
        host_occ = (rows[0, n_int - n_occ:n_int].numpy().reshape(
            len(occ), -1) if occ else None)
        if not answers:
            return out, host_extra, None, host_occ
        proto = answers[0]
        A, W = proto.valid.shape[0], lane_width(proto)
        rows = rows[:self._n_data]                  # stage 0's row
        buf = rows[:, n_int:].contiguous().view(torch.float32)[:, :n_words]
        # [ranks, T, A, W] -> tick by tick, then rank by rank
        buf = buf.reshape(rows.shape[0], len(answers), A, W).transpose(0, 1)
        return (out, host_extra, unpack_lane(buf.reshape(-1, W), proto),
                host_occ)

    # ------------------------------------------------------------ host side
    def _resolve_queries(self, queries, issue_tick: int) -> dict:
        """Resolve host query requests [(qid, kind, vid, [vid2],
        consistent)] to master-(part, slot)-addressed rows. Requests that
        name a vertex the partitioner has never seen, or a qid the packed
        f32 wire cannot carry exactly (>= 2**24), are answered HERE
        (ok=False, zero payload, answer tick = issue tick) instead of
        taking device slots."""
        rows = {k: [] for k in ("qid", "kind", "part", "slot", "part2",
                                "slot2", "consistent", "issue")}
        rejects = []

        def locate(vid):
            if not 0 <= vid < self.cfg.max_nodes:
                return None
            return self.part.locate_master(vid, create=False)

        for q in queries:
            qid, kind, vid = int(q[0]), int(q[1]), int(q[2])
            vid2 = int(q[3]) if kind == KIND_LINK else 0
            # a qid at or past 2**24 would round on the wire and answer
            # under the WRONG qid
            if not 0 <= qid < 2 ** 24:
                rejects.append((qid, kind))
                continue
            m = locate(vid)
            m2 = locate(vid2) if kind == KIND_LINK else (0, 0)
            if m is None or m2 is None:
                rejects.append((qid, kind))
                continue
            rows["qid"].append(qid)
            rows["kind"].append(kind)
            rows["part"].append(m[0])
            rows["slot"].append(m[1])
            rows["part2"].append(m2[0])
            rows["slot2"].append(m2[1])
            rows["consistent"].append(bool(q[-1]))
            rows["issue"].append(issue_tick)
        if rejects:
            r = np.asarray(rejects, np.int64).reshape(-1, 2)
            self._answer_log.append({
                "qid": r[:, 0], "kind": r[:, 1],
                "ok": np.zeros(len(r), bool),
                "tick": np.full(len(r), issue_tick, np.int64),
                "issue": np.full(len(r), issue_tick, np.int64),
                "vec": np.zeros((len(r), self.d_out), np.float32),
                "score": np.zeros(len(r), np.float32)})
        return {k: np.asarray(v) for k, v in rows.items()}

    def _build_batches(self, edges: Optional[np.ndarray],
                       feats: Optional[list], device=None,
                       queries: Optional[list] = None,
                       issue_tick: Optional[int] = None,
                       labels: Optional[list] = None):
        """One tick's padded (edge, repl, vertex, feat, query, label)
        batches; device=None keeps numpy leaves for the super-tick staging
        path. queries: the tick's query requests (the `tick()` format),
        stamped with issue_tick (default: the current tick). labels:
        [(vid, gold_class), ...] training-plane admissions, resolved to
        master coordinates (the last label of a vid wins); vids the
        partitioner has never seen are skipped."""
        cfg = self.cfg
        # the launch log's ingest counts and staging spans
        spans.count("edges", len(edges) if edges is not None else 0)
        spans.count("feats", len(feats) if feats else 0)
        spans.count("queries", len(queries) if queries else 0)
        spans.count("labels", len(labels) if labels else 0)
        if edges is not None and len(edges):
            with spans.span("stage.partition"):
                e_rows, r1, v1 = self.part.ingest_edges(edges)
        else:
            e_rows, r1, v1 = self._empty_edge_rows, None, None
        # feature events may create vertices (cold features)
        f_parts, f_slots, f_vecs = [], [], []
        if feats:
            with spans.span("stage.features"):
                coalesced = {}
                for vid, vec in feats:    # host-side coalescing (last wins)
                    coalesced[int(vid)] = vec
                for vid, vec in coalesced.items():
                    p, s = self.part.locate_master(vid)
                    f_parts.append(p)
                    f_slots.append(s)
                    f_vecs.append(vec)
        r2, v2 = self.part.drain_allocations()
        if r1 is not None:
            r_rows = {k: np.concatenate([r1[k], r2[k]]) for k in r2}
            v_rows = {k: np.concatenate([v1[k], v2[k]]) for k in v2}
        else:
            r_rows, v_rows = r2, v2
        with spans.span("stage.pack"):
            eb = ev.edge_batch_from_numpy(e_rows, cfg.edge_tick_cap, device)
            rb = ev.repl_batch_from_numpy(
                r_rows, max(2 * cfg.edge_tick_cap, 1), device)
            vb = ev.vertex_batch_from_numpy(
                v_rows, max(2 * cfg.edge_tick_cap + cfg.feat_cap, 1), device)
            fb = ev.feat_batch_from_numpy(
                np.asarray(f_parts, np.int64), np.asarray(f_slots, np.int64),
                np.asarray(f_vecs, np.float32).reshape(len(f_parts), -1)
                if f_parts else np.zeros((0, self.d_in), np.float32),
                cfg.feat_cap, self.d_in, device)
        if queries:
            if cfg.query_cap <= 0:
                raise ValueError("queries submitted but "
                                 "PipelineConfig.query_cap=0")
            with spans.span("stage.queries"):
                q_rows = self._resolve_queries(
                    queries, self.now if issue_tick is None else issue_tick)
            with spans.span("stage.pack"):
                qb = query_batch_from_numpy(q_rows, cfg._query_admissions(),
                                            self.d_out, device)
        else:
            qb = (self._empty_queries if device is not None
                  else self._empty_queries_np)
        if labels:
            if cfg.train_cap <= 0:
                raise ValueError("labels submitted but "
                                 "PipelineConfig.train_cap=0")
            with spans.span("stage.labels"):
                gold = {}
                for vid, y in labels:
                    m = self.part.locate_master(int(vid), create=False)
                    if m is not None:
                        gold[m] = int(y)
            with spans.span("stage.pack"):
                lb = ev.label_batch_from_numpy(
                    np.asarray([m[0] for m in gold], np.int64),
                    np.asarray([m[1] for m in gold], np.int64),
                    np.asarray(list(gold.values()), np.int64),
                    cfg.train_cap, device)
        else:
            lb = (self._empty_labels if device is not None
                  else self._empty_labels_np)
        return eb, rb, vb, fb, qb, lb

    # ---------------------------------------------------------- device side
    @torch.no_grad()
    def _tick_program(self, topo, states, sink, sink_seen, queries, fb, eb,
                      rb, vb, qb, lb, now, wconf):
        """ONE micro-tick on the device: topology application, the query
        plane's admit/head-hop stage, L layer ticks (the query wire rides
        layer 0's round-B exchange), the sink update, the query plane's
        answer stage and the training plane's step (which updates
        self.train_state and mirrors the live parameters into the model).
        Apart from a mesh's collectives, never reads a value back to the
        host. At query_cap=0 / train_cap=0 a plane's stages are skipped
        and the program is the one without it.
        With telemetry on, the tick's occupancy row (`_occ_row`) is built
        on the device too.
        Returns (topo, states, sink, sink_seen, queries, stats_all,
        answers or None, QueryStats or None, occupancy row or None)."""
        outbox_cap = self.cfg.capacities().outbox
        part0 = self.router.part0()
        with spans.region("tick.topology"):
            topo = st.apply_vertex_batch(topo, vb, part0)
            topo = st.apply_repl_batch(topo, rb, part0)
            topo = st.apply_edge_batch(topo, eb, part0)
        # does this tick ingest anything that could move state? (the
        # batches are replicated: every rank votes alike); consistent link
        # heads fire only when the whole tick is provably still
        with spans.region("tick.query_admit"):
            batch_work = (fb.valid.any() | eb.valid.any() | rb.valid.any()
                          if self.cfg.query_cap else None)
            queries, wire, adm_drop, n_adm = query_admit_stage(
                queries, qb, states, sink, sink_seen, self.router,
                batch_work)
        wire_d = None
        inbox = fb
        new_states, stats_all = [], []
        for li, layer in enumerate(self.layers):
            # topology reaches every layer; features only layer 0
            extra = ((wire, (queries.wire_defer, queries.wire_defer_ok))
                     if li == 0 and wire is not None else None)
            ls, inbox, stats, extra_out = layer_tick_body(
                layer, topo, states[li], inbox, eb, rb, now, wconf,
                outbox_cap, self.router, self.delivery, extra_lane=extra,
                delta_eps=self.cfg.delta_eps, telemetry=self.cfg.telemetry)
            if extra_out is not None:
                wire_d, (wdb, wdo) = extra_out
                queries = replace(queries, wire_defer=wdb, wire_defer_ok=wdo)
            new_states.append(ls)
            stats_all.append(stats)
        # sink: final-layer emissions materialize the embedding table
        with spans.region("tick.sink"):
            sink, sink_seen = _sink_update_body(sink, sink_seen, inbox,
                                                part0)
        # query plane: answer point queries from the fresh sink
        with spans.region("tick.query_answer"):
            queries, answers, qstats = query_answer_stage(
                queries, wire_d, qb, adm_drop, n_adm, new_states, sink,
                sink_seen, now, stats_all, self.router)
        # training plane: one windowed online step through the live state
        # (stats scalars are already reduced over the mesh)
        if self.train_cfg is not None:
            with spans.region("tick.train"):
                ts = self.train_state
                moved = sum(moved_msgs(s) for s in stats_all)
                self.train_state = train_stage(
                    self.train_cfg, self._head,
                    [(layer, ts.params[f"l{li}"])
                     for li, layer in enumerate(self.layers)],
                    [(ls.feat, ls.agg, ls.agg_cnt) for ls in new_states],
                    topo, sink, sink_seen, ts, lb, inbox, now, moved,
                    self.router, part0, self.delivery)
                self._sync_params_from_train()
        occ = (_occ_row(stats_all, qstats, self.train_state, self.router)
               if self.cfg.telemetry else None)
        return (topo, new_states, sink, sink_seen, queries, stats_all,
                answers, qstats, occ)

    @torch.no_grad()
    def _tick_program_2d(self, topo, states, sink, sink_seen, queries, ring,
                         fb, eb, rb, vb, qb, lb, now, wconf):
        """ONE micro-tick of the LAYER-PIPELINED program on this rank of a
        2-D ("stage", "data") mesh (the reference's `_tick_program_2d`).

        Layer l = r * S + s lives on stage s and runs at round r; each
        tick every stage runs its R = L // S rounds one hop behind: round
        r's inbox is what the previous stage shifted into ring slot r
        last tick, except on stage 0, whose round 0 reads the host
        feature inbox and whose round r > 0 reads slot r - 1 (the wrap
        hop from stage S - 1's round r - 1). Every round's outbox is
        `stage_shift`ed right after its compute. The final layer's rows
        reach the stage-replicated sink in the same tick through
        `stage_last`; the wrap copy stage 0 receives in slot R - 1 has its
        valid column zeroed (it is never a round input).

        Topology batches apply identically on every stage; the query
        plane runs identically per stage (its wire lane rides round 0's
        exchange on every stage, so QueryState stays stage-replicated).
        Per-round stats are reduced over the data axis only; the idle
        counters (rounds that saw an empty inbox) over both axes. With
        training on, every stage gathers all rounds' layer caches over the
        stage axis and runs the same full-L backward, so TrainState stays
        stage-replicated.
        Returns (topo, states, sink, sink_seen, queries, ring, per-round
        stats, idle [R], answers or None, QueryStats or None, occupancy
        row or None)."""
        cfg, router = self.cfg, self.router
        outbox_cap = cfg.capacities().outbox
        S, R = self.n_stages, self._n_rounds
        s = router.stage_index()
        part0 = router.part0()
        topo = st.apply_vertex_batch(topo, vb, part0)
        topo = st.apply_repl_batch(topo, rb, part0)
        topo = st.apply_edge_batch(topo, eb, part0)
        batch_work = (fb.valid.any() | eb.valid.any() | rb.valid.any()
                      if cfg.query_cap else None)
        C_buf = ring.shape[1]
        vcol = field_col(fb, "valid")
        occ0 = (ring[..., vcol] > 0.5).sum()
        queries, wire, adm_drop, n_adm = query_admit_stage(
            queries, qb, states, sink, sink_seen, router, batch_work,
            extra_work=occ0)
        staged = self._staged_params()
        wire_d = None
        new_states, stats_all, new_slots, idle = [], [], [], []
        out_rows = None
        for r in range(R):
            if s == 0:
                rows_in = pad_lane(pack_lane(fb), C_buf) if r == 0 \
                    else ring[r - 1]
            else:
                rows_in = ring[r]
            inbox = unpack_lane(rows_in, fb)
            idle.append(~inbox.valid.any())
            extra = ((wire, (queries.wire_defer, queries.wire_defer_ok))
                     if r == 0 and wire is not None else None)
            layer = StagedActLayer(self.layers[r * S + s], staged[f"r{r}"])
            ls, outbox, stats, extra_out = layer_tick_body(
                layer, topo, states[r], inbox, eb, rb, now, wconf,
                outbox_cap, router, self.delivery, extra_lane=extra,
                delta_eps=cfg.delta_eps, telemetry=cfg.telemetry)
            if extra_out is not None:
                wire_d, (wdb, wdo) = extra_out
                queries = replace(queries, wire_defer=wdb, wire_defer_ok=wdo)
            new_states.append(ls)
            stats_all.append(stats)
            out_rows = pad_lane(pack_lane(outbox), C_buf)
            # post the hop now, right after the round's compute
            new_slots.append(router.stage_shift(out_rows))
        # same-tick sink feed: the LAST stage's final-round outbox, on
        # every stage's replica of the sink
        final_fb = unpack_lane(router.stage_last(out_rows), fb)
        sink, sink_seen = _sink_update_body(sink, sink_seen, final_fb, part0)
        if s == 0:
            # the wrap copy of the final layer's outbox (materialized above)
            new_slots[R - 1] = new_slots[R - 1].clone()
            new_slots[R - 1][:, vcol] = 0.0
        new_ring = torch.stack(new_slots)
        occ1 = (new_ring[..., vcol] > 0.5).sum()
        queries, answers, qstats = query_answer_stage(
            queries, wire_d, qb, adm_drop, n_adm, new_states, sink,
            sink_seen, now, stats_all, router, extra_work=occ1)
        if self.train_cfg is not None:
            ts = self.train_state
            L = R * S
            moved = router.psum_stage(sum(moved_msgs(x) for x in stats_all))
            caches = [None] * L
            for r in range(R):
                ls = new_states[r]
                d, da = ls.feat.shape[-1], ls.agg.shape[-1]
                g = router.stage_gather(torch.cat(
                    [ls.feat, ls.agg, ls.agg_cnt[..., None]], dim=-1))
                for si in range(S):
                    caches[r * S + si] = (g[si, ..., :d],
                                          g[si, ..., d:d + da],
                                          g[si, ..., d + da])
            self.train_state = train_stage(
                self.train_cfg, self._head,
                [(StagedActLayer(self.layers[l]),
                  {"p": ts.params[f"l{l}"], "act": self._act_leaves[l]},
                  True)
                 for l in range(L)], caches, topo, sink, sink_seen, ts, lb,
                final_fb, now, moved, router, part0, self.delivery)
            self._sync_params_from_train()
        idle_v = router.psum_vote(torch.stack(idle).to(torch.int64))
        occ = (_occ_row(stats_all, qstats, self.train_state, router,
                        stage=True) if cfg.telemetry else None)
        return (topo, new_states, sink, sink_seen, queries, new_ring,
                stats_all, idle_v, answers, qstats, occ)

    def _run_program(self, fb, eb, rb, vb, qb, lb, now, wconf):
        """Run one tick's device program (the 1-D one, or the pipelined
        one on a 2-D mesh) on the pipeline's state. Returns (stats, one a
        layer or a round; answers; QueryStats; occupancy row; the idle
        counters [R] on a 2-D mesh, else None). The tick runs inside the
        profiler range `d3.tick` while the profiler is on."""
        with spans.region("tick"):
            if self.n_stages > 1:
                (self.topo, self.states, self.sink, self.sink_seen,
                 self.queries, self.stage_ring, stats_all, idle, answers,
                 qstats, occ) = self._tick_program_2d(
                    self.topo, self.states, self.sink, self.sink_seen,
                    self.queries, self.stage_ring, fb, eb, rb, vb, qb, lb,
                    now, wconf)
                return stats_all, answers, qstats, occ, idle
            (self.topo, self.states, self.sink, self.sink_seen, self.queries,
             stats_all, answers, qstats, occ) = self._tick_program(
                self.topo, self.states, self.sink, self.sink_seen,
                self.queries, fb, eb, rb, vb, qb, lb, now, wconf)
            return stats_all, answers, qstats, occ, None

    def _sync_params_from_train(self) -> None:
        """Mirror the live trained parameters into the model's modules, so
        the next tick's forward (and every host reader) sees the online
        plane's latest step: device copies, no host sync."""
        ts = self.train_state
        for li, layer in enumerate(self.layers):
            layer.load_param_tree(ts.params[f"l{li}"])
        load_linear_tree(self._head, ts.head_params)

    @property
    def params(self) -> dict:
        """{f"l{i}": parameter tree} of the layers (the JAX package's
        layout; detached views of the modules' weights)."""
        return {f"l{i}": layer.param_tree()
                for i, layer in enumerate(self.layers)}

    def train_stats(self) -> dict:
        """Training-plane progress in ONE host read: the last fired step's
        global loss and gradient norm, and the fired-step count."""
        ts = self.train_state
        if ts is None:
            raise ValueError("training plane disabled (train_cap=0 / no "
                             "TrainConfig)")
        loss, gn, steps = torch.stack([
            ts.loss.double(), ts.grad_norm.double(),
            ts.steps.double()]).cpu().tolist()
        return {"loss": loss, "grad_norm": gn, "steps": int(steps)}

    def tick(self, edges: Optional[np.ndarray] = None,
             feats: Optional[list] = None, window=None,
             queries: Optional[list] = None,
             labels: Optional[list] = None):
        """One micro-tick through the full pipeline (reference driver).

        queries: optional [(qid, kind, vid, [vid2,] consistent), ...]
        point-query admissions for this tick (needs cfg.query_cap > 0);
        answered rows accumulate in `drain_answers()`.
        labels: optional [(vid, gold_class), ...] training-plane label
        admissions (needs cfg.train_cap > 0 and a TrainConfig); progress
        is read with `train_stats()`.
        Returns the per-layer TickStats, read back to the host (with the
        tick's answers and query counters, in one read)."""
        self._need_active()
        wconf = window or self.cfg.window
        # one launch record, T = 1: the uploads happen in packing, so the
        # record's upload phase stays 0
        with spans.launch(self.span_id, self.now, 1) as rec:
            eb, rb, vb, fb, qb, lb = self._build_batches(
                edges, feats, self.device, queries=queries, labels=labels)
            rec.phase("dispatch")
            now = torch.tensor(self.now, dtype=torch.int64,
                               device=self.device)
            tick0 = self.now
            stats_all, answers, qstats, occ, idle = self._run_program(
                fb, eb, rb, vb, qb, lb, now, wconf)
            self.now += 1
            on = answers is not None
            qx = [getattr(qstats, f) for f in QSTAT_FIELDS] if on else []
            staged = [idle.sum()] if idle is not None else []
            host_stats, host_x, host_ans, host_occ = self._stats_to_host(
                stats_all, *staged, *qx, answers=[answers] if on else None,
                occ=[occ] if occ is not None else None)
            if idle is not None:
                self.metrics.stage_idle += host_x.pop(0)
            host_q = host_x
            self._harvest_answers(host_ans)
            self._accumulate(host_stats, qstats=host_q, occ_rows=host_occ)
            self._trace_ticks(host_occ, tick0, rec.closed_s(),
                              rec.host_s(), [_ingest_counts(
                                  edges, feats, queries, labels)],
                              host_stats)
        self._account(rec)
        return host_stats

    def _harvest_answers(self, ans) -> None:
        """Append the answered rows (valid mask) of host AnswerBatch rows
        to the answer log; None when the query plane is off."""
        if ans is None:
            return
        mask = ans.valid.numpy()
        if not mask.any():
            return
        self._answer_log.append({
            "qid": ans.qid.numpy()[mask], "kind": ans.kind.numpy()[mask],
            "ok": ans.ok.numpy()[mask], "tick": ans.tick.numpy()[mask],
            "issue": ans.issue.numpy()[mask], "vec": ans.vec.numpy()[mask],
            "score": ans.score.numpy()[mask]})

    def drain_answers(self) -> dict:
        """Pop every answered query collected so far as one dict of
        concatenated numpy columns (qid, kind, ok, tick, issue, vec,
        score) — empty arrays when nothing answered."""
        log, self._answer_log = self._answer_log, []
        if not log:
            return {"qid": np.zeros(0, np.int64),
                    "kind": np.zeros(0, np.int64),
                    "ok": np.zeros(0, bool),
                    "tick": np.zeros(0, np.int64),
                    "issue": np.zeros(0, np.int64),
                    "vec": np.zeros((0, self.d_out), np.float32),
                    "score": np.zeros(0, np.float32)}
        return {k: np.concatenate([chunk[k] for chunk in log])
                for k in log[0]}

    def _account(self, rec) -> None:
        """Fold a closed launch record's clocks into StreamMetrics."""
        self.metrics.host_seconds += rec.host_s()
        self.metrics.wall_seconds += rec.wall_s

    def _accumulate(self, stats_all, ticks: int = 1, qstats=None,
                    occ_rows=None):
        """Fold per-layer host stats (one tick, or a super-tick's sums)
        and the query counters (host ints in QSTAT_FIELDS order, or an
        empty list) into StreamMetrics. occ_rows (telemetry): [ticks, C]
        occupancy rows; the peak gauges fold with max (their sum over a
        super-tick means nothing)."""
        m = self.metrics
        m.ticks += ticks
        m.wire_bytes += ticks * self._wire_bytes_per_tick
        for s in stats_all:
            m.reduce_msgs += int(s.reduce_msgs)
            m.broadcast_msgs += int(s.broadcast_msgs)
            m.cross_part_msgs += int(s.cross_part_msgs)
            m.dropped += int(s.dropped)
            m.suppressed += int(s.n_suppressed)
            m.wire_rows += int(s.wire_rows)
            m.route_deferred += int(s.route_deferred)
            m.route_dropped += int(s.route_dropped)
            m.occ_defer_ticks += int(s.occ_bc_defer) + int(s.occ_rmi_defer)
            m.busy_logical += s.busy.numpy().astype(np.int64)
        m.emitted_total += int(stats_all[-1].emitted)
        if occ_rows is not None and occ_rows.size:
            m.route_peak = max(m.route_peak,
                               int(occ_rows[:, _OCC["route_peak"]].max()))
            m.outbox_peak = max(m.outbox_peak, int(
                occ_rows[:, _OCC["outbox_demand"]].max()))
            m.outbox_part_peak = max(m.outbox_part_peak, int(
                occ_rows[:, _OCC["outbox_part_peak"]].max()))
        if qstats:
            q = dict(zip(QSTAT_FIELDS, qstats))
            m.queries_admitted += q["admitted"]
            m.queries_answered += q["answered"]
            m.queries_dropped += q["dropped"]
            m.query_hold_ticks += q["held_ticks"]

    def _trace_ticks(self, occ_rows, tick0, wall_s, host_s, counts,
                     stats_all, amortized: int = 0):
        """Telemetry plane, host side: one trace row per tick and the
        straggler feed; a no-op with telemetry off. occ_rows: [ticks, C]
        host occupancy rows (from the drivers' one read); counts: per-tick
        (edges, feats, queries, labels) ingest counts; the wall time is
        spread evenly over the ticks (amortized=1 on the super-tick
        driver, whose staging time is not split per tick)."""
        if self.trace is None:
            return
        ticks = len(counts)
        per = wall_s / ticks
        for i, (e, f, q, lab) in enumerate(counts):
            self.trace.append(
                {"tick": tick0 + i, "ticks": 1, "wall_s": per,
                 "host_s": host_s, "amortized": amortized,
                 "wire_bytes": self._wire_bytes_per_tick,
                 "edges_in": e, "feats_in": f, "queries_in": q,
                 "labels_in": lab}, occ_rows[i])
        # straggler feed: the per-part busy proxies (gathered over the
        # ranks by the same read) folded to their shard
        busy = sum(s.busy.numpy().astype(np.int64) for s in stats_all)
        self.straggler.observe_tick(
            per, busy.reshape(self.router.n_devices, -1).sum(axis=1))

    def chunk_stream(self, edges, feats, tick_edges: int,
                     feat_with_first_edge: bool = True, seen=None):
        """Cut an edge stream into micro-tick chunks + aligned feature
        events (each vertex's feature fires in the tick of its first edge).
        Shared by both drivers so their tick boundaries always agree."""
        seen = set() if seen is None else seen
        e_chunks, f_chunks = [], []
        for lo in range(0, len(edges), tick_edges):
            chunk = edges[lo: lo + tick_edges]
            f_events = []
            if feat_with_first_edge:
                for u in chunk.reshape(-1):
                    u = int(u)
                    if u not in seen and u in feats:
                        seen.add(u)
                        f_events.append((u, feats[u]))
            e_chunks.append(chunk)
            f_chunks.append(f_events)
        return e_chunks, f_chunks

    def run_stream(self, edges: np.ndarray, feats: dict,
                   tick_edges: int = 256, feat_with_first_edge: bool = True):
        """Stream an edge list (+ node features {vid: vector}) through the
        pipeline with the per-tick driver."""
        e_chunks, f_chunks = self.chunk_stream(edges, feats, tick_edges,
                                               feat_with_first_edge)
        for chunk, f_events in zip(e_chunks, f_chunks):
            self.tick(chunk, f_events)
        return self

    def flush(self, max_ticks: int = 64, drain: bool = True) -> int:
        """Run empty ticks until the TerminationCoordinator fires.
        drain=True forces pending windows due immediately (streaming
        eviction); drain=False waits for the scheduled timers."""
        term = TerminationCoordinator()
        override = win.WindowConfig(kind=win.STREAMING) if drain else None
        for i in range(max_ticks):
            stats = self.tick(window=override)
            # rows in flight between stages are pending work the layer
            # states do not show (none on a 1-D mesh)
            if term.observe(self.states, stats, self.router,
                            queries=self.queries,
                            extra_work=(self._ring_occupancy()
                                        if self.n_stages > 1 else None)):
                return i + 1
        raise RuntimeError("pipeline failed to terminate "
                           f"within {max_ticks} flush ticks")

    # ------------------------------------------------------ super-tick path
    def run_super_tick(self, edge_chunks=None, feat_chunks=None,
                       T: Optional[int] = None, window=None,
                       quiet0: int = 0, query_chunks=None,
                       label_chunks=None):
        """Advance T micro-ticks with ONE host sync.

        edge_chunks / feat_chunks / query_chunks / label_chunks: per-tick
        edge arrays, [(vid, vec)] lists, query-request lists and
        [(vid, gold_class)] label lists (the `tick()` formats, admitted at
        their staged tick; None entries allowed); shorter lists are padded
        with empty ticks up to T. quiet0 seeds the consecutive-quiet-tick
        counter. Training progress stays on the device (`train_stats()`).
        Returns (per-layer TickStats summed over the T ticks, quiet_ticks).
        The same read carries the T ticks' answers and the summed query
        counters.
        """
        self._need_active()
        wconf = window or self.cfg.window
        edge_chunks = list(edge_chunks) if edge_chunks is not None else []
        feat_chunks = list(feat_chunks) if feat_chunks is not None else []
        query_chunks = list(query_chunks) if query_chunks is not None else []
        label_chunks = list(label_chunks) if label_chunks is not None else []
        n = max(len(edge_chunks), len(feat_chunks), len(query_chunks),
                len(label_chunks), 1)
        T = int(T) if T is not None else n
        if T < n:
            raise ValueError(f"T={T} smaller than the {n} staged ticks")
        edge_chunks += [None] * (T - len(edge_chunks))
        feat_chunks += [None] * (T - len(feat_chunks))
        query_chunks += [None] * (T - len(query_chunks))
        label_chunks += [None] * (T - len(label_chunks))
        with spans.launch(self.span_id, self.now, T) as rec:
            out = self._super_tick(rec, edge_chunks, feat_chunks,
                                   query_chunks, label_chunks, T, wconf,
                                   quiet0)
        self._account(rec)
        return out

    def _super_tick(self, rec, edge_chunks, feat_chunks, query_chunks,
                    label_chunks, T: int, wconf, quiet0: int):
        """run_super_tick's launch, its phases marked on `rec`."""
        # issue ticks: the tick the device will admit each chunk in
        staged = [self._build_batches(e, f, queries=q, issue_tick=self.now + i,
                                      labels=lab)
                  for i, (e, f, q, lab) in enumerate(
                      zip(edge_chunks, feat_chunks, query_chunks,
                          label_chunks))]
        # one host-to-device copy per field for all T ticks (the query and
        # label batches only when their plane is on)
        rec.phase("upload")
        eb, rb, vb, fb = (ev.stack_batches([s[i] for s in staged],
                                           self.device) for i in range(4))
        qb = (ev.stack_batches([s[4] for s in staged], self.device)
              if self.cfg.query_cap else None)
        lb = (ev.stack_batches([s[5] for s in staged], self.device)
              if self.cfg.train_cap else None)
        rec.phase("dispatch")

        dev = self.device
        # device-filled scalars: no host-to-device copy, no sync
        now = torch.full((), self.now, dtype=torch.int64, device=dev)
        quiet = torch.full((), quiet0, dtype=torch.int64, device=dev)
        ssum = [zero_stats(self.states[0].feat.shape[0], dev)
                for _ in self.states]
        qsum = zero_query_stats(dev)
        isum = torch.zeros((), dtype=torch.int64, device=dev)
        answers, occ = [], []
        tick0 = self.now
        for t in range(T):
            stats_t, ans_t, qstats_t, occ_t, idle_t = self._run_program(
                ev.batch_at(fb, t), ev.batch_at(eb, t), ev.batch_at(rb, t),
                ev.batch_at(vb, t),
                ev.batch_at(qb, t) if qb is not None else self._empty_queries,
                ev.batch_at(lb, t) if lb is not None else self._empty_labels,
                now, wconf)
            # rows still in flight between stages are pending work
            quiet = quiet_update(quiet, self.states, stats_t, self.router,
                                 queries=self.queries,
                                 extra_work=(self._ring_occupancy()
                                             if idle_t is not None else None))
            ssum = [add_stats(a, b) for a, b in zip(ssum, stats_t)]
            if idle_t is not None:
                isum = isum + idle_t.sum()
            if ans_t is not None:
                answers.append(ans_t)
                qsum = add_query_stats(qsum, qstats_t)
            if occ_t is not None:
                occ.append(occ_t)
            now = now + 1
        self.now += T
        # the one host sync of the super-tick: summed stats + quiet counter
        # (+ the bubble count on a 2-D mesh, + the summed query counters
        # and the T ticks' answers, + the T ticks' occupancy rows)
        staged_x = [isum] if self.n_stages > 1 else []
        qx = [getattr(qsum, f) for f in QSTAT_FIELDS] if answers else []
        (host_stats, (quiet_ticks, *host_q), host_ans,
         host_occ) = self._stats_to_host(ssum, quiet, *staged_x, *qx,
                                         answers=answers or None,
                                         occ=occ or None)
        if staged_x:
            self.metrics.stage_idle += host_q.pop(0)
        self._harvest_answers(host_ans)
        self._accumulate(host_stats, ticks=T, qstats=host_q,
                         occ_rows=host_occ)
        self._trace_ticks(host_occ, tick0, rec.closed_s(), 0.0, [
            _ingest_counts(*c) for c in zip(edge_chunks, feat_chunks,
                                            query_chunks, label_chunks)],
            host_stats, amortized=1)
        return host_stats, quiet_ticks

    def run_stream_super(self, edges: np.ndarray, feats: dict,
                         tick_edges: int = 256, super_ticks: int = 16,
                         feat_with_first_edge: bool = True):
        """`run_stream`, T = super_ticks micro-ticks per host sync (the
        tail group is padded with empty ticks)."""
        e_chunks, f_chunks = self.chunk_stream(edges, feats, tick_edges,
                                               feat_with_first_edge)
        for lo in range(0, len(e_chunks), super_ticks):
            self.run_super_tick(e_chunks[lo: lo + super_ticks],
                                f_chunks[lo: lo + super_ticks],
                                T=super_ticks)
        return self

    def flush_super(self, max_ticks: int = 64, T: int = 8,
                    drain: bool = True) -> int:
        """`flush`, super-tick style: empty ticks until device quiescence;
        the quiet counter is read once per super-tick and re-seeded."""
        term = TerminationCoordinator()
        override = win.WindowConfig(kind=win.STREAMING) if drain else None
        ran = 0
        while ran < max_ticks:
            step = min(T, max_ticks - ran)
            _, quiet = self.run_super_tick(T=step, window=override,
                                           quiet0=term.seed_quiet())
            ran += step
            if term.observe_flag(quiet):
                return ran
        raise RuntimeError("pipeline failed to terminate "
                           f"within {max_ticks} flush ticks")

    # ------------------------------------------------------------- queries
    def read_nodes(self, vids) -> dict:
        """Partial gather of sink embeddings for a vid set: only the
        requested rows are gathered on the device and copied back; vids
        never seen, or whose master never materialized, are absent. On a
        mesh every rank calls it with the same vids: each reads the rows
        of its parts and one all_gather over its stage row gives every
        rank all of them."""
        self._need_active()
        vids = np.asarray(list(vids) if not isinstance(vids, np.ndarray)
                          else vids, np.int64).reshape(-1)
        t = self.part.t
        vids = vids[(vids >= 0) & (vids < t.max_nodes)]
        vids = vids[t.master[vids] >= 0]
        if vids.size == 0:
            return {}
        p = torch.as_tensor(t.master[vids].astype(np.int64)).to(self.device)
        s = torch.as_tensor(t.master_slot[vids].astype(np.int64)).to(
            self.device)
        if self.mesh is None:
            vecs = self.sink[p, s].cpu().numpy()
            seen = self.sink_seen[p, s].cpu().numpy()
        else:
            p_loc = self.sink.shape[0]
            lp = p - self.router.part0()
            own = (lp >= 0) & (lp < p_loc)
            lp = torch.where(own, lp, 0)
            rows = torch.cat([self.sink[lp, s],
                              (self.sink_seen[lp, s] & own)[:, None]], 1)
            got = self.router.data.all_gather(rows)[
                torch.div(p, p_loc, rounding_mode="floor"),
                torch.arange(len(vids), device=self.device)].cpu()
            vecs, seen = got[:, :-1].numpy(), got[:, -1].numpy() > 0.5
        return {int(v): vecs[i] for i, v in enumerate(vids) if seen[i]}

    def sink_global(self) -> torch.Tensor:
        """The whole [n_parts, node_cap, d] sink in the reference's global
        layout: on a mesh, one all_gather over the rank's stage row (every
        stage holds the same sink); collective."""
        self._need_active()
        if self.mesh is None:
            return self.sink
        return self.router.data.all_gather(self.sink).reshape(
            (-1,) + tuple(self.sink.shape[1:]))

    def embeddings(self) -> dict:
        """Materialized final-layer embeddings {vid: vector} (masters);
        collective on a mesh."""
        return self.read_nodes(np.flatnonzero(self.part.t.master >= 0))

    def physical_busy_per_layer(self):
        """Per-layer physical busy vectors under the explosion factor
        (core/explosion.py: layer i runs p * lambda^i sub-operators)."""
        cfg = self.cfg
        pars = layer_parallelisms(cfg.base_parallelism, cfg.explosion,
                                  len(self.layers), cfg.n_parts)
        return [physical_busy(self.metrics.busy_logical, p, cfg.n_parts)
                for p in pars]
