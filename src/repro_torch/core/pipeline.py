"""The D3-GNN dataflow pipeline driver (paper Fig. 1), one device.

Counterpart of the 1-D local subset of `repro/core/pipeline.py`:

Dataset -> Partitioner -> Splitter -> GraphStorage_1 .. GraphStorage_L -> sink

The host cuts the stream into micro-ticks, assigns parts/slots
(partitioner.py) and builds padded batches; the device runs one tick per
GraphStorage operator per tick, layer l's outbox being layer l+1's inbox,
and the final outbox materializes into the embedding sink.

Two drivers share ONE device program (`_tick_program`: topology apply + L
layer ticks + sink update):

  * `tick()` — the per-tick REFERENCE path: build the tick's batches, run
    the program, read the tick's stats back (one host sync per tick).
  * `run_super_tick()` — the SUPER-TICK path: the host stages T micro-ticks
    of batches (stacked, one host-to-device copy per field), the device
    runs the T tick programs back to back with the stats sums and the
    quiescence counter kept ON THE DEVICE, and the host reads them once
    per super-tick (exactly one device-to-host sync). Capturing the T
    ticks as one CUDA graph is a later step (ROADMAP).

Planes this slice does not port raise NotImplementedError naming the
ROADMAP item that will port them: mesh= / n_stages > 1, query_cap > 0,
train_cap > 0 / train=, telemetry=True, delta_eps > 0, route_cap.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core import state as st
from repro_torch.core import windowing as win
from repro_torch.core.delivery import BACKENDS as DELIVERY_BACKENDS
from repro_torch.core.delivery import make_delivery
from repro_torch.core.partitioner import StreamingPartitioner
from repro_torch.core.termination import TerminationCoordinator, quiet_update
from repro_torch.core.tick import (SCALAR_FIELDS, TickStats, add_stats,
                                   layer_tick_body, zero_stats)
from repro_torch.device import resolve_device
from repro_torch.dist.router import LocalRouter


@dataclass(frozen=True)
class Capacities:
    """Resolved per-tick emission budgets of a config."""
    outbox: int            # per-tick emission budget (rows, all parts)
    outbox_per_part: int   # emission slots per part (outbox // n_parts)


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
    query_cap: int = 0                # query plane (not ported yet)
    train_cap: int = 0                # training plane (not ported yet)
    route_cap: Optional[int] = None   # capped exchange (not ported yet)
    window: win.WindowConfig = field(default_factory=win.WindowConfig)
    delta_eps: float = 0.0            # delta gating (not ported yet)
    delivery_backend: str = "kernel"  # "kernel" (CUDA kernels) | "scatter"
    n_stages: int = 1                 # stage pipeline (not ported yet)
    telemetry: bool = False           # telemetry plane (not ported yet)
    partitioner: str = "hdrf"
    max_nodes: int = 100_000          # global id space for the host tables
    seed: int = 0

    def capacities(self) -> Capacities:
        outbox = self.feat_cap if self.outbox_cap is None else self.outbox_cap
        return Capacities(outbox=outbox,
                          outbox_per_part=max(1, outbox // self.n_parts))

    def validate(self) -> None:
        unported = (
            (self.n_stages != 1, "n_stages > 1 (pipeline stages)", 13),
            (self.route_cap is not None, "route_cap (capped exchange)", 13),
            (self.delta_eps != 0.0, "delta_eps > 0 (delta gating)", 8),
            (self.query_cap != 0, "query_cap > 0 (query plane)", 9),
            (self.train_cap != 0, "train_cap > 0 (training plane)", 10),
            (self.telemetry, "telemetry=True (telemetry plane)", 11))
        for hit, what, item in unported:
            if hit:
                raise NotImplementedError(
                    f"PipelineConfig: {what} is not ported to repro_torch "
                    f"yet (ROADMAP Queue 1 item {item})")
        caps = {"n_parts": self.n_parts, "node_cap": self.node_cap,
                "edge_cap": self.edge_cap, "repl_cap": self.repl_cap,
                "feat_cap": self.feat_cap,
                "outbox_cap (capacities().outbox)": self.capacities().outbox,
                "edge_tick_cap": self.edge_tick_cap}
        for name, v in caps.items():
            if v <= 0:
                raise ValueError(f"PipelineConfig.{name}={v} must be > 0")
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


@dataclass
class StreamMetrics:
    ticks: int = 0
    emitted_total: int = 0
    reduce_msgs: int = 0
    broadcast_msgs: int = 0
    cross_part_msgs: int = 0
    dropped: int = 0
    host_seconds: float = 0.0          # host-side staging time
    wall_seconds: float = 0.0
    busy_logical: Optional[np.ndarray] = None


def _sink_update_body(sink, seen, fb: ev.FeatBatch, part0=0):
    P, N, d = sink.shape
    idx, _ = st.local_index(fb.part, fb.slot, part0, P, N, fb.valid)
    sink = st.scatter_set(sink.reshape(P * N, d), idx, fb.feat)
    seen = seen.reshape(P * N) | st.mark_rows(P * N, idx, idx.device)
    return sink.reshape(P, N, d), seen.reshape(P, N)


def _stats_to_host(stats_all, *extra):
    """Per-layer TickStats (+ extra 0-d int64 tensors) to the host in ONE
    device-to-host copy. Returns (list of host TickStats, extra ints)."""
    L = len(stats_all)
    P = stats_all[0].busy.shape[0]
    parts = [torch.stack([getattr(s, f) for f in SCALAR_FIELDS])
             for s in stats_all] + [s.busy for s in stats_all]
    if extra:
        parts.append(torch.stack(list(extra)))
    flat = torch.cat(parts).cpu()
    F = len(SCALAR_FIELDS)
    out = []
    for li in range(L):
        sc = flat[li * F:(li + 1) * F]
        busy = flat[L * F + li * P: L * F + (li + 1) * P]
        out.append(TickStats(**dict(zip(SCALAR_FIELDS, sc)), busy=busy))
    return out, [int(v) for v in flat[L * (F + P):]]


class D3Pipeline:
    """L chained GraphStorage operators + the host driver."""

    def __init__(self, model, cfg: PipelineConfig, mesh=None, train=None,
                 device=None):
        """model: graph/sage.GraphSAGE (an nn.Module whose `layers` have
        message/update); it is moved to `device`. device: where the
        pipeline runs — CUDA unless given; raises without CUDA."""
        if mesh is not None:
            raise NotImplementedError(
                "D3Pipeline(mesh=...) is not ported to repro_torch yet "
                "(ROADMAP Queue 1 item 13)")
        if train is not None:
            raise NotImplementedError(
                "D3Pipeline(train=...) is not ported to repro_torch yet "
                "(ROADMAP Queue 1 item 10)")
        cfg.validate()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.layers = list(model.layers)
        self.router = LocalRouter(cfg.n_parts)
        self.delivery = make_delivery(cfg.delivery_backend)
        self.part = StreamingPartitioner(
            cfg.n_parts, cfg.max_nodes, method=cfg.partitioner,
            seed=cfg.seed, node_cap=cfg.node_cap, edge_cap=cfg.edge_cap,
            repl_cap=cfg.repl_cap)
        dev = self.device
        self.topo = st.init_topo(cfg.n_parts, cfg.edge_cap, cfg.repl_cap,
                                 cfg.node_cap, dev)
        dims = [l.in_dim for l in self.layers] + [self.layers[-1].out_dim]
        self.states = [st.init_layer(cfg.n_parts, cfg.node_cap, dims[i],
                                     dims[i], dev)
                       for i in range(len(self.layers))]
        self.d_in, self.d_out = dims[0], dims[-1]
        self.sink = torch.zeros((cfg.n_parts, cfg.node_cap, self.d_out),
                                dtype=torch.float32, device=dev)
        self.sink_seen = torch.zeros((cfg.n_parts, cfg.node_cap),
                                     dtype=torch.bool, device=dev)
        self.now = 0
        self.metrics = StreamMetrics(
            busy_logical=np.zeros(cfg.n_parts, np.int64))
        self._empty_edge_rows = {
            k: np.zeros(0, np.int64) for k in
            ("part", "edge_slot", "src_slot", "dst_slot",
             "dst_master_part", "dst_master_slot")}

    # ------------------------------------------------------------ host side
    def _build_batches(self, edges: Optional[np.ndarray],
                       feats: Optional[list], device=None):
        """One tick's padded (edge, repl, vertex, feat) batches; device=None
        keeps numpy leaves for the super-tick staging path."""
        cfg = self.cfg
        if edges is not None and len(edges):
            e_rows, r1, v1 = self.part.ingest_edges(edges)
        else:
            e_rows, r1, v1 = self._empty_edge_rows, None, None
        # feature events may create vertices (cold features)
        f_parts, f_slots, f_vecs = [], [], []
        if feats:
            coalesced = {}
            for vid, vec in feats:        # host-side coalescing (last wins)
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
        eb = ev.edge_batch_from_numpy(e_rows, cfg.edge_tick_cap, device)
        rb = ev.repl_batch_from_numpy(r_rows, max(2 * cfg.edge_tick_cap, 1),
                                      device)
        vb = ev.vertex_batch_from_numpy(
            v_rows, max(2 * cfg.edge_tick_cap + cfg.feat_cap, 1), device)
        fb = ev.feat_batch_from_numpy(
            np.asarray(f_parts, np.int64), np.asarray(f_slots, np.int64),
            np.asarray(f_vecs, np.float32).reshape(len(f_parts), -1)
            if f_parts else np.zeros((0, self.d_in), np.float32),
            cfg.feat_cap, self.d_in, device)
        return eb, rb, vb, fb

    # ---------------------------------------------------------- device side
    @torch.no_grad()
    def _tick_program(self, topo, states, sink, sink_seen, fb, eb, rb, vb,
                      now, wconf):
        """ONE micro-tick on the device: topology application, L layer
        ticks, the sink update. Never reads a value back to the host."""
        outbox_cap = self.cfg.capacities().outbox
        topo = st.apply_vertex_batch(topo, vb)
        topo = st.apply_repl_batch(topo, rb)
        topo = st.apply_edge_batch(topo, eb)
        inbox = fb
        new_states, stats_all = [], []
        for li, layer in enumerate(self.layers):
            # topology reaches every layer; features only layer 0
            ls, inbox, stats = layer_tick_body(
                layer, topo, states[li], inbox, eb, rb, now, wconf,
                outbox_cap, self.router, self.delivery)
            new_states.append(ls)
            stats_all.append(stats)
        # sink: final-layer emissions materialize the embedding table
        sink, sink_seen = _sink_update_body(sink, sink_seen, inbox)
        return topo, new_states, sink, sink_seen, stats_all

    def tick(self, edges: Optional[np.ndarray] = None,
             feats: Optional[list] = None, window=None):
        """One micro-tick through the full pipeline (reference driver).
        Returns the per-layer TickStats, read back to the host."""
        wconf = window or self.cfg.window
        t0 = time.perf_counter()
        eb, rb, vb, fb = self._build_batches(edges, feats, self.device)
        host_s = time.perf_counter() - t0
        now = torch.tensor(self.now, dtype=torch.int64, device=self.device)
        (self.topo, self.states, self.sink, self.sink_seen,
         stats_all) = self._tick_program(self.topo, self.states, self.sink,
                                         self.sink_seen, fb, eb, rb, vb,
                                         now, wconf)
        self.now += 1
        host_stats, _ = _stats_to_host(stats_all)
        self.metrics.host_seconds += host_s
        self._accumulate(host_stats, time.perf_counter() - t0)
        return host_stats

    def _accumulate(self, stats_all, dt, ticks: int = 1):
        """Fold per-layer host stats (one tick, or a super-tick's sums)
        into StreamMetrics."""
        m = self.metrics
        m.ticks += ticks
        m.wall_seconds += dt
        for s in stats_all:
            m.reduce_msgs += int(s.reduce_msgs)
            m.broadcast_msgs += int(s.broadcast_msgs)
            m.cross_part_msgs += int(s.cross_part_msgs)
            m.dropped += int(s.dropped)
            m.busy_logical += s.busy.numpy().astype(np.int64)
        m.emitted_total += int(stats_all[-1].emitted)

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
            if term.observe(self.states, stats):
                return i + 1
        raise RuntimeError("pipeline failed to terminate "
                           f"within {max_ticks} flush ticks")

    # ------------------------------------------------------ super-tick path
    def run_super_tick(self, edge_chunks=None, feat_chunks=None,
                       T: Optional[int] = None, window=None,
                       quiet0: int = 0):
        """Advance T micro-ticks with ONE host sync.

        edge_chunks / feat_chunks: per-tick edge arrays and [(vid, vec)]
        lists (None entries allowed); shorter lists are padded with empty
        ticks up to T. quiet0 seeds the consecutive-quiet-tick counter.
        Returns (per-layer TickStats summed over the T ticks, quiet_ticks).
        """
        wconf = window or self.cfg.window
        t0 = time.perf_counter()
        edge_chunks = list(edge_chunks) if edge_chunks is not None else []
        feat_chunks = list(feat_chunks) if feat_chunks is not None else []
        n = max(len(edge_chunks), len(feat_chunks), 1)
        T = int(T) if T is not None else n
        if T < n:
            raise ValueError(f"T={T} smaller than the {n} staged ticks")
        edge_chunks += [None] * (T - len(edge_chunks))
        feat_chunks += [None] * (T - len(feat_chunks))
        staged = [self._build_batches(e, f) for e, f in
                  zip(edge_chunks, feat_chunks)]
        # one host-to-device copy per field for all T ticks
        eb, rb, vb, fb = (ev.stack_batches([s[i] for s in staged],
                                           self.device) for i in range(4))
        self.metrics.host_seconds += time.perf_counter() - t0

        dev = self.device
        # device-filled scalars: no host-to-device copy, no sync
        now = torch.full((), self.now, dtype=torch.int64, device=dev)
        quiet = torch.full((), quiet0, dtype=torch.int64, device=dev)
        ssum = [zero_stats(self.cfg.n_parts, dev) for _ in self.layers]
        for t in range(T):
            (self.topo, self.states, self.sink, self.sink_seen,
             stats_t) = self._tick_program(
                self.topo, self.states, self.sink, self.sink_seen,
                ev.batch_at(fb, t), ev.batch_at(eb, t), ev.batch_at(rb, t),
                ev.batch_at(vb, t), now, wconf)
            quiet = quiet_update(quiet, self.states, stats_t)
            ssum = [add_stats(a, b) for a, b in zip(ssum, stats_t)]
            now = now + 1
        self.now += T
        # the one host sync of the super-tick: summed stats + quiet counter
        host_stats, (quiet_ticks,) = _stats_to_host(ssum, quiet)
        self._accumulate(host_stats, time.perf_counter() - t0, ticks=T)
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
        never seen, or whose master never materialized, are absent."""
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
        vecs = self.sink[p, s].cpu().numpy()
        seen = self.sink_seen[p, s].cpu().numpy()
        return {int(v): vecs[i] for i, v in enumerate(vids) if seen[i]}

    def embeddings(self) -> dict:
        """Materialized final-layer embeddings {vid: vector} (masters)."""
        return self.read_nodes(np.flatnonzero(self.part.t.master >= 0))
