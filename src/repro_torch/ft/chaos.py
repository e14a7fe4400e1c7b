"""Chaos plane: deterministic fault injection for the tick.

Counterpart of `repro/ft/chaos.py`. A recovery path counts only once
something can cause the failure: each scenario is a seeded, wall-clock-free
program (a fixed event stream + a tick-indexed fault schedule), so the
drills run in the tests rather than by hand:

  * checkpoint-write truncation (`scenario_truncated_checkpoint`): the
    newest .ckpt is torn mid-blob; restore must fail loudly
    (`CheckpointCorruptError` with step + path) and fall back to the
    previous kept generation;
  * admission storm (`scenario_admission_storm`): a query burst far beyond
    the per-tick admission budget; the ServeSession degrades observably
    (shed + bounded retry counters) instead of stalling or silently
    dropping.

Both return the reference's report dicts for the same config. The other
two drills, fail-stop shard loss (`scenario_failstop`) and the fail-slow
shard (`scenario_slow_shard`), need the survivor mesh and the live
reshard (ROADMAP Queue 1 item 13) and raise NotImplementedError.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.ft.checkpoint import CheckpointCorruptError, CheckpointManager
from repro_torch.graph.sage import GraphSAGE
from repro_torch.serve.session import ServeSession


@dataclass
class ChaosConfig:
    """Deterministic chaos schedule: everything is keyed to the seeded
    event stream and chunk indices, no wall clock, so every scenario
    replays bit-identically."""
    seed: int = 0
    n_vertices: int = 48
    n_events: int = 288
    d_in: int = 8
    n_hubs: int = 3
    hub_fraction: float = 0.3        # steady-state hub traffic share
    spike_fraction: float = 0.75     # hub share during the traffic spike
    spike_from: float = 0.5          # spike starts at this stream fraction
    tick_edges: int = 16             # events per chunk (one tick each)
    n_parts: int = 4
    node_cap: int = 64
    query_cap: int = 8
    driver: str = "tick"             # "tick" | "super"
    # fault schedule (chunk-indexed)
    fail_at_chunk: int = 10          # fail-stop strikes BEFORE this chunk
    lose_shards: tuple = (1, 3)      # data-shard indices lost
    checkpoint_every: int = 3        # consistent cut cadence (chunks)
    slow_shard: int = 1              # fail-slow target
    slow_factor: float = 8.0         # injected wall multiple when slow
    storm_queries: int = 96          # admission-storm burst size
    reserved: int = 4                # vertex ids the stream NEVER emits
                                     # (late-materializing endpoints for
                                     # the retry path)
    route_cap: int | None = None     # None keeps runs bit-equal across D


def hub_heavy_stream(cfg: ChaosConfig):
    """Seeded hub-heavy event stream with a mid-stream traffic spike:
    returns (edges [n,2] int64, feats {vid: [d_in] f32}, hubs). The top
    `cfg.reserved` vertex ids never appear; scenarios introduce them late
    to exercise endpoint-not-yet-materialized answers."""
    rng = np.random.default_rng(cfg.seed)
    active = cfg.n_vertices - cfg.reserved
    hubs = rng.choice(active, size=cfg.n_hubs, replace=False)
    n = cfg.n_events
    frac = np.where(np.arange(n) < cfg.spike_from * n,
                    cfg.hub_fraction, cfg.spike_fraction)
    src = rng.integers(0, active, n)
    dst = np.where(rng.random(n) < frac,
                   hubs[rng.integers(0, len(hubs), n)],
                   rng.integers(0, active, n))
    edges = np.stack([src, dst], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=cfg.d_in).astype(np.float32)
             for v in range(cfg.n_vertices)}
    return edges, feats, hubs


def _chunks(cfg: ChaosConfig, edges):
    return [edges[i:i + cfg.tick_edges]
            for i in range(0, len(edges), cfg.tick_edges)]


def _feat_rows(chunk, feats):
    return [(int(v), feats[int(v)]) for e in chunk for v in set(map(int, e))]


def build_pipeline(cfg: ChaosConfig, mesh=None, n_stages: int = 1,
                   telemetry: bool = False, device=None) -> D3Pipeline:
    """The drills' pipeline, its weights drawn from `cfg.seed`; `device`
    as D3Pipeline takes it (CUDA unless given)."""
    model = GraphSAGE((cfg.d_in, cfg.d_in, cfg.d_in), seed=cfg.seed)
    pcfg = PipelineConfig(
        n_parts=cfg.n_parts, node_cap=cfg.node_cap, edge_cap=256,
        repl_cap=256, feat_cap=256, edge_tick_cap=2 * cfg.tick_edges,
        max_nodes=cfg.n_vertices, query_cap=cfg.query_cap,
        n_stages=n_stages, route_cap=cfg.route_cap, telemetry=telemetry,
        window=win.WindowConfig(kind=win.SESSION, interval=3))
    return D3Pipeline(model, pcfg, mesh=mesh, device=device)


def _advance(session: ServeSession, chunk, feats):
    rows = _feat_rows(chunk, feats) if len(chunk) else None
    ed = chunk if len(chunk) else None
    if session.driver == "tick":
        session.advance(ed, rows)
    else:
        session.advance_super([ed] if ed is not None else None,
                              [rows] if rows is not None else None, T=1)


# ------------------------------------------------------------- scenarios
def scenario_failstop(cfg: ChaosConfig, ckpt_dir, d_old: int = 4,
                      d_new: int = 2, n_stages: int = 1) -> dict:
    """Fail-stop shard loss mid-stream: recovery reshards the restored
    carry onto the survivor mesh, which is not ported."""
    raise NotImplementedError(
        "scenario_failstop needs survivor_mesh and the live reshard, not "
        "ported to repro_torch yet (ROADMAP Queue 1 item 13)")


def scenario_truncated_checkpoint(cfg: ChaosConfig, ckpt_dir,
                                  device=None) -> dict:
    """Tear the newest checkpoint blob mid-write; restore must fail
    loudly and fall back to the previous kept generation."""
    edges, feats, _ = hub_heavy_stream(cfg)
    chunks = _chunks(cfg, edges)[:4]
    pipe = build_pipeline(cfg, device=device)
    session = ServeSession(pipe, driver=cfg.driver)
    mgr = CheckpointManager(Path(ckpt_dir) / "torn", keep=3)
    for i, chunk in enumerate(chunks):
        _advance(session, chunk, feats)
        mgr.save_pipeline(i + 1, pipe)
    good = mgr.latest()
    blob = good.path.read_bytes()
    good.path.write_bytes(blob[: max(8, len(blob) // 2)])   # torn write
    explicit_error = None
    try:
        mgr.restore_pipeline(pipe, step=good.step)
    except CheckpointCorruptError as e:
        explicit_error = str(e)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored_step = mgr.restore_pipeline(pipe)
    return {
        "torn_step": good.step,
        "explicit_error": explicit_error,
        "restored_step": restored_step,
        "fallback_warned": any("falling back" in str(w.message)
                               for w in caught),
    }


def scenario_slow_shard(cfg: ChaosConfig, d_old: int = 4,
                        n_stages: int = 1) -> dict:
    """Fail-slow shard: mitigation reshards away from the slow shard,
    which is not ported."""
    raise NotImplementedError(
        "scenario_slow_shard needs the live reshard of "
        "mitigate_stragglers, not ported to repro_torch yet (ROADMAP "
        "Queue 1 item 13)")


def scenario_admission_storm(cfg: ChaosConfig, device=None) -> dict:
    """Query burst far beyond the per-tick admission budget: the session
    sheds beyond `shed_threshold` and bound-retries the retriable
    ok=False answers (queries naming vertices the stream has not
    materialized yet succeed on a later attempt); every counter lands in
    latency_stats(), nothing is silent."""
    edges, feats, _ = hub_heavy_stream(cfg)
    chunks = _chunks(cfg, edges)
    pipe = build_pipeline(cfg, device=device)
    session = ServeSession(pipe, driver=cfg.driver, max_retries=4,
                           retry_backoff_ticks=1, shed_threshold=64)
    rng = np.random.default_rng(cfg.seed + 1)
    active = cfg.n_vertices - cfg.reserved
    late = list(range(active, cfg.n_vertices))
    storm_qids = []
    for i, chunk in enumerate(chunks):
        if i == 2:   # the storm: one burst >> admissions * ticks left
            vids = rng.integers(0, active, cfg.storm_queries)
            storm_qids = session.submit_embed(vids)
        _advance(session, chunk, feats)
    late_qids = session.submit_embed(late)
    _advance(session, np.zeros((0, 2), np.int64), feats)  # -> ok=False
    late_edges = np.asarray([[late[k], late[(k + 1) % len(late)]]
                             for k in range(len(late))], np.int64)
    _advance(session, late_edges, feats)   # NOW they materialize
    session.flush()   # window emits; the late embeddings reach the sink
    # release the backoff retries with empty ticks until they answer
    for _ in range(16):
        _advance(session, np.zeros((0, 2), np.int64), feats)
        if all(q in session.answers for q in late_qids):
            break
    session.flush()
    stats = session.latency_stats()
    resolved = sum(1 for q in storm_qids if q in session.answers)
    late_ok = {q: session.answers[q].ok for q in late_qids
               if q in session.answers}
    return {
        "stats": stats, "n_storm": len(storm_qids),
        "storm_resolved": resolved,
        "late_ok": late_ok,
        "outstanding": session.outstanding,
        "dropped": int(pipe.metrics.dropped),
        "route_dropped": int(pipe.metrics.route_dropped),
    }


SCENARIOS = {
    "failstop": scenario_failstop,
    "truncated_checkpoint": scenario_truncated_checkpoint,
    "slow_shard": scenario_slow_shard,
    "admission_storm": scenario_admission_storm,
}
