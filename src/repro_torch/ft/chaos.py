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

  * fail-stop shard loss (`scenario_failstop`): consistent-cut
    checkpoints, then shards are lost mid-stream; the last cut restores,
    the carry reshards onto the survivor mesh, the chunks since the cut
    replay, and the result must equal an uninterrupted run;
  * fail-slow shard (`scenario_slow_shard`): a synthetic wall schedule
    flags a slow shard and `mitigate_stragglers()` reshards away from it.

Each returns the reference's report dict for the same config. The two
mesh drills are collective: every process of a world of
n_stages * d_old ranks (`launch/mesh.py:spawn_stream_mesh`) calls them;
the report is complete on the ranks that survive (rank 0 always does),
and None on the ranks the drill removes.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.ft.checkpoint import CheckpointCorruptError, CheckpointManager
from repro_torch.ft.elastic import rescale_parts
from repro_torch.graph.sage import GraphSAGE
from repro_torch.launch.mesh import make_stream_mesh, survivor_mesh
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
                      d_new: int = 2, n_stages: int = 1,
                      device=None) -> dict:
    """Hub-heavy spike + fail-stop shard loss mid-stream.

    Oracle first: the SAME stream, queries and driver, uninterrupted on
    the d_old grid. Then the chaos run: consistent-cut checkpoints every
    `checkpoint_every` chunks; before chunk `fail_at_chunk` the shards in
    `lose_shards` fail-stop — the session degrades, the last checkpoint
    restores, the carry reshards onto the survivor mesh, the chunks since
    the cut REPLAY, and the stream resumes. Returns both runs' sinks
    (global [P, N, d] numpy), answers and drop counters for the caller to
    compare. Collective over a world of n_stages * d_old processes;
    `device` as make_stream_mesh takes it. The lost ranks return None."""
    edges, feats, hubs = hub_heavy_stream(cfg)
    chunks = _chunks(cfg, edges)
    fail_at = min(cfg.fail_at_chunk, len(chunks) - 1)
    # consistent queries submitted right before the cut preceding the
    # failure: held on the device, checkpointed, restored, answered after
    # recovery
    cut = (fail_at // cfg.checkpoint_every) * cfg.checkpoint_every
    q_vids = [int(h) for h in hubs]

    def _run(fail: bool):
        pipe = build_pipeline(cfg, make_stream_mesh(device, stage=n_stages),
                              n_stages=n_stages)
        session = ServeSession(pipe, driver=cfg.driver, max_retries=2)
        mgr = (CheckpointManager(Path(ckpt_dir) / "chaos", keep=3)
               if fail else None)
        qids = None
        restored_step = None
        for i, chunk in enumerate(chunks):
            if i == cut - 1 and cut > 0:
                qids = session.submit_embed(q_vids, consistent=True)
            if fail and i == fail_at:
                # ---- fail-stop: the shards in lose_shards are gone
                session.degrade("failstop drill")
                surv = survivor_mesh(pipe.mesh, cfg.lose_shards,
                                     n_data=d_new)
                restored_step = mgr.restore_pipeline(pipe)
                rescale_parts(d_old, d_new, cfg.n_parts)
                pipe.reshard(surv)
                if not pipe.active:
                    return None
                for j in range(restored_step, i):   # replay since cut
                    _advance(session, chunks[j], feats)
                session.restore_normal()
            _advance(session, chunk, feats)
            if fail and (i + 1) % cfg.checkpoint_every == 0 and i < fail_at:
                mgr.save_pipeline(i + 1, pipe)
        session.flush()
        return (pipe.sink_global().cpu().numpy(), pipe.metrics, session,
                qids, restored_step)

    o_sink, o_met, o_sess, o_qids, _ = _run(fail=False)
    chaos = _run(fail=True)
    if chaos is None:
        return None
    c_sink, c_met, c_sess, c_qids, restored_step = chaos
    o_ans = {q: o_sess.answers[q] for q in (o_qids or [])
             if q in o_sess.answers}
    c_ans = {q: c_sess.answers[q] for q in (c_qids or [])
             if q in c_sess.answers}
    return {
        "oracle_sink": o_sink, "chaos_sink": c_sink,
        "oracle_answers": o_ans, "chaos_answers": c_ans,
        "restored_step": restored_step,
        "dropped": int(c_met.dropped),
        "route_dropped": int(c_met.route_dropped),
        "oracle_dropped": int(o_met.dropped),
        "stats": c_sess.latency_stats(),
        "n_chunks": len(chunks), "cut": cut, "fail_at": fail_at,
    }


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
                        n_stages: int = 1, device=None) -> dict:
    """Deterministic fail-slow: a synthetic wall-time schedule feeds the
    StragglerMitigator exactly as the live telemetry plane does (tick
    wall + per-shard busy); once the slow shard's flag is persistent,
    `mitigate_stragglers()` executes the re-map — a live reshard onto
    the survivors, with `parts_per_shard()` re-mapped end-to-end.
    Collective over a world of n_stages * d_old processes; the ranks the
    reshard removes return None."""
    edges, feats, _ = hub_heavy_stream(cfg)
    chunks = _chunks(cfg, edges)
    mesh = make_stream_mesh(device, stage=n_stages)
    pipe = build_pipeline(cfg, mesh, n_stages=n_stages, telemetry=True)
    before = [p.copy() for p in pipe.parts_per_shard()]
    base_wall = 1.0
    plan = None
    mitigated_at = None
    for i, chunk in enumerate(chunks):
        if not pipe.active:
            return None
        rows = _feat_rows(chunk, feats)
        if cfg.driver == "tick":
            pipe.tick(chunk, rows)
        else:
            pipe.run_super_tick([chunk], [rows])
        if plan is None:
            # deterministic injected walls: the slow shard stretches the
            # lock-step tick by slow_factor and shows the highest busy.
            # The live telemetry feed also observes every tick (real
            # walls never flag, but non-flagged ticks DECAY flags by 1),
            # so the injection repeats past patience + decay per chunk.
            busy = np.ones(max(pipe._n_data, 1))
            busy[cfg.slow_shard] = 2.0
            if i < 2:
                pipe.straggler.observe_tick(base_wall, busy)
            else:
                slow = base_wall * cfg.slow_factor
                for _ in range(pipe.straggler.patience + 2):
                    pipe.straggler.observe_tick(slow, busy)
            got = pipe.mitigate_stragglers()
            if got is not None:
                plan, mitigated_at = got, i
    if not pipe.active:
        return None
    pipe.flush(max_ticks=256)
    return {
        "plan": plan, "mitigated_at_chunk": mitigated_at,
        "parts_before": before,
        "parts_after": [p.copy() for p in pipe.parts_per_shard()],
        "n_data_after": pipe._n_data,
        "dropped": int(pipe.metrics.dropped),
        "route_dropped": int(pipe.metrics.route_dropped),
        "sink": pipe.sink_global().cpu().numpy(),
        "ticks_observed": pipe.straggler.ticks_observed,
    }


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
