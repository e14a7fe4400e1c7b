"""End-to-end serving driver (the paper's kind: online streaming inference).

Counterpart of `examples/streaming_serve.py`, with the same flags plus
--device and --ranks. Drives the SUPER-TICK path through a
`ServeSession`: every device launch ingests a chunk of the edge stream
AND admits a batch of point queries (embedding reads + on-device link
scores, mixed stale_ok/consistent), answered from the live state in the
launch's single host sync. Reports update throughput alongside query
latency percentiles, checkpoints mid-run, and runs a LIVE fail-stop drill:
the session degrades, the checkpoint restores, `D3Pipeline.reshard` relays
the carry onto the survivor mesh — same pipeline object, same session,
pending queries intact — and serving resumes on fewer shards.

    PYTHONPATH=src python -m repro_torch.examples.streaming_serve \\
        [--edges 4000] [--device cpu]

On one device the drill relays in place. --ranks N serves from N gloo
ranks (the JAX example's device count), and the drill reshards N -> N/2:

    PYTHONPATH=src python -m repro_torch.examples.streaming_serve --ranks 4

--stage S serves from the hybrid layer-pipelined engine on a ('stage',
'data') grid (S ranks unless --ranks says more); the default --stage 1 is
the classic 1-D engine. The checkpoint goes to --ckpt-dir
(results/serve_ckpt, as the JAX example writes it), and the drill restores
the step this run saved there.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.examples import Say, add_device_args, launch


def build(n_nodes, d_in, seed=0, stage=1, mesh=None, device=None,
          params=None):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    model = GraphSAGE((d_in, 32, 32), seed=0)
    if params is not None:
        model.load_state_dict(params)
    cfg = PipelineConfig(n_parts=8, node_cap=4 * n_nodes // 8,
                         edge_cap=4096, repl_cap=2 * n_nodes,
                         feat_cap=2048, edge_tick_cap=512,
                         query_cap=16, query_tick_cap=64,
                         max_nodes=n_nodes, base_parallelism=4,
                         n_stages=stage,
                         window=win.WindowConfig(kind=win.ADAPTIVE),
                         seed=seed)
    return model, D3Pipeline(model, cfg, mesh=mesh,
                             device=device if mesh is None else None)


def submit_mix(session, rng, known, queries_per_launch):
    """A serving traffic mix: 60% stale embeds, 20% consistent embeds,
    20% stale link scores over already-streamed vertices."""
    if not known:
        return
    pool = np.asarray(sorted(known))
    n = queries_per_launch
    session.submit_embed(rng.choice(pool, max(1, int(n * 0.6))))
    session.submit_embed(rng.choice(pool, max(1, int(n * 0.2))),
                         consistent=True)
    pairs = rng.choice(pool, (max(1, int(n * 0.2)), 2))
    session.submit_link([(int(a), int(b)) for a, b in pairs])


def serve_half(session, edges, feats, args, rng, seen, ingested,
               super_ticks=8):
    """Interleave update super-ticks with query admissions; queries only
    name vertices whose edges have already been ingested."""
    e_chunks, f_chunks = session.pipe.chunk_stream(
        edges, feats, args.tick_edges, seen=seen)
    for lo in range(0, len(e_chunks), super_ticks):
        submit_mix(session, rng, ingested, args.queries_per_launch)
        session.advance_super(e_chunks[lo: lo + super_ticks],
                              f_chunks[lo: lo + super_ticks],
                              T=super_ticks)
        for ch in e_chunks[lo: lo + super_ticks]:
            ingested.update(int(u) for u in ch.reshape(-1))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", type=int, default=4000)
    ap.add_argument("--nodes", type=int, default=500)
    ap.add_argument("--tick-edges", type=int, default=128)
    ap.add_argument("--queries-per-launch", type=int, default=32)
    ap.add_argument("--stage", type=int, default=1,
                    help="pipeline stages on the ('stage', 'data') mesh")
    ap.add_argument("--ckpt-dir", default="results/serve_ckpt",
                    help="where the mid-run checkpoint goes")
    add_device_args(ap, ranks=True)
    return ap.parse_args(argv)


def run(args, mesh=None, params=None) -> Say:
    """The example on one device (mesh None) or on this rank of a mesh
    (every rank calls it; a rank the drill removes returns after the
    reshard). params: the GraphSAGE((d_in, 32, 32)) `state_dict`
    (default: drawn from seed 0)."""
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.ft.elastic import rescale_parts
    from repro_torch.graph.graphs import powerlaw_edges
    from repro_torch.launch.mesh import survivor_mesh
    from repro_torch.serve.session import ServeSession
    say = Say(mesh)

    rng = np.random.default_rng(0)
    # the layer-pipelined engine needs a stage-uniform stack (d_in == d_out)
    d_in = 16 if args.stage == 1 else 32
    edges = powerlaw_edges(rng, args.nodes, args.edges)
    feats = {v: rng.normal(size=d_in).astype(np.float32)
             for v in range(args.nodes)}
    _, pipe = build(args.nodes, d_in, stage=args.stage, mesh=mesh,
                    device=args.device, params=params)
    session = ServeSession(pipe, driver="super", super_ticks=8)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, async_write=True)

    half = len(edges) // 2
    seen, ingested = set(), set()
    t_start = time.perf_counter()
    serve_half(session, edges[:half], feats, args, rng, seen, ingested)
    saved = pipe.now
    mgr.save_pipeline(step=saved, pipe=pipe)
    mgr.wait()
    say(f"checkpointed at tick {pipe.now} "
        f"(emitted so far: {pipe.metrics.emitted_total}, "
        f"queries answered: {pipe.metrics.queries_answered})")

    # ---- fail-stop drill: lose half the shards, keep serving LIVE ----
    # The session degrades (stale_ok flows, consistent holds), the
    # checkpoint restores INTO THE SAME PIPELINE, and reshard relays the
    # carry — layer tables, defer rings, held queries — onto the survivor
    # mesh. No second pipeline, no new session: pending qids ride along.
    session.degrade("failstop drill")
    old_d = pipe._n_data
    new_d = max(1, old_d // 2)
    while new_d > 1 and pipe.cfg.n_parts % new_d:
        new_d -= 1
    # this run's cut: the JAX example restores the directory's latest,
    # which is an earlier run's when that one stopped at a later tick
    step = mgr.restore_pipeline(pipe, step=saved)
    if new_d < old_d:
        lost = list(range(new_d, old_d))
        pipe.reshard(survivor_mesh(pipe.mesh, lost, n_data=new_d))
        plan = rescale_parts(old_d, new_d, pipe.cfg.n_parts)
        say.keep("moved_fraction", plan.moved_fraction)
        say(f"recovered checkpoint step={step}; live reshard "
            f"{old_d}->{new_d} shards moved {plan.moved_fraction:.0%} "
            f"of logical parts")
    else:
        pipe.reshard(pipe.mesh)   # single shard: relay in place
        say(f"recovered checkpoint step={step}; single-shard relay")
    if not pipe.active:           # a rank the drill removed
        return say
    session.restore_normal()
    serve_half(session, edges[half:], feats, args, rng, seen, ingested)
    session.flush()
    wall = time.perf_counter() - t_start

    # ONE pipeline end to end — it survived the drill; no summing across
    # a second instance
    m = pipe.metrics
    answered = list(session.answers.values())
    lats = np.asarray([a.latency_s for a in answered
                       if a.latency_s is not None]) * 1e3
    stale = np.asarray([a.staleness_ticks for a in answered])
    say(f"stream done: {args.edges} edges in {wall:.1f}s "
        f"({args.edges / wall:.0f} edges/s ingested)")
    if args.stage > 1:
        say(f"pipeline bubble fraction: {pipe.bubble_fraction():.3f} "
            f"(stage_idle={m.stage_idle})")
    say(f"emitted={m.emitted_total} "
        f"reduce_msgs={m.reduce_msgs} cross_part={m.cross_part_msgs}")
    st = session.latency_stats()
    n_ok = sum(a.ok for a in answered)
    say(f"queries resolved={len(answered)} (ok={n_ok}, "
        f"device-answered={m.queries_answered}, "
        f"dropped={m.queries_dropped}, shed={st['shed']}, "
        f"degraded_ticks={st['degraded_ticks']})")
    if lats.size:
        say(f"query latency ms: p50={np.percentile(lats, 50):.1f} "
            f"p95={np.percentile(lats, 95):.1f} "
            f"p99={np.percentile(lats, 99):.1f}; "
            f"staleness ticks p50={np.percentile(stale, 50):.0f} "
            f"max={stale.max()}")
    n_emb = len(pipe.embeddings())             # collective on a mesh
    n_read = len(pipe.read_nodes(range(8)))
    say(f"embedding table size: {n_emb} "
        f"(read_nodes on 8 vids: {n_read})")
    say("serve driver OK")
    return say


def main(argv=None) -> Say:
    return launch(run, parse_args(argv))


if __name__ == "__main__":
    main()
