"""Quickstart: stream a graph through D3-GNN, verify exactness, train.

Counterpart of `examples/quickstart.py`, with the same flag plus --device
and --ranks:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--stage S]

Builds a 2-layer GraphSAGE (the paper's model), streams a synthetic
power-law edge stream through the windowed pipeline, checks the sink
against the static oracle, then runs one stale-free training cycle.
stage=1 (the default) runs on one device; --stage 2 runs the hybrid
layer-pipelined path on a ('stage', 'data') grid of gloo ranks, two
unless --ranks says more:

    PYTHONPATH=src python -m repro_torch.examples.quickstart --stage 2 \\
        --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.examples import Say, add_device_args, launch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", type=int, default=1,
                    help="pipeline stages on the ('stage', 'data') mesh")
    add_device_args(ap, ranks=True)
    return ap.parse_args(argv)


def mesh_shape(mesh) -> dict:
    """The mesh line's dict as JAX prints `mesh.devices.shape` by axis:
    {'data': D} on one device or a 1-D mesh, else {'stage': S, 'data':
    D}."""
    if mesh is None:
        return {"data": 1}
    if mesh.n_stages == 1:
        return {"data": mesh.n_data}
    return {"stage": mesh.n_stages, "data": mesh.n_data}


def run(args, mesh=None, params=None, head_params=None) -> Say:
    """The example on one device (mesh None) or on this rank of a mesh
    (every rank calls it). params: a GraphSAGE((d_in, 32, 32))
    `state_dict`; head_params: the {"w", "b"} tree of the Linear(32, 4)
    head (default: drawn from seeds 0 and 1)."""
    from repro_torch.core import windowing as win
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.core.training import TrainingCoordinator
    from repro_torch.graph.graphs import powerlaw_edges
    from repro_torch.graph.sage import GraphSAGE, linear_tree
    from repro_torch.nn.layers import Linear
    from repro_torch.optim import sgd
    say = Say(mesh)

    rng = np.random.default_rng(0)
    # stage > 1 pipelines the layers round-robin over stages, which needs a
    # stage-uniform stack (in_dim == out_dim on every layer).
    n_nodes = 200
    d_in = 16 if args.stage == 1 else 32
    edges = powerlaw_edges(rng, n_nodes, 1000)
    feats = {v: rng.normal(size=d_in).astype(np.float32)
             for v in range(n_nodes)}

    model = GraphSAGE((d_in, 32, 32), seed=0)
    if params is not None:
        model.load_state_dict(params)
    cfg = PipelineConfig(n_parts=8, node_cap=256, edge_cap=1024,
                         repl_cap=512, feat_cap=1024, edge_tick_cap=256,
                         max_nodes=n_nodes, n_stages=args.stage,
                         window=win.WindowConfig(kind=win.SESSION, interval=4))
    pipe = D3Pipeline(model, cfg, mesh=mesh,
                      device=args.device if mesh is None else None)
    say(f"mesh: {mesh_shape(mesh)}")

    say("== streaming 1000 edges through the windowed pipeline ==")
    pipe.run_stream(edges, feats, tick_edges=128)
    pipe.flush()
    m = pipe.metrics
    say(f"ticks={m.ticks} emitted={m.emitted_total} "
        f"reduce_msgs={m.reduce_msgs} cross_part={m.cross_part_msgs} "
        f"replication={pipe.part.replication_factor():.2f}")
    if args.stage > 1:
        say(f"pipeline bubble fraction: {pipe.bubble_fraction():.3f} "
            f"(stage_idle={m.stage_idle})")

    say("== exactness vs static oracle ==")
    emb = pipe.embeddings()
    g, _ = build_snapshot(edges, feats, d_in, n_nodes, pipe.device)
    ref = oracle_embeddings(pipe.model, g).cpu().numpy()
    err = max(float(np.abs(v - ref[k]).max()) for k, v in emb.items())
    say(f"embeddings materialized: {len(emb)}; max |err| = {err:.2e}")
    assert err < 1e-4

    say("== stale-free training cycle (halt -> flush -> train -> rebuild) ==")
    labels = {v: int(rng.integers(0, 4)) for v in range(n_nodes)}
    head = Linear(32, 4, generator=torch.Generator().manual_seed(1))
    if head_params is not None:
        head.load_state_dict(head_params)
    head = head.to(pipe.device)
    coord = TrainingCoordinator(
        pipe, head, linear_tree(head),
        TrainConfig(optimizer=sgd(), lr=0.1, batch_threshold=2))
    coord.observe_labels(labels)
    say(f"StartTraining votes: {coord.votes()}/{cfg.n_parts}")
    res = coord.train(epochs=5)
    say.keep("losses", res.losses)
    say(f"losses: {[round(l, 3) for l in res.losses]}")
    say("quickstart OK")
    return say


def main(argv=None) -> Say:
    return launch(run, parse_args(argv))


if __name__ == "__main__":
    main()
