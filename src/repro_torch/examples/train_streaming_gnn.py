"""Continual-training driver: streaming inference + training under drift
(the paper's concept-drift scenario, §4.3) over ONE validated TrainConfig
and two interchangeable training paths.

Counterpart of `examples/train_streaming_gnn.py`, with the same flags plus
--device:

  * --mode online (default): `TrainSession` drives the fifth (training)
    plane — labels admit into the super-tick itself and the windowed
    fire-masked backprop + Algorithm 3 update runs on the device WITHOUT
    ever stopping the stream;
  * --mode halt-flush: `TrainingCoordinator` — the paper's §4.3.1
    halt/flush/train/rebuild cycle.

    PYTHONPATH=src python -m repro_torch.examples.train_streaming_gnn \\
        [--phases 3] [--mode halt-flush] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.examples import Say, add_device_args


def make_labels(rng, feats, w_true, n_nodes, d_in, n_cls, phase):
    """Drifted ground truth: hidden linear model + per-phase drift."""
    drift = rng.normal(size=(d_in, n_cls)) * 0.3 * phase
    logits = np.stack([feats[v] for v in range(n_nodes)]) @ (w_true + drift)
    return {v: int(np.argmax(logits[v])) for v in range(n_nodes)}


def _config(n_nodes, train_cap=0):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import PipelineConfig
    return PipelineConfig(n_parts=8, node_cap=192, edge_cap=2048,
                          repl_cap=1024, feat_cap=2048, edge_tick_cap=256,
                          max_nodes=n_nodes, train_cap=train_cap,
                          window=win.WindowConfig(kind=win.SESSION,
                                                  interval=4))


def run_online(args, say, rng, feats, w_true, n_nodes, d_in, n_cls,
               params=None, head_params=None):
    from repro_torch.core.pipeline import D3Pipeline
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.graph.graphs import powerlaw_edges
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.optim import adam
    from repro_torch.serve.train_session import TrainSession
    model = GraphSAGE((d_in, 32, 32), n_classes=n_cls, seed=0)
    if params is not None:
        model.load_state_dict(params)
    tcfg = TrainConfig(optimizer=adam(), lr=5e-3, batch_threshold=4)
    pipe = D3Pipeline(model, _config(n_nodes, train_cap=64), train=tcfg,
                      device=args.device)
    sess = TrainSession(pipe, driver="super", super_ticks=8)

    for phase in range(args.phases):
        edges = powerlaw_edges(rng, n_nodes, args.edges_per_phase)
        e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 128)
        labels = make_labels(rng, feats, w_true, n_nodes, d_in, n_cls, phase)
        # labels ride the SAME launches as the topology/feature stream
        sess.observe_labels(labels)
        sess.advance_super(e_chunks, f_chunks)
        sess.flush()
        first = sess.train_stats()
        # second pass over the same drifted labels: re-admission re-dirties
        # the window, more fires, loss keeps dropping — while serving
        for _ in range(args.epochs):
            sess.observe_labels(labels)
            sess.flush()
        last = sess.train_stats()
        say.keep("loss", (first["loss"], last["loss"]))
        say.keep("grad_norm", last["grad_norm"])
        say(f"phase {phase}: steps={last['steps']} "
            f"loss {first['loss']:.3f} -> {last['loss']:.3f} "
            f"|g|={last['grad_norm']:.3f} backlog={last['backlog']}")
        assert last["steps"] > first["steps"], "training never fired"
        assert last["loss"] < first["loss"]
    say("online continual-training driver OK")


def run_halt_flush(args, say, rng, feats, w_true, n_nodes, d_in, n_cls,
                   params=None, head_params=None):
    from repro_torch.core.pipeline import D3Pipeline
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.core.training import TrainingCoordinator
    from repro_torch.graph.graphs import powerlaw_edges
    from repro_torch.graph.sage import GraphSAGE, linear_tree
    from repro_torch.nn.layers import Linear
    from repro_torch.optim import adam
    model = GraphSAGE((d_in, 32, 32), seed=0)
    if params is not None:
        model.load_state_dict(params)
    pipe = D3Pipeline(model, _config(n_nodes), device=args.device)
    head = Linear(32, n_cls, generator=torch.Generator().manual_seed(1))
    if head_params is not None:
        head.load_state_dict(head_params)
    head = head.to(pipe.device)
    tcfg = TrainConfig(optimizer=adam(), lr=5e-3, batch_threshold=4,
                       epochs=args.epochs)
    coord = TrainingCoordinator(pipe, head, linear_tree(head), tcfg)

    for phase in range(args.phases):
        edges = powerlaw_edges(rng, n_nodes, args.edges_per_phase)
        pipe.run_stream(edges, feats, tick_edges=128)
        labels = make_labels(rng, feats, w_true, n_nodes, d_in, n_cls, phase)
        coord.labels.clear()
        coord.observe_labels(labels)
        if coord.should_train():
            res = coord.train()
            say.keep("losses", res.losses)
            say(f"phase {phase}: votes={res.votes} "
                f"flush_ticks={res.flush_ticks} "
                f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
            assert res.losses[-1] < res.losses[0]
        else:
            say(f"phase {phase}: not enough votes ({coord.votes()})")
    say("halt-flush continual-training driver OK")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("online", "halt-flush"),
                    default="online")
    ap.add_argument("--phases", type=int, default=3)
    ap.add_argument("--edges-per-phase", type=int, default=600)
    ap.add_argument("--epochs", type=int, default=10)
    add_device_args(ap)
    return ap.parse_args(argv)


def run(args, params=None, head_params=None) -> Say:
    """The example on one device, as the JAX example runs. params: the
    GraphSAGE `state_dict` (online: with its Linear(32, 5) head;
    halt-flush: without); head_params: halt-flush's head {"w", "b"}
    (default: drawn from seeds 0 and 1)."""
    say = Say()
    rng = np.random.default_rng(0)
    n_nodes, d_in, n_cls = 250, 16, 5
    feats = {v: rng.normal(size=d_in).astype(np.float32)
             for v in range(n_nodes)}
    # ground-truth labels from a hidden random linear model over features
    w_true = rng.normal(size=(d_in, n_cls))
    body = run_online if args.mode == "online" else run_halt_flush
    body(args, say, rng, feats, w_true, n_nodes, d_in, n_cls, params,
         head_params)
    return say


def main(argv=None) -> Say:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
