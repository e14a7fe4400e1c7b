"""Serving launcher: the streaming-GNN online pipeline (d3gnn-sage), LM
batched greedy decode (mistral-nemo-12b, moonshot-v1-16b-a3b,
llama4-maverick-400b-a17b, internlm2-20b, mistral-large-123b) or
two-tower user-tower requests (two-tower-retrieval), selected by --arch.

Counterpart of `repro/launch/serve.py`, with the same flags plus --device,
--dims and --requests; the GNN and LM paths print the same line. The JAX
launcher sends two-tower-retrieval into its LM path, which has no cache
for it (ROADMAP Queue 3); here it answers serve_p99 requests. It sends
the GNN zoo's archs there too (ROADMAP R16); here they raise ValueError:
their shapes are train shapes (repro_torch.launch.train runs them).

    PYTHONPATH=src python -m repro_torch.launch.serve --edges 1500
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --edges 1500 --driver tick
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mistral-nemo-12b --tokens 32                # full width
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mistral-nemo-12b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot-v1-16b-a3b --tokens 32              # full width
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot-v1-16b-a3b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch two-tower-retrieval --requests 64             # full width
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch two-tower-retrieval --reduced --device cpu

The weights are random (torch.Generator, seed 0): the pinned RMI and
cross-part counts do not depend on their values. The LMs and the
two-tower model run at full width unless --reduced is given (the JAX
launcher always builds the reduced LM, ROADMAP Queue 3). In bf16
mistral-nemo-12b, internlm2-20b and moonshot-v1-16b-a3b fit one 80 GB
card whole; llama4-maverick-400b-a17b and mistral-large-123b do not, and
run --reduced there.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def serve_stream(args, mesh=None, route_cap=None):
    """Stream the serve workload; prints the summary line (rank 0 of a
    mesh) and returns the pipeline. mesh: this process's rank of a
    `dist/mesh.py:StreamMesh` (`launch/mesh.py` builds one), or None for
    one device; route_cap: the mesh's per-destination bucket rows (None:
    the dense exchange)."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.graphs import powerlaw_edges
    from repro_torch.graph.sage import GraphSAGE
    dims = tuple(int(d) for d in args.dims.split(","))
    rng = np.random.default_rng(0)
    n_nodes = 400
    edges = powerlaw_edges(rng, n_nodes, args.edges)
    feats = {v: rng.normal(size=dims[0]).astype(np.float32)
             for v in range(n_nodes)}
    cfg = PipelineConfig(n_parts=8, node_cap=256, edge_cap=4096,
                         repl_cap=1024, feat_cap=2048, edge_tick_cap=512,
                         max_nodes=n_nodes, route_cap=route_cap,
                         window=win.WindowConfig(kind=win.SESSION, interval=4))
    pipe = D3Pipeline(GraphSAGE(dims), cfg, mesh=mesh,
                      device=args.device if mesh is None else None)
    t0 = time.perf_counter()
    if args.driver == "super":
        # T micro-ticks per host sync (the serving default for throughput)
        pipe.run_stream_super(edges, feats, tick_edges=args.tick_edges,
                              super_ticks=args.super_ticks)
        pipe.flush_super(max_ticks=64, T=4)
    else:
        pipe.run_stream(edges, feats, tick_edges=args.tick_edges)
        pipe.flush()
    dt = time.perf_counter() - t0
    n_emb = len(pipe.embeddings())            # collective on a mesh
    if mesh is None or mesh.rank == 0:
        print(f"streamed {args.edges} edges in {dt:.2f}s "
              f"[{args.driver} driver, {args.edges / dt:.0f} ev/s]; "
              f"materialized {n_emb} embeddings; "
              f"{pipe.metrics.reduce_msgs} RMIs, "
              f"{pipe.metrics.cross_part_msgs} cross-part msgs", flush=True)
    return pipe


def serve_lm(args):
    """Greedy decode of --tokens tokens for 4 random prompts from an empty
    cache of --tokens + 8 slots; prints the JAX launcher's line and returns
    (model, generated tokens [4, --tokens], seconds)."""
    import torch

    from repro_torch.configs import get_arch
    spec = get_arch(args.arch)
    build = spec.build_reduced if args.reduced else spec.build
    model = build(device=args.device)
    B = 4
    cache = model.init_cache(B, args.tokens + 8)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (B, 1)), device=model.device)
    out = []
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        logits, cache = model.decode_step(cache, tok)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    generated = torch.cat(out, dim=1).cpu() if out else torch.empty(B, 0)
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x {B} seqs in {dt:.2f}s "
          f"({B * args.tokens / dt:.1f} tok/s)")
    return model, generated, dt


def random_bag_ids(gen, shape, vocab: int):
    """Multi-hot ids [..., W] on the generator's device: each bag's length
    is uniform on 0..W, its ids uniform over [0, vocab), the rest -1."""
    import torch
    *lead, W = shape
    dev = gen.device
    lengths = torch.randint(0, W + 1, (*lead, 1), generator=gen, device=dev)
    ids = torch.randint(0, vocab, tuple(shape), generator=gen, device=dev)
    return ids.masked_fill_(torch.arange(W, device=dev) >= lengths, -1)


def serve_recsys(args):
    """Answer --requests serve_p99 requests, each a batch of 512 users
    (every field's ids drawn by random_bag_ids, seed 0), the user vectors
    copied back to the host as a server returns them. Prints one line and
    returns (model, the first request's ids, its user vectors on the host,
    per-request seconds)."""
    import torch

    from repro_torch.configs import get_arch
    spec = get_arch(args.arch)
    model = (spec.build_reduced if args.reduced else spec.build)(
        device=args.device)
    c = model.cfg
    B = spec.shapes["serve_p99"].dims["batch"]
    serve = spec.step(model, "serve_p99")
    gen = torch.Generator(device=model.device).manual_seed(0)
    cuda = model.device.type == "cuda"
    first, secs = (None, None), []
    for _ in range(args.requests):
        ids = random_bag_ids(gen, (B, c.user_fields, c.max_ids_per_field),
                             c.user_vocab)
        if cuda:
            torch.cuda.synchronize(model.device)
        t0 = time.perf_counter()
        vectors = serve({"user_ids": ids}).cpu()
        secs.append(time.perf_counter() - t0)
        if first[0] is None:
            first = (ids, vectors)
    total = sum(secs)
    p50, p99 = np.percentile(np.asarray(secs) * 1e3, [50, 99]) if secs \
        else (0.0, 0.0)
    print(f"served {args.requests} requests x {B} users in {total:.2f}s "
          f"({args.requests * B / max(total, 1e-12):.1f} users/s, p50 "
          f"{p50:.3f} ms, p99 {p99:.3f} ms per request)")
    return model, *first, secs


def parse_args(argv=None):
    from repro_torch.configs import ARCH_IDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="d3gnn-sage", choices=ARCH_IDS,
                    help="a GNN zoo arch is refused: its shapes train")
    ap.add_argument("--edges", type=int, default=2000)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=64,
                    help="two-tower: serve_p99 requests of 512 users")
    ap.add_argument("--reduced", action="store_true",
                    help="LM, two-tower: the reduced config instead of "
                         "full width")
    ap.add_argument("--driver", choices=["super", "tick"], default="super",
                    help="super: T ticks per host sync (default); "
                         "tick: per-tick reference driver")
    ap.add_argument("--tick-edges", type=int, default=256)
    ap.add_argument("--super-ticks", type=int, default=16,
                    help="micro-ticks per host sync (super driver)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--dims", default="16,64,64",
                    help="GraphSAGE widths in,hidden,...,out")
    return ap.parse_args(argv)


def main(argv=None):
    from repro_torch.configs import get_arch
    args = parse_args(argv)
    if get_arch(args.arch).family == "gnn":
        raise ValueError(
            f"{args.arch}: the GNN zoo's shapes are train shapes, and this "
            "launcher serves; train it with repro_torch.launch.train")
    if args.arch == "d3gnn-sage":
        return serve_stream(args)
    if args.arch == "two-tower-retrieval":
        return serve_recsys(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
