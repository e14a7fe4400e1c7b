"""Arch-zoo driver: run any assigned architecture (reduced config) with
``--arch <id>`` — one forward / loss / decode per family, the same
selectable-config path the dry run takes at full scale.

Counterpart of `examples/arch_zoo.py`, with the same flag plus --device:

    PYTHONPATH=src python -m repro_torch.examples.arch_zoo --arch gatedgcn
    PYTHONPATH=src python -m repro_torch.examples.arch_zoo \\
        --arch mistral-nemo-12b --device cpu

On the card the LMs' attention runs kernel 5 (`csrc/flash_attention.cu`),
the two-tower's bags kernel 4 (`csrc/embedding_bag.cu`) and the GNNs'
aggregations kernel 1 (`csrc/segment_reduce.cu`). The inputs are drawn
from seeded generators (JAX draws them with `jax.random`, which torch
cannot reproduce); `run` takes them, with the parameters, from a caller.
"""
from __future__ import annotations

import argparse
from dataclasses import fields

import numpy as np
import torch

from repro_torch.examples import Say, add_device_args


def _on(g, device):
    """The graph with every tensor on `device`."""
    return g.replace(**{f.name: getattr(g, f.name).to(device)
                        for f in fields(g)
                        if isinstance(getattr(g, f.name), torch.Tensor)})


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def run_lm(spec, say, device, params=None, inputs=None):
    """inputs: {"tokens": [2, 16] int64} (default: seed 1)."""
    model = spec.build_reduced(device=device, seed=0)
    if params is not None:
        model.load_state_dict(params)
    if inputs is None:
        gen = torch.Generator().manual_seed(1)
        inputs = {"tokens": torch.randint(0, model.cfg.vocab, (2, 16),
                                          generator=gen)}
    toks = inputs["tokens"].to(model.device)
    with torch.no_grad():
        loss = model.loss(toks, torch.roll(toks, -1, 1))
    cache = model.init_cache(2, 24)
    logits, cache = model.decode_step(cache, toks[:, :1])
    say.keep("loss", float(loss))
    say(f"  train loss={float(loss):.3f}  decode logits "
        f"{tuple(logits.shape)}")


def run_gnn(spec, say, device, params=None, inputs=None):
    """inputs: {"graph": a 64-node Graph, and for DimeNet "triplets":
    (t_kj, t_ji, t_mask)} (default: erdos_graph from seed 1)."""
    from repro_torch.graph.graphs import erdos_graph
    model = spec.build_reduced("full_graph_sm", device=device, seed=0)
    if params is not None:
        model.load_state_dict(params)
    g = (inputs["graph"] if inputs is not None else
         erdos_graph(np.random.default_rng(1), 64, 256, 16, with_pos=True))
    g = _on(g, _device_of(model))
    with torch.no_grad():
        if spec.name == "dimenet":
            if inputs is not None:
                trip = inputs["triplets"]
            else:
                from repro_torch.graph.triplets import build_triplets
                trip = [torch.as_tensor(np.asarray(a)) for a in
                        build_triplets(g.senders.cpu().numpy(),
                                       g.receivers.cpu().numpy(), 64, 1024)]
            out = model(g, *(t.to(g.x.device) for t in trip))
        else:
            out = model(g)
    say.keep("out", out.float().cpu().numpy())
    say(f"  forward out {tuple(out.shape)}, "
        f"finite={bool(torch.all(torch.isfinite(out)))}")


def run_recsys(spec, say, device, params=None, inputs=None):
    """inputs: {"users": [8, uf, w], "items": [8, if, w]} ids in [-1, 100)
    (default: seeds 1 and 2)."""
    model = spec.build_reduced(device=device, seed=0)
    if params is not None:
        model.load_state_dict(params)
    c = model.cfg
    if inputs is None:
        inputs = {
            "users": torch.randint(-1, 100, (8, c.user_fields,
                                             c.max_ids_per_field),
                                   generator=torch.Generator().manual_seed(1)),
            "items": torch.randint(-1, 100, (8, c.item_fields,
                                             c.max_ids_per_field),
                                   generator=torch.Generator().manual_seed(2))}
    u = inputs["users"].to(model.device)
    i = inputs["items"].to(model.device)
    with torch.no_grad():
        loss = float(model.loss(u, i))
        scores = model.retrieval_scores(u[:1], i)
    say.keep("loss", loss)
    say(f"  in-batch loss={loss:.3f}  retrieval {tuple(scores.shape)}")


FAMILIES = {"lm": run_lm, "gnn": run_gnn, "recsys": run_recsys}


def parse_args(argv=None):
    from repro_torch.configs import CELL_ARCH_IDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    choices=["all"] + list(CELL_ARCH_IDS))
    add_device_args(ap)
    return ap.parse_args(argv)


def run(args, params=None, inputs=None) -> Say:
    """Every --arch in the JAX example's order, on one device. params /
    inputs: {arch: state_dict} / {arch: inputs as each family's runner
    takes them}; an arch left out draws its own."""
    from repro_torch.configs import CELL_ARCH_IDS, get_arch
    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    say = Say()
    archs = CELL_ARCH_IDS if args.arch == "all" else [args.arch]
    for a in archs:
        spec = get_arch(a)
        say(f"== {a} [{spec.family}] ==")
        FAMILIES[spec.family](spec, say, device, (params or {}).get(a),
                              (inputs or {}).get(a))
    return say


def main(argv=None) -> Say:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
