"""Training launcher: ``--arch <id> --shape <shape>`` end to end.

Counterpart of `repro/launch/train.py`, with the same flags plus
--device. ``--reduced`` runs the same code path on the reduced config
and synthetic data; without it the published config is built for
training (`spec.build(train=True)`, the two-tower tables cut as
configs/two_tower_retrieval.py says; a GNN's for the shape,
`spec.build(shape)`). The weights are random (torch.Generator, seed 0)
and the data synthetic (numpy, seed 0): the LM draws uniform tokens (2 x
64 reduced, the shape's batch x seq otherwise) and its step takes them
as one batch (`lm_step` at grad_accum 1), as the reference's LM branch
does; the other families take `synth_batch`. Every family trains through
`spec.step` with `spec.optimizer`. Each step prints "step i: loss=...
(...s)", as the reference's does.

`synth_batch` departs from the reference's in two places, both faults
of the reference (ROADMAP R14, R15), and nowhere else:
  * R14: every integer input is drawn below the count it indexes. The
    reference draws all of them on [0, 100): class labels past
    n_classes (7 at full_graph_sm) read NaN from its take_along_axis,
    so its GNN losses are NaN. Here labels are drawn on [0, min(100,
    n_classes)), node ids on [0, min(100, N)), edge ids on [0, min(100,
    E)), graph ids on [0, min(100, n_graphs)): the same draws as the
    reference's wherever its range fits;
  * R15: the reduced batch is built at the reduced sizes. The reference
    cuts every first dim 64x and keeps the full shape's widths: x at the
    shape's d_feat (1,433 at full_graph_sm) against the reduced model's
    d_in 16 (a TypeError in its first matmul), and at `molecule` the
    per-graph targets at 2 rows against the step's 128 graphs. Here x
    has the model's d_in and per-graph inputs keep n_graphs rows.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mistral-nemo-12b --shape train_4k --steps 3 --reduced
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch moonshot-v1-16b-a3b --shape train_4k --steps 3 --reduced
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch two-tower-retrieval --shape train_batch --steps 3 \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gatedgcn --shape full_graph_sm --steps 2

Without --device it runs on CUDA and raises when none is present.
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch


# integer inputs of a GNN batch and the input whose first dim they index
_INDEXES = {"senders": "x", "receivers": "x", "t_kj": "senders",
            "t_ji": "senders", "graph_ids": "targets"}


def synth_batch(spec, model, shape_name: str, reduced: bool, rng, device):
    """Synthetic inputs matching input_specs (the batch dim cut 64x when
    reduced): masks and flags ones, floats standard normal, ids uniform
    on [0, 100) cut to the range they index; the reference's draws, in its
    order, but for the two repairs of the module docstring."""
    specs = spec.input_specs(model, shape_name)
    scale = 64 if reduced else 1
    dims = spec.shapes[shape_name].dims
    shapes = {}
    for k, (shape, _) in specs.items():
        shp = tuple(max(1, d // scale) if i == 0 else d
                    for i, d in enumerate(shape))
        if reduced and k == "x" and spec.family == "gnn":
            shp = (shp[0], model.d_in)
        if k == "targets":
            shp = tuple(shape)          # one row a graph of the step's
        shapes[k] = shp

    def hi(k):
        if k == "labels":
            return min(100, dims["n_classes"])
        if k in _INDEXES:
            return min(100, shapes[_INDEXES[k]][0])
        return 100

    def mk(k, shp, dtype):
        if "mask" in k or dtype == torch.bool:
            return torch.ones(shp, dtype=dtype, device=device)
        if dtype in (torch.int32, torch.int64):
            return torch.as_tensor(rng.integers(0, hi(k), shp), dtype=dtype,
                                   device=device)
        return torch.as_tensor(rng.normal(size=shp), dtype=dtype,
                               device=device)

    return {k: mk(k, shapes[k], dtype) for k, (_, dtype) in specs.items()}


def main(argv=None):
    """Returns (model, params, opt_state, losses) for tests and scripts."""
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.configs.base import make_optimizer
    from repro_torch.device import resolve_device
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.nn.module import bind_params, param_tree

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without it)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    shape = spec.shapes[args.shape]
    if shape.kind != "train":
        raise ValueError(f"{args.arch}: {args.shape} is a {shape.kind} "
                         "shape, not a train shape")
    device = resolve_device(args.device)
    build = spec.build_reduced if args.reduced else spec.build
    if spec.family == "gnn":
        build = functools.partial(build, args.shape)
    model = build(device=device, seed=0, train=True)
    params = param_tree(model)
    opt = make_optimizer(spec.optimizer)
    opt_state = opt.init(params)
    lm = spec.family == "lm"
    step = spec.step(model, args.shape, optimizer=opt,
                     **({"grad_accum": 1} if lm else {}))
    rng = np.random.default_rng(0)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    losses = []

    for i in range(args.steps):
        t0 = time.perf_counter()
        if lm:
            B, S = (2, 64) if args.reduced else (
                shape.dims["batch"], shape.dims["seq"])
            toks = rng.integers(0, model.cfg.vocab, (B, S))
            toks = torch.as_tensor(toks, device=device)
            batch = (toks, torch.roll(toks, -1, 1))
        else:
            batch = (synth_batch(spec, model, args.shape, args.reduced, rng,
                                 device),)
        params, opt_state, loss = step(params, opt_state, *batch)
        bind_params(model, params)        # release the step's old tensors
        loss = float(loss)
        dt = time.perf_counter() - t0
        losses.append(loss)
        print(f"step {i}: loss={loss:.4f} ({dt:.2f}s)")
        if mgr:
            mgr.save(i, {"params": params, "opt": opt_state})
    print("train driver done")
    return model, params, opt_state, losses


if __name__ == "__main__":
    main()
