"""Dry run of the port: trace every (arch x shape x mesh) cell's step.

Counterpart of `repro/launch/dryrun.py`, which lowers and compiles each
cell with XLA for a 256- or 512-chip TPU mesh. PyTorch has no SPMD
partitioner, so a cell here:

  * builds the published model on the `meta` device (shapes, no data;
    `spec.tune_for_mesh` applied), and the step's inputs from
    `spec.input_specs`;
  * sizes one device's parameters, optimizer state and inputs under the
    family rules at the production mesh (`dist/sharding.py`,
    `launch/mesh.make_production_mesh`);
  * runs the step once under `roofline/op_analyzer.OpCounter`: a shape
    that does not fit fails the cell, as a failed compile does in JAX.
    The global dot FLOPs and bytes are divided by the mesh's size, an
    IDEAL split (the JSON says so): GSPMD's redundancy and collectives
    have no counterpart, so `collective_gb` is None.

An LM's layers repeat one group (`cfg.pattern`) and its train step sums
`GRAD_ACCUM` identical microbatches; the JAX analyzer multiplies a scan's
body by its trip count. Here the LM step is traced at 1 and 2 layer
groups (and 1 and 2 microbatches) and the counts extrapolated, exactly
(they are bilinear in both), to the published depth and microbatch
count; the JSON records the probes.

`--device cuda` instead runs one real step of a cell that fits one card
(CARD_CELLS: published widths; a cut only where 80 GB forces it, listed
under "reduced"), after a warm-up step: first_call_s (in place of
compile_s), step_s, peak_memory_gb and the analyzer's counts of a third,
counted call. The d3gnn-sage tick runs on live records
(`configs/d3gnn_sage.steady_tick`; their counts under "load", the rows
the tick emitted under "emitted").

Results: results/dryrun_torch/<arch>__<shape>__<mesh>.json (mesh
"single", "multi", or "card").

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch nequip --shape molecule
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--include-extra]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape prefill_32k --device cuda
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from repro_torch.configs import all_cells, d3gnn_sage, get_arch
from repro_torch.configs.base import GRAD_ACCUM, lm_step, make_optimizer
from repro_torch.configs.two_tower_retrieval import ONE_CARD_USER_VOCAB
from repro_torch.dist.sharding import (FAMILY_INPUT_RULES, FAMILY_PARAM_RULES,
                                       spec_tree, tree_bytes_per_device)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn.module import param_tree
from repro_torch.optim.optimizers import tree_map
from repro_torch.roofline.analysis import (HBM_BW, analyze_step, counts_of,
                                           extrapolate, peak_flops,
                                           roofline_terms)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
SPLIT = ("ideal: the global counts / n_devices (no partitioner: GSPMD's "
         "redundancy and collectives have no counterpart)")
# cells one card runs at their published widths: {name: (published, cut)}
# for each thing 80 GB forces down
CARD_CELLS = {
    ("mistral-nemo-12b", "prefill_32k"): {"batch": (32, 1)},
    ("two-tower-retrieval", "serve_p99"): {
        "user_vocab": (100_000_256, ONE_CARD_USER_VOCAB)},
    ("d3gnn-sage", "stream_tick"): {"n_parts": (1024, 512)},
}


def _needs_opt(spec, shape) -> bool:
    return shape.kind == "train" and spec.family != "d3gnn"


def _build(spec, shape_name: str, device, train: bool):
    if spec.family == "gnn":
        return spec.build(shape_name, device=device, train=train)
    if spec.family == "d3gnn":
        return spec.build(device=device)
    return spec.build(device=device, train=train)


def _alloc(specs, fill):
    """A tree of {name: (shape, dtype)} specs -> tensors, fill(name,
    shape, dtype) making each."""
    return {k: _alloc(v, fill) if isinstance(v, dict) else fill(k, *v)
            for k, v in specs.items()}


def _meta(name, shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _card_fill(model, device, gen):
    """Inputs on the card: token and id inputs drawn below their vocab
    from a seeded generator, the rest zeros."""
    cfg = getattr(model, "cfg", None)
    vocab = {"tokens": getattr(cfg, "vocab", None),
             "labels": getattr(cfg, "vocab", None),
             "user_ids": getattr(cfg, "user_vocab", None),
             "item_ids": getattr(cfg, "item_vocab", None),
             "cand_ids": getattr(cfg, "item_vocab", None)}

    def fill(name, shape, dtype):
        if vocab.get(name):
            return torch.randint(0, vocab[name], shape, generator=gen,
                                 device=device).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=device)

    return fill


def _call(spec, shape, step, params, opt_state, inputs):
    """Run the port's step of the cell with its calling convention."""
    lead = (params, opt_state) if _needs_opt(spec, shape) else ()
    if spec.batch_style == "dict":
        return step(*lead, inputs)
    args = [inputs[k] for k in inputs]
    if spec.family == "lm" and shape.kind == "decode":
        args.append(shape.dims["seq"] - 1)      # the host cache position
    return step(*lead, *args)


def _state(spec, shape, model):
    params = param_tree(model)
    opt = (make_optimizer(spec.optimizer).init(params)
           if _needs_opt(spec, shape) else None)
    return params, opt


def _counts(spec, shape, model, step, inputs, dtype) -> dict:
    params, opt = _state(spec, shape, model)
    return counts_of(analyze_step(
        lambda: _call(spec, shape, step, params, opt, inputs),
        compute_dtype=dtype))


def _lm_probe(spec, shape_name, model, mesh, groups, micro):
    """Counts of the LM step at `groups` layer groups and `micro`
    microbatches of the published microbatch (train), on meta."""
    cfg = model.cfg
    shape = spec.shapes[shape_name]
    train = shape.kind == "train"
    probe = type(model)(replace(cfg, n_layers=groups * len(cfg.pattern)),
                        "meta", 0, train)
    probe = spec.tune_for_mesh(probe, mesh)
    specs = spec.input_specs(probe, shape_name)
    if train:
        B, S = shape.dims["batch"], shape.dims["seq"]
        specs = {k: ((micro * B // accum_steps(B), S), dt)
                 for k, (_, dt) in specs.items()}
        step = lm_step(probe, shape_name, grad_accum=micro,
                       opt_name=spec.optimizer)
    else:
        step = spec.step(probe, shape_name)
    return _counts(spec, shape, probe, step, _alloc(specs, _meta),
                   cfg.torch_dtype)


def accum_steps(batch: int) -> int:
    """The microbatches `lm_step` sums at the default GRAD_ACCUM."""
    return GRAD_ACCUM if batch % GRAD_ACCUM == 0 else 1


def _lm_extrapolated(spec, shape_name, model, mesh):
    """The LM step's counts at the published depth and microbatches, from
    probes at 1 and 2 of each (`roofline/analysis.extrapolate`)."""
    shape = spec.shapes[shape_name]
    K = accum_steps(shape.dims["batch"]) if shape.kind == "train" else 1
    return extrapolate(
        lambda g, k: _lm_probe(spec, shape_name, model, mesh, g, k),
        model.cfg.n_groups, K)


def _result_from_counts(counts, n_dev, dtype) -> dict:
    """Per-device keys of the JAX dry run's JSON from global counts."""
    flops, nbytes = counts["flops"] / n_dev, counts["bytes"] / n_dev
    out = {"op_gflops": flops / 1e9, "op_bytes_gb": nbytes / 2 ** 30,
           "op_masked_gflops": counts["masked_flops"] / n_dev / 1e9,
           "op_flops_global": counts["flops"],
           "op_bytes_global": counts["bytes"],
           "kernels": {k: {"calls": v[0], "gflops": v[1] / 1e9,
                           "gb": v[2] / 2 ** 30}
                       for k, v in counts["kernels"].items()},
           "peak_flops": peak_flops(dtype)}
    out.update(roofline_terms(flops, nbytes, None,
                              peak_flops=out["peak_flops"], hbm_bw=HBM_BW))
    return out


def _compute_dtype(spec, model):
    return model.cfg.torch_dtype if spec.family == "lm" else torch.float32


def _meta_cell(spec, arch_id, shape_name, mesh, donate) -> dict:
    shape = spec.shapes[shape_name]
    t0 = time.perf_counter()
    model = _build(spec, shape_name, "meta", shape.kind == "train")
    model = spec.tune_for_mesh(model, mesh)
    in_specs = spec.input_specs(model, shape_name)
    inputs = _alloc(in_specs, _meta)
    params, opt = _state(spec, shape, model)
    rule = FAMILY_PARAM_RULES[spec.family]
    param_b = tree_bytes_per_device(params, spec_tree(params, rule, mesh),
                                    mesh)
    opt_b = 0 if opt is None else tree_bytes_per_device(
        opt, spec_tree(opt, rule, mesh), mesh)
    in_sh = FAMILY_INPUT_RULES[spec.family](inputs, mesh, shape.kind)
    input_b = tree_bytes_per_device(inputs, in_sh, mesh)
    dtype = _compute_dtype(spec, model)
    result = {"param_gb_per_device": param_b / 2 ** 30,
              "opt_state_gb_per_device": opt_b / 2 ** 30,
              "input_gb_per_device": input_b / 2 ** 30,
              "argument_gb": (param_b + opt_b + input_b) / 2 ** 30,
              "input_shapes": tree_map(lambda t: list(t.shape), inputs),
              "input_sharding": in_sh,
              "donated": list(spec.donate_inputs(shape_name)) if donate
              else []}
    if getattr(model, "act_pspec", None) is not None:
        result["act_pspec"] = model.act_pspec
    if spec.family == "lm":
        counts, result["extrapolated"] = _lm_extrapolated(
            spec, shape_name, model, mesh)
    else:
        counts = _counts(spec, shape, model, spec.step(model, shape_name),
                         inputs, dtype)
    result["trace_s"] = time.perf_counter() - t0
    result.update(_result_from_counts(counts, mesh.size, dtype))
    result.update(peak_memory_gb=None, collective_gb=None,
                  collective_counts={}, collective_bytes_by_kind={},
                  split=SPLIT)
    return result


def _card_cell(spec, arch_id, shape_name, device, seed=0) -> dict:
    """One real step of a CARD_CELLS cell on the card: a warm-up call
    (first_call_s), a timed call (step_s, peak_memory_gb), a counted
    call (the analyzer's counts)."""
    cut = CARD_CELLS[(arch_id, shape_name)]
    shape = spec.shapes[shape_name]
    model = _build(spec, shape_name, device, shape.kind == "train")
    step = spec.step(model, shape_name)
    kw = {"n_parts": cut["n_parts"][1]} if "n_parts" in cut else {}
    in_specs = spec.input_specs(model, shape_name, **kw)
    if "batch" in cut:       # the serve steps take any batch
        in_specs = {k: ((cut["batch"][1],) + tuple(shp[1:]), dt)
                    for k, (shp, dt) in in_specs.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    if spec.family == "d3gnn":
        inputs = d3gnn_sage.steady_tick(model, in_specs, device, gen)
    else:
        inputs = _alloc(in_specs, _card_fill(model, device, gen))
    params, opt = _state(spec, shape, model)
    dtype = _compute_dtype(spec, model)

    def run():
        with torch.no_grad():
            return _call(spec, shape, step, params, opt, inputs)

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize(device)
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    emitted = int(out[2].valid.sum()) if spec.family == "d3gnn" else None
    del out
    r = analyze_step(run, compute_dtype=dtype, device=device)
    result = _result_from_counts(counts_of(r), 1, dtype)
    bound = max(result["t_compute_s"], result["t_memory_s"])
    result.update(first_call_s=first, step_s=step_s, peak_memory_gb=peak,
                  counted_call_s=r["step_s"],
                  roofline_fraction_measured=bound / step_s,
                  reduced={k: {"published": a, "run": b}
                           for k, (a, b) in cut.items()},
                  card=torch.cuda.get_device_name(device),
                  collective_gb=None, collective_counts={},
                  collective_bytes_by_kind={})
    if spec.family == "d3gnn":
        result["load"] = {
            "inbox_rows": int(inputs["inbox"]["valid"].sum()),
            "new_edges": int(inputs["eb"]["valid"].sum()),
            "live_edges": int(inputs["topo"]["e_valid"].sum()),
            "replicas": int(inputs["topo"]["r_valid"].sum()),
            "pending": int(inputs["state0"]["red_pending"].sum())}
        result["emitted"] = emitted
    return result


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             save: bool = True, donate: bool = True,
             device="meta") -> dict:
    """One cell: on "meta" at the production mesh (multi_pod picks it),
    on "cuda" one real step of a CARD_CELLS cell (the mesh is not
    read). Returns the result dict (written as JSON when `save`)."""
    spec = get_arch(arch_id)
    dev = torch.device(device)
    if dev.type == "cuda":
        if (arch_id, shape_name) not in CARD_CELLS:
            raise ValueError(f"{arch_id} x {shape_name} is not a one-card "
                             f"cell; those are {sorted(CARD_CELLS)}")
        mesh_name, n_dev = "card", 1
        result = _card_cell(spec, arch_id, shape_name, dev)
    elif dev.type == "meta":
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name, n_dev = ("multi" if multi_pod else "single"), mesh.size
        result = _meta_cell(spec, arch_id, shape_name, mesh, donate)
    else:
        raise ValueError(f"device {device!r}: meta or cuda")
    result = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
              "n_devices": n_dev, "device": dev.type, **result}
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out = RESULTS_DIR / f"{arch_id}__{shape_name}__{mesh_name}.json"
        out.write_text(json.dumps(result, indent=1, default=str))
    return result


def ok_line(tag: str, r: dict) -> str:
    """JAX's [ok] line: compile= is the trace (meta) or the first call
    (card)."""
    t = r.get("trace_s", r.get("first_call_s"))
    num = lambda x: "n/a" if x is None else f"{x:.3f}"
    return (f"[ok] {tag}: compile={t:.2f}s "
            f"peak/dev={num(r['peak_memory_gb'])}GB "
            f"flops={r['op_gflops']:.3f}G "
            f"coll={num(r['collective_gb'])}GB "
            f"bound={r['bottleneck']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-extra", action="store_true",
                    help="also run the d3gnn-sage streaming cell")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: trace at the production mesh; cuda: one "
                         "real step of each one-card cell")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells(include_extra=args.include_extra)
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        spec = get_arch(args.arch)
        shapes = [args.shape] if args.shape else list(spec.shapes)
        cells = [(args.arch, s) for s in shapes]
    if args.device == "cuda":
        cells = [c for c in cells if c in CARD_CELLS]
        meshes = {"card": False}
    else:
        meshes = {"single": False, "multi": True}
        if args.mesh != "both":
            meshes = {args.mesh: meshes[args.mesh]}

    failures = []
    for arch_id, shape_name in cells:
        for mesh_name, multi in meshes.items():
            tag = f"{arch_id} x {shape_name} x {mesh_name}"
            out = RESULTS_DIR / f"{arch_id}__{shape_name}__{mesh_name}.json"
            if args.skip_existing and out.exists():
                print(f"[skip] {tag}")
                continue
            try:
                r = run_cell(arch_id, shape_name, multi, device=args.device)
                print(ok_line(tag, r))
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nall dry-run cells traced.")


if __name__ == "__main__":
    main()
