"""Step variants of the three hillclimb cells, on one rank of the mesh.

Counterpart of `repro/perf/variants.py`. Each builder takes the
production mesh (`launch/mesh.make_production_mesh`) and returns
{"step", "args" (meta tensors), "shardings", "donate", "baseline",
"mesh", "split", "dtype"}: `perf/run.py` runs step(*args) once under the analyzer
on the `meta` device. The reference compiles each variant as one SPMD
program over 256 or 512 chips; the port has one process a rank. Where a
variant exchanges between ranks ("split" "rank": the locality steps, EP)
it is rank 0's step as that rank runs it, its collectives on a
`dist/dry_mesh.CountingMesh` ("mesh", counted as a real StreamMesh
counts them); else ("split" "ideal") it is the global step, divided over
the mesh as the dry run divides a cell. "shardings" records the
reference's layout of each argument as specs (`dist/sharding.py`);
"dtype" is the step's compute dtype (its peak FLOP rate).

An LM builder also takes `groups` (layer groups, None: the published
depth) and `micro` (microbatches, None: the variant's own) and returns
"repeat" = {"layer_groups", "microbatches"} at the published values, so
the runner traces probes and extrapolates (`roofline/analysis.
extrapolate`) instead of tracing 48 layers x 8 microbatches on meta.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import lm_step
from repro_torch.dist.dry_mesh import CountingMesh
from repro_torch.dist.gnn_locality import make_locality_train_step
from repro_torch.dist.sharding import (FAMILY_INPUT_RULES, FAMILY_PARAM_RULES,
                                       spec_tree)
from repro_torch.graph.pna import PNA
from repro_torch.launch.mesh import all_axes, data_axes
from repro_torch.nn.module import param_tree
from repro_torch.optim import adam

META = torch.device("meta")


def _empty(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# =====================================================================
# Cell A: pna x ogb_products: most collective-bound GNN, most
# representative of the paper (vertex-cut locality IS the contribution).
# =====================================================================
def _pna_locality(mesh, r_cap_per_pair: int, local_update: bool = False,
                  compute_dtype=None):
    axes = all_axes(mesh)                  # all axes = one shard grid
    S = int(mesh.size)
    N = 2449408                            # padded ogb_products nodes
    E = 61859328                           # padded edges
    d_feat, ncls = 100, 47
    n_loc = N // S
    e_cap = -(-int(E // S * 1.3) // 512) * 512
    model = PNA(d_feat, d_hidden=75, n_layers=4, n_classes=ncls,
                avg_log_deg=3.2, device=META)
    params = param_tree(model)
    opt_state = adam().init(params)
    rank_mesh = CountingMesh(S)
    step = make_locality_train_step(model, ncls, rank_mesh,
                                    local_update=local_update,
                                    compute_dtype=compute_dtype)
    i64, b = torch.int64, torch.bool
    batch = {                               # rank 0's block
        "x": _empty((n_loc, d_feat)),
        "labels": _empty((n_loc,), i64),
        "label_mask": _empty((n_loc,), b),
        "senders": _empty((e_cap,), i64),
        "receivers": _empty((e_cap,), i64),
        "edge_mask": _empty((e_cap,), b),
        "send_idx": _empty((S, r_cap_per_pair), i64),
        "send_mask": _empty((S, r_cap_per_pair), b),
    }
    return {"step": step, "args": (params, opt_state, batch),
            "shardings": {"params": (), "opt_state": (),
                          "batch": {k: (axes,) for k in batch}},
            "donate": (), "baseline": "pna__ogb_products",
            "mesh": rank_mesh, "split": "rank",
            "dtype": compute_dtype or torch.float32}


def pna_ogb_locality(mesh):
    """Iteration 2: vertex-cut halo exchange, HDRF-budget replicas
    (r_cap=512 rows per shard pair ~= replication factor ~7 on the
    power-law co-purchase graph)."""
    return _pna_locality(mesh, r_cap_per_pair=512)


def pna_ogb_locality_local(mesh):
    """Iteration 3: + update-MLP restricted to owned rows (halo rows only
    feed messages): removes the 14x post-MLP overcompute of iteration 2."""
    return _pna_locality(mesh, r_cap_per_pair=512, local_update=True)


def pna_ogb_locality_bf16(mesh):
    """Iteration 4: + bf16 features/messages (f32 loss & params): the
    memory term is message-traffic-dominated, so halving message bytes
    should halve it."""
    return _pna_locality(mesh, r_cap_per_pair=512, local_update=True,
                         compute_dtype=torch.bfloat16)


def pna_ogb_locality_tight(mesh):
    """Iteration 5: halo budget down to r_cap=128/pair (total halo 3.4x
    owned rows ~= HDRF replication factor ~4): wire and memory cost scale
    with S * r_cap."""
    return _pna_locality(mesh, r_cap_per_pair=128, local_update=True,
                         compute_dtype=torch.bfloat16)


def pna_ogb_locality_fat(mesh):
    """Ablation: 4x fatter halo budget (r_cap=2048): tests sensitivity of
    the collective term to partition quality."""
    return _pna_locality(mesh, r_cap_per_pair=2048)


# =====================================================================
# Cell B: mistral-large x decode_32k: memory-bound serving with bf16
# serving weights. The reference's comment also names a scatter cache
# update as a hypothesis; its builder does not build one, nor does this
# (ROADMAP R20).
# =====================================================================
def _lm(arch: str, mesh, groups, train: bool):
    spec = get_arch(arch)
    model = spec.build(device=META, train=train)
    G = model.cfg.n_groups
    if groups is not None:
        model = type(model)(replace(model.cfg, n_layers=groups * len(
            model.cfg.pattern)), META, 0, train)
    return spec, spec.tune_for_mesh(model, mesh), G


def mistral_decode_bf16(mesh, groups=None, micro=None):
    """The decode step with bf16 serving weights. The reference's
    baseline holds f32 parameters and this variant casts them; the
    port's serving build stores cfg.dtype (bf16) already, so this is
    the step its decode_32k dry-run cell traces."""
    spec, model, G = _lm("mistral-large-123b", mesh, groups, train=False)
    params = param_tree(model)
    step = spec.step(model, "decode_32k")
    inputs = {k: _empty(shp, dt) for k, (shp, dt) in
              spec.input_specs(model, "decode_32k").items()}
    S = spec.shapes["decode_32k"].dims["seq"]
    rule = FAMILY_PARAM_RULES["lm"]
    return {"step": step, "args": (*inputs.values(), S - 1),
            "shardings": {
                "params": spec_tree(params, rule, mesh),
                "inputs": FAMILY_INPUT_RULES["lm"](inputs, mesh, "decode")},
            "donate": ("cache_k", "cache_v"),
            "baseline": "mistral-large-123b__decode_32k", "mesh": None,
            "split": "ideal", "dtype": model.cfg.torch_dtype,
            "repeat": {"layer_groups": G, "microbatches": 1}}


# =====================================================================
# Cell C: moonshot x train_4k: most collective-bound LM (fine-grained
# MoE, top-6 of 64 experts every layer). Hypotheses: (1) fewer
# grad-accum steps => fewer weight re-gathers, (2) explicit all_to_all
# expert parallelism.
# =====================================================================
def _moonshot_train(mesh, accum: int, groups, micro, ep: bool = False):
    """Without EP the global step (the published batch in `accum`
    microbatches), divided over the mesh as the dry run's cell is (an
    ideal split); with EP rank 0's step as it runs: its data shard's
    tokens (the microbatch / the data axes' extent), all of the dense
    weights and 1 / |model| of every MoE layer's experts, dispatched over
    a CountingMesh of the "model" axis."""
    arch, shape_name = "moonshot-v1-16b-a3b", "train_4k"
    spec, model, G = _lm(arch, mesh, groups, train=True)
    rank_mesh = None
    dims = spec.shapes[shape_name].dims
    B, S = dims["batch"], dims["seq"]
    n_micro = accum if micro is None else micro
    m = B // accum                                 # one microbatch's seqs
    if ep:
        rank_mesh = CountingMesh(mesh.shape["model"])
        moe = replace(model.cfg.moe, ep_axis=("model",))
        model = type(model)(replace(model.cfg, moe=moe), META, 0, True)
        for blk in model.blocks:
            if blk.kind == "moe":
                blk.ffn.ep_mesh = rank_mesh
        n_data = 1
        for a in data_axes(mesh):
            n_data *= mesh.shape[a]
        m = max(1, m // n_data)                    # this rank's data shard
    step = lm_step(model, shape_name, grad_accum=n_micro)
    params = param_tree(model)
    opt_state = adam().init(params)
    inputs = {k: _empty((n_micro * m, S), dt) for k, (_, dt) in
              spec.input_specs(model, shape_name).items()}
    rule = FAMILY_PARAM_RULES["lm"]
    return {"step": step,
            "args": (params, opt_state, *inputs.values()),
            "shardings": {
                "params": spec_tree(params, rule, mesh),
                "opt_state": spec_tree(opt_state, rule, mesh),
                "inputs": FAMILY_INPUT_RULES["lm"](inputs, mesh, "train")},
            "donate": ("params", "opt_state"),
            "baseline": "moonshot-v1-16b-a3b__train_4k", "mesh": rank_mesh,
            "split": "rank" if ep else "ideal",
            "dtype": model.cfg.torch_dtype,
            "repeat": {"layer_groups": G, "microbatches": accum}}


def moonshot_train_accum2(mesh, groups=None, micro=None):
    return _moonshot_train(mesh, 2, groups, micro)


def moonshot_train_accum1(mesh, groups=None, micro=None):
    return _moonshot_train(mesh, 1, groups, micro)


def moonshot_train_ep(mesh, groups=None, micro=None):
    """Cell C iteration 2: explicit all_to_all expert parallelism over the
    "model" axis (`dist/moe_ep.py:moe_ep_apply`), 8 microbatches."""
    return _moonshot_train(mesh, 8, groups, micro, ep=True)


VARIANTS = ("pna_ogb_locality", "pna_ogb_locality_local",
            "pna_ogb_locality_bf16", "pna_ogb_locality_tight",
            "pna_ogb_locality_fat", "mistral_decode_bf16",
            "moonshot_train_accum2", "moonshot_train_accum1",
            "moonshot_train_ep")
