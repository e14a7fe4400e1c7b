"""MODEL_FLOPS: the useful-work estimate per (arch x shape) cell.

Counterpart of `repro/roofline/model_flops.py`, the same closed forms:

LM     : train 6*N*D (N = params, active-params for MoE; D = tokens),
         prefill 2*N*D, decode 2*N_active*B + cache-read term
         4*B*S*L*Kh*Dh (one new token vs an S-token cache).
GNN    : closed-form message/update flops per model family x 3 for
         fwd+bwd (train shapes).
recsys : tower GEMMs + interaction x 3 for train, x 1 for serving.

The models are built on the `meta` device (shapes only, at the published
sizes: the two-tower's whole tables), so N counts the port's parameters.
The ratio MODEL_FLOPS / op FLOPs (global) says how much of the counted
compute is useful (`roofline/report.py`).
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.gnn_common import pad512
from repro_torch.nn.module import param_count

META = torch.device("meta")


def _lm_params(model, active: bool = False) -> int:
    cfg = model.cfg
    total = param_count(model)
    if not active or cfg.moe is None:
        return total
    # active params: replace the routed-expert contribution by top_k experts
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff
    n_moe_layers = cfg.n_layers // m.every
    total_experts = n_moe_layers * m.num_experts * per_expert
    active_experts = n_moe_layers * m.top_k * per_expert
    return total - total_experts + active_experts


def lm_model_flops(model, shape) -> float:
    cfg = model.cfg
    B, S = shape.dims["batch"], shape.dims["seq"]
    if shape.kind == "train":
        return 6.0 * _lm_params(model, active=True) * B * S
    if shape.kind == "prefill":
        return 2.0 * _lm_params(model, active=True) * B * S
    # decode: one token
    cache_read = 4.0 * B * S * cfg.n_layers * cfg.n_kv * cfg.head_dim
    return 2.0 * _lm_params(model, active=True) * B + cache_read


def gnn_model_flops(arch: str, model, shape) -> float:
    d = shape.dims
    N, E = pad512(d["n_nodes"]), pad512(d["n_edges"])
    if arch == "pna":
        dh = model.d_hidden
        din = model.d_in
        fwd = 0.0
        dims = [din] + [dh] * model.n_layers
        for i in range(model.n_layers):
            fwd += 2.0 * E * (2 * dims[i]) * dims[i]          # pre MLP
            fwd += 2.0 * N * (12 * dims[i] + dims[i]) * dims[i + 1]  # post
        return 3.0 * fwd
    if arch == "gatedgcn":
        dh = model.d_hidden
        fwd = 2.0 * N * model.d_in * dh                       # embed
        fwd += model.n_layers * (2.0 * 3 * E * dh * dh        # A/B/C on edges
                                 + 2.0 * 2 * N * dh * dh)     # U/V on nodes
        return 3.0 * fwd
    if arch == "nequip":
        mult = model.mult
        n_paths = 15                                           # l_max=2
        # the reference's term, kept for parity: `* n_paths / n_paths`
        # cancels, so the radial-weight share counts 2 * 64 * mult a path
        # (ROADMAP R19)
        per_edge = n_paths * (2.0 * mult * 3 * 3 * 5           # CG contract
                              + 2.0 * 64 * n_paths * mult / n_paths)
        radial = 2.0 * E * (model.n_rbf * 64 + 64 * n_paths * mult)
        self_mix = 2.0 * N * 3 * 2 * mult * mult * 3
        return 3.0 * model.n_layers * (E * per_edge + radial + self_mix)
    if arch == "dimenet":
        dh = model.d_hidden
        T = pad512(4 * E)
        per_block = (2.0 * T * model.n_bilinear * dh * dh      # bilinear
                     + 2.0 * E * dh * dh * 3)                  # msg/out MLPs
        embed = 2.0 * E * (2 * dh + model.n_radial) * dh
        return 3.0 * (model.n_blocks * per_block + embed)
    raise KeyError(arch)


def recsys_model_flops(model, shape) -> float:
    c = model.cfg
    d = shape.dims
    B = d["batch"]

    def tower(fields):
        dims = [c.embed_dim * fields] + list(c.tower_mlp)
        return sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))

    if shape.name == "train_batch":
        fwd = B * (tower(c.user_fields) + tower(c.item_fields))
        fwd += 2.0 * B * B * c.tower_mlp[-1]        # in-batch logits
        return 3.0 * fwd
    if shape.name == "serve_p99":
        return B * tower(c.user_fields)
    if shape.name == "serve_bulk":
        return B * (tower(c.user_fields) + tower(c.item_fields)
                    + 2.0 * c.tower_mlp[-1])
    nc = -(-d["n_candidates"] // 512) * 512
    return (d["batch"] * tower(c.user_fields) + nc * tower(c.item_fields)
            + 2.0 * d["batch"] * nc * c.tower_mlp[-1])


def model_flops(arch: str, shape_name: str) -> float:
    spec = get_arch(arch)
    shape = spec.shapes[shape_name]
    if spec.family == "gnn":
        return gnn_model_flops(arch, spec.build(shape_name, device=META),
                               shape)
    if spec.family == "lm":
        return lm_model_flops(spec.build(device=META), shape)
    if spec.family == "recsys":
        return recsys_model_flops(spec.build(device=META), shape)
    return float("nan")
