"""Parameter conversion from the JAX package's pytrees.

Torch cannot reproduce `jax.random`, so the parity tests initialise a
model with the JAX `init` (`GraphSAGE.init`, `TransformerLM.init`,
`TwoTower.init`),
convert the pytree to numpy, and load it here; both packages then compute
the same function.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree: dict) -> dict:
    """JAX `GraphSAGE.init` pytree (leaves already numpy arrays) -> a
    `state_dict` for `repro_torch.graph.sage.GraphSAGE`.

    {"l0": {"self": {"w", "b"}, "neigh": {"w"}}, ...} maps to
    "layers.0.w_self.w", "layers.0.w_self.b", "layers.0.w_neigh.w", ...,
    and the classification head {"head": {"w", "b"}} to "head.w",
    "head.b". Weights keep JAX's [in, out] layout (nn/layers.py), so
    nothing is transposed."""
    out = {}
    for key, layer in tree.items():
        if key == "head":
            for leaf, arr in layer.items():
                out[f"head.{leaf}"] = torch.tensor(np.asarray(arr,
                                                              np.float32))
            continue
        if not key.startswith("l"):
            raise ValueError(f"parameter group {key!r}: expected l<i> or "
                             "head")
        i = int(key[1:])
        for jax_name, port_name in (("self", "w_self"), ("neigh", "w_neigh")):
            for leaf, arr in layer[jax_name].items():
                out[f"layers.{i}.{port_name}.{leaf}"] = torch.tensor(
                    np.asarray(arr, np.float32))
    return out


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def lm_params_from_numpy(tree: dict, cfg) -> dict:
    """JAX `TransformerLM.init` pytree (leaves numpy arrays) -> a
    `state_dict` for `repro_torch.nn.transformer.TransformerLM(cfg)`.

    Every leaf under "groups" is stacked [n_groups, ...] by `jax.vmap`;
    group g's block "b<j>" becomes layer g * len(cfg.pattern) + j, so
    "groups.b0.attn.wq"[g] maps to "blocks.<g>.attn.wq". Weights keep JAX's
    [in, out] layout and are cast to cfg.dtype, as the port stores them."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE blocks are not ported (ROADMAP "
                                  "Queue 1 item 14)")
    dtype = cfg.torch_dtype
    as_t = lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype)
    out = {"embed.table": as_t(tree["embed"]["table"]),
           "final_norm.scale": as_t(tree["final_norm"]["scale"]),
           "lm_head": as_t(tree["lm_head"])}
    n_b = len(cfg.pattern)
    for j in range(n_b):
        for name, stacked in _flatten(tree["groups"][f"b{j}"]):
            if stacked.shape[0] != cfg.n_groups:
                raise ValueError(f"groups.b{j}.{name} stacks "
                                 f"{stacked.shape[0]} groups, config has "
                                 f"{cfg.n_groups}")
            for g in range(cfg.n_groups):
                out[f"blocks.{g * n_b + j}.{name}"] = as_t(stacked[g])
    return out


def two_tower_params_from_numpy(tree: dict) -> dict:
    """JAX `TwoTower.init` pytree (leaves numpy arrays) -> a `state_dict`
    for `repro_torch.recsys.two_tower.TwoTower`.

    "user_emb.table" maps to the user EmbeddingBag's table and
    "user_mlp.l<i>.{w, b}" to "user_mlp.layers.<i>.{w, b}"; the same for
    the item side. Weights keep JAX's [in, out] layout: nothing is
    transposed."""
    out = {}
    for side in ("user", "item"):
        out[f"{side}_emb.table"] = torch.tensor(
            np.asarray(tree[f"{side}_emb"]["table"], np.float32))
        for key, layer in tree[f"{side}_mlp"].items():
            for leaf, arr in layer.items():
                out[f"{side}_mlp.layers.{int(key[1:])}.{leaf}"] = \
                    torch.tensor(np.asarray(arr, np.float32))
    return out
