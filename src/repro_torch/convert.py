"""Parameter and optimizer-state conversion to and from the JAX
package's pytrees.

Torch cannot reproduce `jax.random`, so the parity tests initialise a
model with the JAX `init` (`GraphSAGE.init`, `TransformerLM.init`,
`TwoTower.init`, the graph zoo's `init`s), convert the pytree to numpy, and load it here; both
packages then compute the same function. The train steps' states go both
ways (`opt_state_from_numpy` / `opt_state_to_numpy`, `params_to_numpy`)
so a test can compare them after a step.
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


def _nest(flat: dict) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}."""
    out: dict = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return out


class LMLayout:
    """The JAX `TransformerLM.init` pytree <-> the port's flat names.

    Every leaf under "groups" is stacked [n_groups, ...] by `jax.vmap`;
    group g's block "b<j>" is layer g * len(cfg.pattern) + j, so
    "groups.b0.attn.wq"[g] maps to "blocks.<g>.attn.wq". An MoE block's
    FFN keeps JAX's names under it: "groups.b1.ffn.wg" [n_groups, E, d,
    h] gives "blocks.<2g+1>.ffn.wg" [E, d, h], and "ffn.router",
    "ffn.wu", "ffn.wd" and "ffn.shared.{wg, wu, wd}" alike. Arrays keep
    their dtype and JAX's [in, out] layout."""

    def __init__(self, cfg):
        self.cfg = cfg

    def to_port(self, tree: dict) -> dict:
        cfg = self.cfg
        out = {"embed.table": tree["embed"]["table"],
               "final_norm.scale": tree["final_norm"]["scale"],
               "lm_head": tree["lm_head"]}
        n_b = len(cfg.pattern)
        for j in range(n_b):
            for name, stacked in _flatten(tree["groups"][f"b{j}"]):
                if stacked.shape[0] != cfg.n_groups:
                    raise ValueError(f"groups.b{j}.{name} stacks "
                                     f"{stacked.shape[0]} groups, config "
                                     f"has {cfg.n_groups}")
                for g in range(cfg.n_groups):
                    out[f"blocks.{g * n_b + j}.{name}"] = stacked[g]
        return out

    def to_jax(self, flat: dict) -> dict:
        cfg, n_b = self.cfg, len(self.cfg.pattern)
        groups: dict = {}
        for name, val in flat.items():
            if not name.startswith("blocks."):
                continue
            _, i, rest = name.split(".", 2)
            g, j = divmod(int(i), n_b)
            groups.setdefault(f"b{j}.{rest}", [None] * cfg.n_groups)[g] = val
        tree = {"embed": {"table": flat["embed.table"]},
                "final_norm": {"scale": flat["final_norm.scale"]},
                "lm_head": flat["lm_head"]}
        tree["groups"] = _nest({k: np.stack(v) for k, v in groups.items()})
        return tree


class TwoTowerLayout:
    """The JAX `TwoTower.init` pytree <-> the port's flat names:
    "user_emb.table" is the user EmbeddingBag's table and
    "user_mlp.l<i>.{w, b}" is "user_mlp.layers.<i>.{w, b}"; the same for
    the item side. Arrays keep their dtype and [in, out] layout."""

    def to_port(self, tree: dict) -> dict:
        out = {}
        for side in ("user", "item"):
            out[f"{side}_emb.table"] = tree[f"{side}_emb"]["table"]
            for key, layer in tree[f"{side}_mlp"].items():
                for leaf, arr in layer.items():
                    out[f"{side}_mlp.layers.{int(key[1:])}.{leaf}"] = arr
        return out

    def to_jax(self, flat: dict) -> dict:
        tree: dict = {}
        for name, val in flat.items():
            side, rest = name.split(".", 1)
            if rest.startswith("layers."):
                _, i, leaf = rest.split(".")
                tree.setdefault(side, {}).setdefault(f"l{i}", {})[leaf] = val
            else:
                tree.setdefault(side, {})[rest] = val
        return tree


class GraphLayout:
    """The JAX pytrees of the graph zoo (PNA, GatedGCN, DimeNet, NequIP,
    GAT, GCN layers, MPLayer) <-> the port's flat names: the reference's
    list entries "l<i>" (layers, an MLP's linears) and "b<i>" (DimeNet's
    blocks) are the port's ModuleLists "layers.<i>" and "blocks.<i>";
    every other key keeps its name ("l0.pre.l0.w" is
    "layers.0.pre.layers.0.w", "b2.w_sbf" is "blocks.2.w_sbf", NequIP's
    "l1.self_l2" is "layers.1.self_l2"). Arrays keep their dtype and [in,
    out] layout."""

    _TO_PORT = {"l": "layers", "b": "blocks"}
    _TO_JAX = {v: k for k, v in _TO_PORT.items()}

    def to_port(self, tree: dict) -> dict:
        out = {}
        for name, val in _flatten(tree):
            parts = []
            for key in name.split("."):
                head, num = key[:1], key[1:]
                if head in self._TO_PORT and num.isdigit():
                    parts += [self._TO_PORT[head], num]
                else:
                    parts.append(key)
            out[".".join(parts)] = val
        return out

    def to_jax(self, flat: dict) -> dict:
        renamed = {}
        for name, val in flat.items():
            keys, parts, i = name.split("."), [], 0
            while i < len(keys):
                if keys[i] in self._TO_JAX and i + 1 < len(keys) \
                        and keys[i + 1].isdigit():
                    parts.append(self._TO_JAX[keys[i]] + keys[i + 1])
                    i += 2
                else:
                    parts.append(keys[i])
                    i += 1
            renamed[".".join(parts)] = val
        return _nest(renamed)


def _tensors(flat: dict, dtype=None, device=None) -> dict:
    return {k: torch.tensor(np.asarray(v)).to(device=device, dtype=dtype)
            for k, v in flat.items()}


def _arrays(flat: dict) -> dict:
    """Port tensors -> numpy (bf16 read as f32; nothing else cast)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in flat.items()}


def lm_params_from_numpy(tree: dict, cfg, dtype=None) -> dict:
    """JAX `TransformerLM.init` pytree (leaves numpy arrays) -> a
    `state_dict` for `repro_torch.nn.transformer.TransformerLM(cfg)`
    (`LMLayout`). dtype None casts to cfg.dtype, as a serving model
    stores them; torch.float32 keeps JAX's f32, as a model built for
    training (`train=True`) holds them."""
    flat = LMLayout(cfg).to_port(tree)
    return _tensors({k: np.asarray(v, np.float32) for k, v in flat.items()},
                    dtype or cfg.torch_dtype)


def two_tower_params_from_numpy(tree: dict) -> dict:
    """JAX `TwoTower.init` pytree (leaves numpy arrays) -> a `state_dict`
    for `repro_torch.recsys.two_tower.TwoTower` (`TwoTowerLayout`)."""
    flat = TwoTowerLayout().to_port(tree)
    return _tensors({k: np.asarray(v, np.float32) for k, v in flat.items()})


def graph_params_from_numpy(tree: dict, device=None) -> dict:
    """A JAX graph-zoo `init` pytree (leaves numpy arrays) -> a
    `state_dict` for the port's model (`GraphLayout`), f32."""
    flat = GraphLayout().to_port(tree)
    return _tensors({k: np.asarray(v, np.float32) for k, v in flat.items()},
                    device=device)


def params_to_numpy(params: dict, layout) -> dict:
    """A train step's flat params -> the JAX pytree layout, numpy."""
    return layout.to_jax(_arrays(params))


def _map_nodes(tree, fn):
    """fn over the parameter-level nodes of an adam8bit state tree (the
    dicts {"m": (q, scale), "v": (q, scale)})."""
    if set(tree) == {"m", "v"} and isinstance(tree["m"], tuple):
        return fn(tree)
    return {k: _map_nodes(v, fn) for k, v in tree.items()}


def opt_state_from_numpy(state: dict, layout, device=None) -> dict:
    """A JAX optimizer state (leaves numpy) -> the port's, over the flat
    parameter names of `layout` (LMLayout, TwoTowerLayout or
    GraphLayout).

    adam: {"m": tree, "v": tree, "t": int32} -> {"m": {name: f32}, "v":
    {name: f32}, "t": int32 tensor}. adam8bit: {"per_param": tree whose
    nodes are {"m": QState(q, scale), "v": QState(q, scale)}, "t"} ->
    {"per_param": {name: {"m": QState, "v": QState}}, "t"}; the stacked
    codes and scales of an LM group split by layer, which is how the
    per-layer state quantizes (blocks run along the last dim)."""
    from repro_torch.optim.quantized import QState
    t = torch.tensor(np.asarray(state["t"]), dtype=torch.int32,
                     device=device)
    if "per_param" not in state:
        return {"m": _tensors(layout.to_port(state["m"]), device=device),
                "v": _tensors(layout.to_port(state["v"]), device=device),
                "t": t}
    parts = {(mv, f): _tensors(layout.to_port(_map_nodes(
        state["per_param"], lambda n: n[mv][f])), device=device)
        for mv in ("m", "v") for f in (0, 1)}
    return {"per_param": {n: {mv: QState(parts[mv, 0][n], parts[mv, 1][n])
                              for mv in ("m", "v")}
                          for n in parts["m", 0]},
            "t": t}


def opt_state_to_numpy(state: dict, layout) -> dict:
    """The port's optimizer state -> JAX's pytree layout (numpy): the
    inverse of `opt_state_from_numpy`; an adam8bit state's nodes come back
    as {"m": (q, scale), "v": (q, scale)} tuples."""
    t = state["t"].cpu().numpy()
    if "per_param" not in state:
        return {"m": layout.to_jax(_arrays(state["m"])),
                "v": layout.to_jax(_arrays(state["v"])), "t": t}
    parts = [layout.to_jax(_arrays(
        {n: s[mv][f] for n, s in state["per_param"].items()}))
        for mv in ("m", "v") for f in (0, 1)]

    def join(trees):
        """Four same-shaped trees (m.q, m.scale, v.q, v.scale) -> one
        whose leaves are the parameter-level nodes."""
        if isinstance(trees[0], dict):
            return {k: join([tr[k] for tr in trees]) for k in trees[0]}
        return {"m": (trees[0], trees[1]), "v": (trees[2], trees[3])}

    return {"per_param": join(parts), "t": t}
