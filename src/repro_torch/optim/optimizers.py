"""Optimizers as (init, update) pairs over parameter trees.

Counterpart of `repro/optim/optimizers.py`. A tree is a tensor or a dict
(or tuple) of trees; `tree_map` / `tree_leaves` walk dicts in sorted key
order, as `jax.tree` does. update(state, grads, params, lr) ->
(updates, new_state); the caller applies `params + updates`
(`apply_updates`). Optimizer state is kept in f32.

The training plane runs one optimizer per logical part over a leading
[P] axis (JAX `vmap`s it). Every update here is elementwise, so the same
functions take stacked [P, ...] leaves: `init_stacked` gives the
per-part state (step counters [P]) and the bias corrections broadcast a
counter against its leaf's leading axes (`_lead`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """fn over the leaves of same-structured trees (dicts, tuples and
    NamedTuples are nodes; anything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in `jax.tree.leaves` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def init_stacked(opt: Optimizer, params, n: int):
    """`vmap(opt.init)` over params broadcast to a leading [n] axis: the
    param-shaped state leaves get the axis, the 0-d counters become [n]."""
    stacked = tree_map(lambda p: p.expand((n,) + tuple(p.shape)).clone(),
                       params)
    return tree_map(lambda s: s.expand(n).clone() if s.ndim == 0 else s,
                    opt.init(stacked))


def _lead(x, leaf):
    """A per-part (or 0-d) scalar x shaped to broadcast against leaf."""
    return x.reshape(tuple(x.shape) + (1,) * (leaf.ndim - x.ndim))


def _f32(tree):
    return tree_map(lambda x: x.to(torch.float32), tree)


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(_zeros, params)}

    def update(state, grads, params, lr):
        g = _f32(grads)
        if momentum == 0.0:
            return tree_map(lambda gi: -lr * gi, g), state
        mu = tree_map(lambda m, gi: momentum * m + gi, state["mu"], g)
        if nesterov:
            upd = tree_map(lambda m, gi: -lr * (momentum * m + gi), mu, g)
        else:
            upd = tree_map(lambda m: -lr * m, mu)
        return upd, {"mu": mu}

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(state, grads, params, lr):
        g = _f32(grads)
        t = state["t"] + 1
        m = tree_map(lambda mi, gi: b1 * mi + (1 - b1) * gi, state["m"], g)
        v = tree_map(lambda vi, gi: b2 * vi + (1 - b2) * gi * gi,
                     state["v"], g)
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def upd(mi, vi, pi):
            step = (mi / _lead(bc1, mi)) / (torch.sqrt(vi / _lead(bc2, vi))
                                            + eps)
            if weight_decay:
                step = step + weight_decay * pi.to(torch.float32)
            return (-lr * step).to(pi.dtype)

        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adamax(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"m": tree_map(_zeros, params), "u": tree_map(_zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(state, grads, params, lr):
        g = _f32(grads)
        t = state["t"] + 1
        m = tree_map(lambda mi, gi: b1 * mi + (1 - b1) * gi, state["m"], g)
        u = tree_map(lambda ui, gi: torch.maximum(b2 * ui, torch.abs(gi)),
                     state["u"], g)
        bc1 = 1 - b1 ** t.to(torch.float32)
        upd = tree_map(
            lambda mi, ui, pi: (-lr * (mi / _lead(bc1, mi)) / (ui + eps)
                                ).to(pi.dtype), m, u, params)
        return upd, {"m": m, "u": u, "t": t}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                        for x in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), grads), gn


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
