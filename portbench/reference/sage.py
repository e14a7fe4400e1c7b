"""Plain reference of GraphSAGE-mean and of D3-GNN's online training step,
in float64 PyTorch by default. Imports nothing of the program.

Semantics (D3-GNN, arXiv:2409.09079 §4; Hamilton et al. 2017):

  layer:  h_v' = relu(h_v @ W_self + b + mean_{(u -> v) in E} h_u @ W_neigh)
          over the edge multiset, the mean 0 for a vertex with no in-edge;
          the last layer without the relu unless a head follows it;
  head:   logits = h_v @ W_head + b_head, masked-mean cross-entropy over
          the step's labeled vertices.

A training step (the online plane's Algorithm 3, at a quiescent state
whose caches hold the embeddings of the weights the stream ran with):
the loss and the gradients through the cached layer inputs at the
current weights; per part p of the vertices' masters, the layer
gradients summed over that part's vertices, error-feedback top-k int8
compressed, and one Adam step per part; the layers move by the mean of
the parts' updates, the head by one Adam step on its whole gradient.

`precision="tf32"` is the control: float32 with every matmul operand
rounded to TF32's 10-bit mantissa, the step below the configuration's
float32 with TF32 off.
"""
from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32: 10 mantissa bits, to nearest."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"precision {name!r}: float64 or tf32")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a, b):
        if self.name == "tf32":
            return tf32(a) @ tf32(b)
        return a @ b

    def cast(self, tree):
        if isinstance(tree, dict):
            return {k: self.cast(v) for k, v in tree.items()}
        return tree.to(self.dtype)


def neighbour_sum(h, src, dst, n):
    """(sum over in-edges (multiset) of h[src] at dst, in-edge count)."""
    agg = torch.zeros((n, h.shape[1]), dtype=h.dtype, device=h.device)
    agg.index_add_(0, dst, h[src])
    cnt = torch.zeros(n, dtype=h.dtype, device=h.device)
    cnt.index_add_(0, dst, torch.ones_like(dst, dtype=h.dtype))
    return agg, cnt


def neighbour_mean(h, src, dst, n):
    """mean over in-edges (multiset) of h[src] at dst; 0 with none."""
    agg, cnt = neighbour_sum(h, src, dst, n)
    return agg / torch.clamp(cnt, min=1.0)[:, None], cnt


def layer(pr: Precision, p, h, mean, act=True):
    z = (pr.mm(h, p["self"]["w"]) + p["self"]["b"]
         + pr.mm(mean, p["neigh"]["w"]))
    return (torch.relu(z) if act else z), z


def forward(x, src, dst, weights, precision: str = "float64"):
    """Every layer's output over vertices 0..n-1 (x [n, d_in]; src, dst
    the edges' endpoints in that index). Returns (outputs, caches) with
    caches[l] = (input, neighbour mean, in-edge count) of layer l."""
    pr = Precision(precision)
    h = x.to(pr.dtype)
    n = h.shape[0]
    outs, caches = [], []
    n_layers = len([k for k in weights if k.startswith("l")])
    for l in range(n_layers):
        mean, cnt = neighbour_mean(h, src, dst, n)
        caches.append((h, mean, cnt))
        act = l < n_layers - 1 or "head" in weights
        h, _ = layer(pr, pr.cast(weights[f"l{l}"]), h, mean, act)
        outs.append(h)
    return outs, caches


# ------------------------------------------------------------- training
def _ce(pr, head, h, rows, labels):
    logits = pr.mm(h[rows], head["w"]) + head["b"]
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None])[:, 0].mean()
    dlogits = torch.softmax(logits, dim=-1)
    dlogits[torch.arange(len(rows), device=h.device), labels] -= 1.0
    return loss, dlogits / len(rows)


def _by_part(pr, a, b, part, n_parts):
    """[P, a_cols, b_cols]: sum over the rows of each part of a_v^T b_v."""
    out = torch.zeros((n_parts, a.shape[1], b.shape[1]), dtype=pr.dtype,
                      device=a.device)
    live = torch.nonzero((b != 0).any(1))[:, 0]
    for p in torch.unique(part[live]).tolist():
        rows = live[part[live] == p]
        out[p] = pr.mm(a[rows].T, b[rows])
    return out


def grads(pr, params, caches, out_last, src, dst, part, n_parts, rows,
          labels):
    """(loss, per-part layer grads {l: {self: {w, b}, neigh: {w}}} with
    a leading [P] axis, head grads) of one step over the cached inputs."""
    loss, dlogits = _ce(pr, params["head"], out_last, rows, labels)
    head = {"w": pr.mm(out_last[rows].T, dlogits), "b": dlogits.sum(0)}
    n = out_last.shape[0]
    g = torch.zeros_like(out_last)
    g[rows] = pr.mm(dlogits, params["head"]["w"].T)
    part_grads = {}
    for l in reversed(range(len(caches))):
        p = params[f"l{l}"]
        h, mean, cnt = caches[l]
        _, z = layer(pr, p, h, mean)
        delta = torch.where(z > 0, g, 0.0)
        bias = torch.zeros((n_parts, delta.shape[1]), dtype=pr.dtype,
                           device=h.device)
        bias.index_add_(0, part, delta)
        part_grads[f"l{l}"] = {
            "self": {"w": _by_part(pr, h, delta, part, n_parts), "b": bias},
            "neigh": {"w": _by_part(pr, mean, delta, part, n_parts)}}
        if l:
            dagg = pr.mm(delta, p["neigh"]["w"].T) / torch.clamp(
                cnt, min=1.0)[:, None]
            g = pr.mm(delta, p["self"]["w"].T)
            g.index_add_(0, src, dagg[dst])
    return loss, part_grads, head


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def compress(acc, topk_frac):
    """Per part (leading axis): keep the values at or above the k-th
    largest magnitude, round them to int8 at scale max|kept| / 127
    (half to even). Returns (sent, residual)."""
    flat = acc.reshape(acc.shape[0], -1)
    k = max(1, int(flat.shape[1] * topk_frac))
    thresh = torch.topk(flat.abs(), k, dim=1).values[:, -1:]
    mask = flat.abs() >= thresh
    kept = torch.where(mask, flat, 0.0)
    scale = torch.clamp(kept.abs().amax(1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(kept / scale), -127, 127)
    sent = torch.where(mask, q * scale, 0.0)
    return sent.reshape(acc.shape), (flat - sent).reshape(acc.shape)


class Adam:
    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def step(self, state, g):
        """state {m, v, t}; returns (update, new state)."""
        t = state["t"] + 1
        m = self.b1 * state["m"] + (1 - self.b1) * g
        v = self.b2 * state["v"] + (1 - self.b2) * g * g
        upd = -self.lr * (m / (1 - self.b1 ** t)) / (
            torch.sqrt(v / (1 - self.b2 ** t)) + self.eps)
        return upd, {"m": m, "v": v, "t": t}


def train_steps(weights, caches, out_last, src, dst, part, n_parts, steps,
                train, precision: str = "float64"):
    """Follow `steps` [(rows, labels), ...] fired steps from `weights`
    over the fixed caches. train: {"lr", "topk_frac", "compression"}.
    Returns {"loss": [per step], "sent1": the first step's gradients as
    the optimizer gets them ({l: per-part tree, "head": tree}),
    "params": the weights after the steps, "last_grad": the last step's
    gradients summed over the parts, before compression}."""
    pr = Precision(precision)
    params = pr.cast(weights)
    caches = [tuple(t.to(pr.dtype) for t in c) for c in caches]
    out_last = out_last.to(pr.dtype)
    opt = Adam(train["lr"])
    zeros = lambda x: torch.zeros_like(x)
    state, residual = {}, {}
    losses, sent1 = [], None
    for i, (rows, labels) in enumerate(steps):
        loss, pg, hg = grads(pr, params, caches, out_last, src, dst, part,
                             n_parts, rows, labels)
        losses.append(float(loss))
        if not state:
            for name, tree in pg.items():
                state[name] = {"m": _map(zeros, tree), "v": _map(zeros, tree),
                               "t": 0}
                residual[name] = _map(zeros, tree)
            state["head"] = {"m": _map(zeros, hg), "v": _map(zeros, hg),
                             "t": 0}
        sent_all = {}
        for name, tree in pg.items():
            if train["compression"]:
                pairs = _map(lambda g, r: compress(g + r, train["topk_frac"]),
                             tree, residual[name])
                sent = _map(lambda pair: pair[0], pairs)
                residual[name] = _map(lambda pair: pair[1], pairs)
            else:
                sent = tree
            sent_all[name] = sent
            upd, state[name] = _adam_tree(opt, state[name], sent)
            params[name] = _map(lambda p, u: p + u.sum(0) / n_parts,
                                params[name], upd)
        sent_all["head"] = hg
        last = dict(_map(lambda g: g.sum(0), pg), head=hg)
        upd, state["head"] = _adam_tree(opt, state["head"], hg)
        params["head"] = _map(lambda p, u: p + u, params["head"], upd)
        if i == 0:
            sent1 = sent_all
    return {"loss": losses, "sent1": sent1, "params": params,
            "last_grad": last}


def _adam_tree(opt, state, g):
    t = state["t"]
    upd, m, v = {}, {}, {}
    out = _map(lambda mi, vi, gi: opt.step({"m": mi, "v": vi, "t": t}, gi),
               state["m"], state["v"], g)
    upd = _map(lambda o: o[0], out)
    m = _map(lambda o: o[1]["m"], out)
    v = _map(lambda o: o[1]["v"], out)
    return upd, {"m": m, "v": v, "t": t + 1}
