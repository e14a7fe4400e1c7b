"""NequIP — E(3)-equivariant interatomic potential (arXiv:2101.03164).

Counterpart of `repro/graph/nequip.py`. Assigned config: n_layers=5,
d_hidden(mult)=32, l_max=2, n_rbf=8, cutoff=5.

  * node features are direct sums of irreps: {l: [N, mult, 2l+1]};
  * each interaction layer computes, per edge, radially weighted
    Clebsch-Gordan tensor products between sender features (l_in) and
    the edge's real spherical harmonics (l_f), summed into each allowed
    l_out, and aggregates them at receivers with segment_sum;
  * update = self-interaction linear (per-l channel mixing) + gated
    nonlinearity (scalars: silu; l>0: sigmoid gates from the scalars).

A path's product contracts the harmonics with the coupling tensor first
([E, 2l_in+1, 2l_out+1]), then each edge's channels with that (a batched
matmul), instead of one three-operand einsum.
"""
from __future__ import annotations

from math import sqrt
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph
from repro_torch.graph.sage import output_loss
from repro_torch.graph.so3 import coupling_tensor, real_sph_harm
from repro_torch.nn.initializers import lecun_normal
from repro_torch.nn.layers import MLP, Linear


def poly_envelope(x, p: int = 6):
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    env = 1 + a * x ** p + b * x ** (p + 1) + c * x ** (p + 2)
    return torch.where(x < 1.0, env, torch.zeros((), dtype=env.dtype,
                                                 device=env.device))


def bessel_basis(r, n_rbf: int, cutoff: float):
    """sqrt(2/c) sin(n pi r / c) / r with the smooth polynomial envelope
    (p=6), n = 1..n_rbf: [..., n_rbf]."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    r = torch.clamp(r, min=1e-6)
    b = sqrt(2.0 / cutoff) * torch.sin(n * np.pi * r[..., None] / cutoff) \
        / r[..., None]
    return b * poly_envelope(r / cutoff, p=6)[..., None]


def allowed_paths(l_max: int):
    """(l_in, l_f, l_out) with |l_in - l_f| <= l_out <= min(l_max, l_in +
    l_f): 15 paths at l_max 2."""
    paths = []
    for l_in in range(l_max + 1):
        for l_f in range(l_max + 1):
            for l_out in range(abs(l_in - l_f), min(l_max, l_in + l_f) + 1):
                paths.append((l_in, l_f, l_out))
    return tuple(paths)


class NequIPLayer(nn.Module):
    def __init__(self, mult: int, l_max: int, n_rbf: int,
                 avg_degree: float = 8.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.mult, self.l_max, self.avg_degree = mult, l_max, avg_degree
        self.paths = allowed_paths(l_max)
        # radial net: rbf -> hidden -> per-path per-channel weights
        self.radial = MLP((n_rbf, 64, len(self.paths) * mult), act=F.silu,
                          generator=generator, device=device)
        for l in range(l_max + 1):
            for kind in ("self", "mix"):
                setattr(self, f"{kind}_l{l}", nn.Parameter(lecun_normal(
                    (mult, mult), generator, device)))
        # gates for l>0 generated from scalars
        self.gate = nn.Parameter(lecun_normal((mult, l_max * mult),
                                              generator, device))
        for p, (l_in, l_f, l_out) in enumerate(self.paths):
            self.register_buffer(f"cg{p}", torch.as_tensor(
                coupling_tensor(l_in, l_f, l_out), dtype=torch.float32,
                device=device), persistent=False)

    def forward(self, g: Graph, feats: dict, sh: dict, rbf):
        """feats: {l: [N, mult, 2l+1]}; sh: {l: [E, 2l+1]}; rbf: [E, n_rbf]."""
        E, N = g.n_edges, g.n_nodes
        R = self.radial(rbf).reshape(E, len(self.paths), self.mult)
        agg = {l: torch.zeros_like(v) for l, v in feats.items()}
        norm = 1.0 / sqrt(self.avg_degree)
        for p, (l_in, l_f, l_out) in enumerate(self.paths):
            W = getattr(self, f"cg{p}").to(feats[l_in].dtype)
            xs = feats[l_in][g.senders]                        # [E, c, i]
            shw = torch.einsum("ej,ijk->eik", sh[l_f], W)       # [E, i, k]
            msg = torch.bmm(xs, shw) * R[:, p, :, None]         # [E, c, k]
            agg[l_out] = agg[l_out] + segment.segment_sum(
                msg, g.receivers, N, g.edge_mask) * norm
        new = {l: torch.einsum("ncx,cd->ndx", feats[l],
                               getattr(self, f"self_l{l}"))
               + torch.einsum("ncx,cd->ndx", agg[l],
                              getattr(self, f"mix_l{l}"))
               for l in range(self.l_max + 1)}
        scal = new[0][..., 0]                                   # [N, mult]
        gates = torch.sigmoid(scal @ self.gate)                 # [N, l_max*m]
        out = {0: F.silu(scal)[..., None]}
        for l in range(1, self.l_max + 1):
            gl = gates[:, (l - 1) * self.mult: l * self.mult]
            out[l] = new[l] * gl[..., None]
        return out


def per_graph_sum(e_node, g: Graph):
    """Node values [N] masked by node_mask and summed per graph [n_graphs]
    (every node in graph 0 when the graph has no graph_ids)."""
    if g.node_mask is not None:
        e_node = torch.where(g.node_mask, e_node, 0.0)
    gids = g.graph_ids if g.graph_ids is not None else torch.zeros(
        g.n_nodes, dtype=torch.int64, device=e_node.device)
    return segment.segment_sum(e_node, gids, g.n_graphs)


class NequIP(nn.Module):
    """Energy per graph [n_graphs] (n_classes 0) or per-node logits [N,
    n_classes]; runs on `device` (CUDA unless given, raising without
    it)."""

    def __init__(self, d_in: int, mult: int = 32, l_max: int = 2,
                 n_layers: int = 5, n_rbf: int = 8, cutoff: float = 5.0,
                 n_classes: int = 0, avg_degree: float = 8.0, seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        self.d_in, self.mult, self.l_max = d_in, mult, l_max
        self.n_rbf, self.cutoff, self.n_classes = n_rbf, cutoff, n_classes
        self.n_layers = n_layers
        self.embed = Linear(d_in, mult, generator=gen, device=dev)
        self.layers = nn.ModuleList(
            NequIPLayer(mult, l_max, n_rbf, avg_degree, gen, dev)
            for _ in range(n_layers))
        self.readout = MLP((mult, mult, n_classes or 1), act=F.silu,
                           generator=gen, device=dev)

    def node_features(self, g: Graph) -> dict:
        if g.pos is None:
            raise ValueError("NequIP needs positions (g.pos)")
        vec = g.pos[g.receivers] - g.pos[g.senders]
        r = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
        sh = real_sph_harm(vec, self.l_max)
        rbf = bessel_basis(r, self.n_rbf, self.cutoff)
        if g.edge_mask is not None:
            rbf = torch.where(g.edge_mask[:, None], rbf, 0.0)
        feats = {0: self.embed(g.x)[..., None]}
        for l in range(1, self.l_max + 1):
            feats[l] = torch.zeros((g.n_nodes, self.mult, 2 * l + 1),
                                   dtype=g.x.dtype, device=g.x.device)
        for layer in self.layers:
            feats = layer(g, feats, sh, rbf)
        return feats

    def forward(self, g: Graph):
        out = self.readout(self.node_features(g)[0][..., 0])
        if self.n_classes:
            return out                                      # [N, n_classes]
        return per_graph_sum(out[..., 0], g)

    def loss(self, g: Graph, targets, *_):
        """MSE energy loss (molecule shapes) or CE over (labels,
        label_mask) targets (node classification): JAX's `loss`."""
        return output_loss(self(g), targets, self.n_classes)
