"""DimeNet — directional message passing (arXiv:2003.03123).

Counterpart of `repro/graph/dimenet.py`. Assigned config: n_blocks=6,
d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6. Messages live on
directed edges m_ji; interaction blocks aggregate over triplets
(k->j->i):

    m_ji' = W m_ji + sum_k  a_SBF(r_kj, angle_kji) (x) W_bilinear (x) m_kj

The 2D spherical basis is factorized as bessel(r) x cos(l * angle), l =
0..n_spherical-1, as the reference's (scipy-free; same shapes and flops).
Triplet indices come from graph/triplets.py, capped and masked.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph
from repro_torch.graph.nequip import bessel_basis, per_graph_sum
from repro_torch.graph.sage import output_loss
from repro_torch.nn.initializers import lecun_normal, normal
from repro_torch.nn.layers import MLP, Linear


def angular_basis(cos_angle, n_spherical: int):
    """cos(l * theta) via the Chebyshev recurrence, [T, n_spherical].
    cos_angle is clipped to [-1, 1] by maximum and minimum, whose
    gradient splits at a tie as jnp.clip's does (padded triplets sit at
    -1 exactly)."""
    one = torch.ones((), dtype=cos_angle.dtype, device=cos_angle.device)
    c = torch.minimum(torch.maximum(cos_angle, -one), one)
    outs = [torch.ones_like(c), c]
    for _ in range(2, n_spherical):
        outs.append(2 * c * outs[-1] - outs[-2])
    return torch.stack(outs[:n_spherical], dim=-1)


class DimeNetBlock(nn.Module):
    def __init__(self, d_hidden: int, n_radial: int, n_spherical: int,
                 n_bilinear: int, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        d, nb = d_hidden, n_bilinear
        self.w_msg = Linear(d, d, generator=generator, device=device)
        self.w_kj = Linear(d, d, use_bias=False, generator=generator,
                           device=device)
        self.w_sbf = nn.Parameter(lecun_normal((n_radial * n_spherical, nb),
                                               generator, device))
        # bilinear tensor [n_bilinear, d, d]
        self.bilinear = nn.Parameter(normal(1.0 / d)((nb, d, d), generator,
                                                     device))
        self.mlp_out = MLP((d, d, d), act=F.silu, generator=generator,
                           device=device)

    def forward(self, m, sbf, t_kj, t_ji, t_mask, n_edges: int):
        """m: [E, d] edge messages; sbf: [T, n_rad*n_sph]; t_*: [T]."""
        m_kj = self.w_kj(m)[t_kj]                               # [T, d]
        a = sbf @ self.w_sbf                                    # [T, nb]
        # sum_b a[t, b] * (m_kj[t] @ bilinear[b]), as one [T, nb*d] matmul
        nb, d, f = self.bilinear.shape
        inter = (a[:, :, None] * m_kj[:, None, :]).reshape(-1, nb * d) \
            @ self.bilinear.reshape(nb * d, f)                  # [T, d]
        agg = segment.segment_sum(inter, t_ji, n_edges, t_mask)  # [E, d]
        h = self.w_msg(m) + agg
        return m + self.mlp_out(F.silu(h))


class DimeNet(nn.Module):
    """Energy per graph [n_graphs] (n_classes 0) or per-node logits;
    forward(g, t_kj, t_ji, t_mask). Runs on `device` (CUDA unless given,
    raising without it)."""

    def __init__(self, d_in: int, d_hidden: int = 128, n_blocks: int = 6,
                 n_bilinear: int = 8, n_spherical: int = 7,
                 n_radial: int = 6, cutoff: float = 5.0, n_classes: int = 0,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = d_hidden
        self.d_in, self.n_classes, self.cutoff = d_in, n_classes, cutoff
        self.n_radial, self.n_spherical = n_radial, n_spherical
        self.d_hidden, self.n_blocks = d, n_blocks
        self.n_bilinear = n_bilinear
        self.embed_x = Linear(d_in, d, generator=gen, device=dev)
        self.embed_m = MLP((2 * d + n_radial, d), act=F.silu, generator=gen,
                           device=dev)
        self.blocks = nn.ModuleList(
            DimeNetBlock(d, n_radial, n_spherical, n_bilinear, gen, dev)
            for _ in range(n_blocks))
        self.readout = MLP((d, d, n_classes or 1), act=F.silu, generator=gen,
                           device=dev)

    def _geometry(self, g: Graph, t_kj, t_ji):
        vec = g.pos[g.receivers] - g.pos[g.senders]             # edge j->i
        r = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
        rbf = bessel_basis(r, self.n_radial, self.cutoff)       # [E, n_rad]
        # angle between edge (k->j) and edge (j->i): vectors -v_kj and v_ji
        v_ji, v_kj = vec[t_ji], vec[t_kj]
        cos_a = torch.sum(v_ji * (-v_kj), dim=-1) / (
            torch.linalg.vector_norm(v_ji + 1e-9, dim=-1)
            * torch.linalg.vector_norm(v_kj + 1e-9, dim=-1))
        ang = angular_basis(cos_a, self.n_spherical)            # [T, n_sph]
        sbf = (rbf[t_kj][:, :, None] * ang[:, None, :]).reshape(
            t_kj.shape[0], self.n_radial * self.n_spherical)
        return rbf, sbf

    def edge_messages(self, g: Graph, t_kj, t_ji, t_mask):
        if g.pos is None:
            raise ValueError("DimeNet needs positions (g.pos)")
        rbf, sbf = self._geometry(g, t_kj, t_ji)
        x = self.embed_x(g.x)
        m = self.embed_m(torch.cat([x[g.senders], x[g.receivers], rbf],
                                   dim=-1))                     # [E, d]
        if g.edge_mask is not None:
            m = torch.where(g.edge_mask[:, None], m, 0.0)
        for block in self.blocks:
            m = block(m, sbf, t_kj, t_ji, t_mask, g.n_edges)
        return m

    def forward(self, g: Graph, t_kj, t_ji, t_mask):
        m = self.edge_messages(g, t_kj, t_ji, t_mask)
        node_h = segment.segment_sum(m, g.receivers, g.n_nodes, g.edge_mask)
        out = self.readout(node_h)
        if self.n_classes:
            return out
        return per_graph_sum(out[..., 0], g)

    def loss(self, g: Graph, targets, t_kj, t_ji, t_mask):
        """Cross-entropy over (labels, label_mask) targets with classes,
        else the energies' MSE (JAX's `loss`)."""
        return output_loss(self(g, t_kj, t_ji, t_mask), targets,
                           self.n_classes)
