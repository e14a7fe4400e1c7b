"""Generic MPGNN layer — the paper's §3.3 formulation.

Counterpart of `repro/graph/mp.py`:

    m_e  = phi(x_u, x_v, x_e)        per incoming edge (u -> v)
    a_v  = rho({m_e})                permutation-invariant aggregation
    x_v' = psi(x_v, a_v)             update

`rho` names a synopsis (sum / mean / max / min) of graph/segment.py.
"""
from __future__ import annotations

from torch import nn

from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph

AGGREGATORS = {
    "sum": segment.segment_sum,
    "mean": segment.segment_mean,
    "max": segment.segment_max,
    "min": segment.segment_min,
}


class MPLayer(nn.Module):
    """phi(x_u, x_v, x_e) -> messages and psi(x_v, a_v) -> x_v' are
    sub-modules (parameters "phi.*", "psi.*"); rho by name."""

    def __init__(self, phi: nn.Module, psi: nn.Module, rho: str = "mean"):
        super().__init__()
        if rho not in AGGREGATORS:
            raise ValueError(f"rho must be one of {sorted(AGGREGATORS)}, got "
                             f"{rho!r}")
        self.phi, self.psi, self.rho = phi, psi, rho

    def forward(self, g: Graph, x):
        m = self.phi(x[g.senders], x[g.receivers], g.edge_attr)
        agg = AGGREGATORS[self.rho](m, g.receivers, g.n_nodes, g.edge_mask)
        return self.psi(x, agg)
