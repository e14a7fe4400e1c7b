"""pna [gnn]
n_layers=4 d_hidden=75 aggregators=mean-max-min-std scalers=id-amp-atten.
[arXiv:2004.05718; paper]

Counterpart of `repro/configs/pna.py`: the published config for a shape
(`avg_log_deg` from the shape's mean degree), a reduced one, and the
steps: node classification, or at `molecule` the node outputs summed per
graph as the energy.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_common import (GNN_SHAPES, gnn_input_specs,
                                            make_node_task_step)
from repro_torch.graph.pna import PNA


def _avg_log_deg(shape_name: str) -> float:
    d = GNN_SHAPES[shape_name].dims
    return float(np.log(1.0 + d["n_edges"] / max(d["n_nodes"], 1)))


def build(shape_name: str = "full_graph_sm", device=None, seed: int = 0,
          train: bool = False):
    d = GNN_SHAPES[shape_name].dims
    return PNA(d_in=d["d_feat"], d_hidden=75, n_layers=4,
               n_classes=d["n_classes"] or 1,
               avg_log_deg=_avg_log_deg(shape_name), seed=seed, device=device)


def build_reduced(shape_name: str = "full_graph_sm", device=None,
                  seed: int = 0, train: bool = False):
    d = GNN_SHAPES[shape_name].dims
    return PNA(d_in=16, d_hidden=16, n_layers=2,
               n_classes=d["n_classes"] or 1, avg_log_deg=1.0, seed=seed,
               device=device)


SPEC = ArchSpec(
    name="pna", family="gnn",
    build=build, build_reduced=build_reduced,
    shapes=GNN_SHAPES,
    input_specs=lambda model, s: gnn_input_specs(
        GNN_SHAPES[s], needs_pos=False, needs_triplets=False),
    step=make_node_task_step,
    batch_style="dict",
    notes="multi-aggregator SpMM regime; all four aggregators are synopses "
          "(std via (sum, sum_sq, n)).")
