"""gatedgcn [gnn]
n_layers=16 d_hidden=70 aggregator=gated. [arXiv:2003.00982; paper]

Counterpart of `repro/configs/gatedgcn.py`: node classification, or at
`molecule` the node outputs summed per graph as the energy.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_common import (GNN_SHAPES, gnn_input_specs,
                                            make_node_task_step)
from repro_torch.graph.gatedgcn import GatedGCN


def build(shape_name: str = "full_graph_sm", device=None, seed: int = 0,
          train: bool = False):
    d = GNN_SHAPES[shape_name].dims
    return GatedGCN(d_in=d["d_feat"], d_hidden=70, n_layers=16,
                    n_classes=d["n_classes"] or 1, seed=seed, device=device)


def build_reduced(shape_name: str = "full_graph_sm", device=None,
                  seed: int = 0, train: bool = False):
    d = GNN_SHAPES[shape_name].dims
    return GatedGCN(d_in=16, d_hidden=16, n_layers=3,
                    n_classes=d["n_classes"] or 1, seed=seed, device=device)


SPEC = ArchSpec(
    name="gatedgcn", family="gnn",
    build=build, build_reduced=build_reduced,
    shapes=GNN_SHAPES,
    input_specs=lambda model, s: gnn_input_specs(
        GNN_SHAPES[s], needs_pos=False, needs_triplets=False),
    step=make_node_task_step,
    batch_style="dict",
    notes="edge-featured MPNN with gated aggregation; LayerNorm replaces "
          "BatchNorm for streaming compatibility.")
