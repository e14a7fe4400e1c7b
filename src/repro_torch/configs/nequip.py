"""nequip [gnn]
n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5 equivariance=E(3)
tensor-product. [arXiv:2101.03164; paper]

Counterpart of `repro/configs/nequip.py`. The batch carries positions
(synthesized for the shapes without coordinates).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_common import (GNN_SHAPES, gnn_input_specs,
                                            make_gnn_train_step)
from repro_torch.graph.nequip import NequIP


def build(shape_name: str = "molecule", device=None, seed: int = 0,
          train: bool = False):
    d = GNN_SHAPES[shape_name].dims
    return NequIP(d_in=d["d_feat"], mult=32, l_max=2, n_layers=5, n_rbf=8,
                  cutoff=5.0, n_classes=d["n_classes"], seed=seed,
                  device=device)


def build_reduced(shape_name: str = "molecule", device=None, seed: int = 0,
                  train: bool = False):
    d = GNN_SHAPES[shape_name].dims
    return NequIP(d_in=16, mult=4, l_max=2, n_layers=2, n_rbf=4,
                  cutoff=5.0, n_classes=d["n_classes"], seed=seed,
                  device=device)


SPEC = ArchSpec(
    name="nequip", family="gnn",
    build=build, build_reduced=build_reduced,
    shapes=GNN_SHAPES,
    input_specs=lambda model, s: gnn_input_specs(
        GNN_SHAPES[s], needs_pos=True, needs_triplets=False),
    step=lambda model, s, optimizer=None: make_gnn_train_step(
        model, GNN_SHAPES[s], needs_triplets=False, optimizer=optimizer),
    batch_style="dict",
    notes="irrep tensor-product regime; positions synthesized for the "
          "non-molecular shapes.")
