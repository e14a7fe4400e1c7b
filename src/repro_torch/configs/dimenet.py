"""dimenet [gnn]
n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7 n_radial=6.
[arXiv:2003.03123; unverified]

Counterpart of `repro/configs/dimenet.py`. The batch carries positions
and triplets capped at T_FACTOR x the edge capacity.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_common import (GNN_SHAPES, gnn_input_specs,
                                            make_gnn_train_step)
from repro_torch.graph.dimenet import DimeNet

# triplet cap = 4 x n_edges (static-shape bound; graph/triplets.py masks)
T_FACTOR = 4


def build(shape_name: str = "molecule", device=None, seed: int = 0,
          train: bool = False):
    d = GNN_SHAPES[shape_name].dims
    return DimeNet(d_in=d["d_feat"], d_hidden=128, n_blocks=6, n_bilinear=8,
                   n_spherical=7, n_radial=6, n_classes=d["n_classes"],
                   seed=seed, device=device)


def build_reduced(shape_name: str = "molecule", device=None, seed: int = 0,
                  train: bool = False):
    d = GNN_SHAPES[shape_name].dims
    return DimeNet(d_in=16, d_hidden=16, n_blocks=2, n_bilinear=4,
                   n_spherical=4, n_radial=4, n_classes=d["n_classes"],
                   seed=seed, device=device)


SPEC = ArchSpec(
    name="dimenet", family="gnn",
    build=build, build_reduced=build_reduced,
    shapes=GNN_SHAPES,
    input_specs=lambda model, s: gnn_input_specs(
        GNN_SHAPES[s], needs_pos=True, needs_triplets=True,
        t_factor=T_FACTOR),
    step=lambda model, s, optimizer=None: make_gnn_train_step(
        model, GNN_SHAPES[s], needs_triplets=True, optimizer=optimizer),
    batch_style="dict",
    notes="triplet-gather regime; T_max = 4*E (the angular basis is "
          "bessel x cos-series, scipy-free, same flops).")
