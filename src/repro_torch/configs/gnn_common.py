"""Shared GNN shape definitions and step builders for the four assigned
GNN architectures.

Counterpart of `repro/configs/gnn_common.py`. Shapes (assigned):
  full_graph_sm : n_nodes=2,708 n_edges=10,556 d_feat=1,433 (cora-scale,
                  full-batch node classification, 7 classes)
  minibatch_lg  : global graph n_nodes=232,965 n_edges=114,615,892
                  (reddit-scale); the training step consumes a SAMPLED
                  subgraph: batch_nodes=1,024, fanout 15-10 ->
                  node cap 1,024*(1+15+150), edge cap 1,024*(15+150),
                  d_feat=602, 41 classes. graph/sampler.py produces these.
  ogb_products  : n_nodes=2,449,029 n_edges=61,859,140 d_feat=100
                  (full-batch-large), 47 classes
  molecule      : 128 graphs x (30 nodes, 64 edges), 3D positions, energy
                  regression

NequIP/DimeNet need positions: graph shapes without natural coordinates
get a synthesized `pos` input. DimeNet also takes triplet indices capped
at T_max = 4 * n_edges (graph/triplets.py).

A train step is train_step(params, opt_state, batch) -> (params,
opt_state, loss) over a batch dict of tensors named as `gnn_input_specs`
names them: the loss's gradient (`configs.base.value_and_grad`), clipped
to global norm 1, then Adam at lr 1e-3. The step carries its loss
function of the batch as `train_step.loss_fn`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ShapeSpec, clipped_update,
                                      value_and_grad)
from repro_torch.graph.graphs import Graph
from repro_torch.graph.nequip import per_graph_sum
from repro_torch.graph.sage import output_loss
from repro_torch.graph.sampler import sample_capacities

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train",
                               {"n_nodes": 2708, "n_edges": 10556,
                                "d_feat": 1433, "n_classes": 7,
                                "n_graphs": 1}),
    "minibatch_lg": ShapeSpec("minibatch_lg", "train",
                              {"n_nodes": sample_capacities(1024, (15, 10))[0],
                               "n_edges": sample_capacities(1024, (15, 10))[1],
                               "d_feat": 602, "n_classes": 41,
                               "n_graphs": 1,
                               "global_nodes": 232965,
                               "global_edges": 114615892}),
    "ogb_products": ShapeSpec("ogb_products", "train",
                              {"n_nodes": 2449029, "n_edges": 61859140,
                               "d_feat": 100, "n_classes": 47,
                               "n_graphs": 1}),
    "molecule": ShapeSpec("molecule", "train",
                          {"n_nodes": 128 * 30, "n_edges": 128 * 64,
                           "d_feat": 16, "n_classes": 0,
                           "n_graphs": 128}),
}


def pad512(n: int) -> int:
    """Static capacities are padded to multiples of 512, as the reference
    pads them for its production meshes; the edge / node masks cover the
    padding rows."""
    return -(-n // 512) * 512


def gnn_input_specs(shape: ShapeSpec, needs_pos: bool, needs_triplets: bool,
                    t_factor: int = 4) -> dict:
    """{name: (shape tuple, torch dtype)} of a train batch: indices int64
    (the reference's int32), masks bool, the rest f32."""
    d = shape.dims
    N, E = pad512(d["n_nodes"]), pad512(d["n_edges"])
    specs = {
        "senders": ((E,), torch.int64),
        "receivers": ((E,), torch.int64),
        "x": ((N, d["d_feat"]), torch.float32),
        "edge_mask": ((E,), torch.bool),
        "node_mask": ((N,), torch.bool),
    }
    if needs_pos:
        specs["pos"] = ((N, 3), torch.float32)
    if d["n_classes"]:
        specs["labels"] = ((N,), torch.int64)
        specs["label_mask"] = ((N,), torch.bool)
    else:
        specs["targets"] = ((d["n_graphs"],), torch.float32)
        specs["graph_ids"] = ((N,), torch.int64)
    if needs_triplets:
        T = pad512(t_factor * E)
        specs["t_kj"] = ((T,), torch.int64)
        specs["t_ji"] = ((T,), torch.int64)
        specs["t_mask"] = ((T,), torch.bool)
    return specs


def batch_graph(batch: dict, n_graphs: int) -> Graph:
    return Graph(senders=batch["senders"], receivers=batch["receivers"],
                 x=batch["x"], edge_mask=batch["edge_mask"],
                 node_mask=batch["node_mask"], pos=batch.get("pos"),
                 graph_ids=batch.get("graph_ids"), n_graphs=n_graphs)


def gnn_loss(model, shape: ShapeSpec, needs_triplets: bool):
    """loss_fn(batch): masked cross-entropy over label_mask & node_mask
    (shapes with classes), else the MSE of the model's per-graph output
    against `targets`."""
    n_graphs = shape.dims["n_graphs"]
    classes = shape.dims["n_classes"]

    def loss_fn(batch):
        g = batch_graph(batch, n_graphs)
        extra = ((batch["t_kj"], batch["t_ji"], batch["t_mask"])
                 if needs_triplets else ())
        targets = ((batch["labels"], batch["label_mask"] & batch["node_mask"])
                   if classes else batch["targets"])
        return output_loss(model(g, *extra), targets, classes)

    return loss_fn


def node_energy_loss(model, shape: ShapeSpec):
    """loss_fn(batch) of a model with [N, 1] node outputs at a shape
    without classes (PNA's and GatedGCN's molecule step): the outputs
    masked by node_mask and summed per graph, their MSE against
    `targets`."""
    n_graphs = shape.dims["n_graphs"]

    def loss_fn(batch):
        g = batch_graph(batch, n_graphs)
        e = per_graph_sum(model(g)[..., 0], g)
        return torch.mean(torch.square(e - batch["targets"]))

    return loss_fn


def make_train_step(model, loss_fn, lr: float = 1e-3, optimizer=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    clip_by_global_norm(1.0), then `optimizer` (Adam unless given) at
    `lr`; `train_step.loss_fn` is loss_fn."""
    from repro_torch.optim import adam
    opt = optimizer or adam()

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, loss_fn, params, batch)
        params, opt_state = clipped_update(opt, opt_state, grads, params, lr)
        return params, opt_state, loss

    train_step.loss_fn = loss_fn
    return train_step


def make_gnn_train_step(model, shape: ShapeSpec, needs_triplets: bool,
                        lr: float = 1e-3, optimizer=None):
    """The generic full / sampled-batch GNN train step (Adam + clip). The
    reference's `needs_pos` flag is not taken: its step reads `pos` from
    the batch whenever the batch has it, as this one does."""
    return make_train_step(model, gnn_loss(model, shape, needs_triplets),
                           lr, optimizer)


def make_node_task_step(model, shape_name: str, optimizer=None):
    """PNA's and GatedGCN's step at a shape: the generic GNN step where
    the shape has classes, else the node outputs summed per graph as the
    energy (node_energy_loss)."""
    shape = GNN_SHAPES[shape_name]
    if shape.dims["n_classes"]:
        return make_gnn_train_step(model, shape, needs_triplets=False,
                                   optimizer=optimizer)
    return make_train_step(model, node_energy_loss(model, shape),
                           optimizer=optimizer)
