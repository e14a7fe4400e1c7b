"""d3gnn-sage — the paper's own evaluation model under the streaming engine:
2-layer GraphSAGE, 64-dim output (paper §6), one tick of both layers.

Counterpart of `repro/configs/d3gnn_sage.py`, at its production sizing:
1024 logical parts, reddit-scale features (d_in=602), per-part caps sized
for ~1M vertices / ~16M edges globally. `input_specs` describes the tick's
inputs as (shape, dtype) pairs without allocating them (meta tensors).
"""
from __future__ import annotations

from dataclasses import fields

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core import windowing as win
from repro_torch.core.events import EdgeBatch, FeatBatch, ReplBatch
from repro_torch.core.state import init_layer, init_topo
from repro_torch.core.tick import layer_tick_body
from repro_torch.graph.sage import GraphSAGE

N_PARTS = 1024
NODE_CAP = 1024          # per-part vertex slots  (~1M vertices w/ replicas)
EDGE_CAP = 16384         # per-part edge slots    (~16M edges)
REPL_CAP = 4096
FEAT_CAP = 16384         # event rows per tick
EDGE_TICK_CAP = 16384
D_IN, D_HID = 602, 64

SHAPES = {
    "stream_tick": ShapeSpec(
        "stream_tick", "serve",
        {"n_parts": N_PARTS, "node_cap": NODE_CAP, "edge_cap": EDGE_CAP,
         "feat_cap": FEAT_CAP, "d_in": D_IN, "d_hid": D_HID}),
}


def build(device=None, seed=0):
    return GraphSAGE((D_IN, D_HID, D_HID), seed=seed)


def build_reduced(device=None, seed=0):
    return GraphSAGE((8, 8, 8), seed=seed)


def _spec_of(obj) -> dict:
    return {f.name: (tuple(getattr(obj, f.name).shape),
                     getattr(obj, f.name).dtype) for f in fields(obj)}


def _batch_spec(cls, rows: int, d: int = 0) -> dict:
    """Index columns int64, `valid` bool, `feat` [rows, d] float32."""
    out = {}
    for f in fields(cls):
        if f.name == "valid":
            out[f.name] = ((rows,), torch.bool)
        elif f.name == "feat":
            out[f.name] = ((rows, d), torch.float32)
        else:
            out[f.name] = ((rows,), torch.int64)
    return out


def input_specs(model, shape_name: str) -> dict:
    meta = torch.device("meta")
    return {
        "topo": _spec_of(init_topo(N_PARTS, EDGE_CAP, REPL_CAP, NODE_CAP,
                                   meta)),
        "state0": _spec_of(init_layer(N_PARTS, NODE_CAP, D_IN, D_IN, meta)),
        "state1": _spec_of(init_layer(N_PARTS, NODE_CAP, D_HID, D_HID,
                                      meta)),
        "inbox": _batch_spec(FeatBatch, FEAT_CAP, D_IN),
        "eb": _batch_spec(EdgeBatch, EDGE_TICK_CAP),
        "rb": _batch_spec(ReplBatch, EDGE_TICK_CAP),
        "now": ((), torch.int64),
    }


def step(model, shape_name: str):
    wconf = win.WindowConfig(kind=win.TUMBLING, interval=4)

    def stream_step(topo, state0, state1, inbox, eb, rb, now):
        s0, out0, _, _ = layer_tick_body(model.layers[0], topo, state0,
                                         inbox, eb, rb, now, wconf, FEAT_CAP)
        s1, out1, _, _ = layer_tick_body(model.layers[1], topo, state1,
                                         out0, eb, rb, now, wconf, FEAT_CAP)
        return s0, s1, out1

    return stream_step


SPEC = ArchSpec(
    name="d3gnn-sage", family="d3gnn",
    build=build, build_reduced=build_reduced,
    shapes=SHAPES,
    input_specs=input_specs,
    step=step,
    notes="the paper's streaming engine itself, one tick of both layers.")
