"""d3gnn-sage — the paper's own evaluation model under the streaming engine:
2-layer GraphSAGE, 64-dim output (paper §6), one tick of both layers.

Counterpart of `repro/configs/d3gnn_sage.py`, at its production sizing:
1024 logical parts, reddit-scale features (d_in=602), per-part caps sized
for ~1M vertices / ~16M edges globally. `input_specs` describes the tick's
inputs as (shape, dtype) pairs without allocating them (meta tensors);
the dry run (`launch/dryrun.py --include-extra`) runs `step` on them,
and its one-card cell on `steady_tick`'s live inputs.
"""
from __future__ import annotations

from dataclasses import fields

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core import windowing as win
from repro_torch.core.events import EdgeBatch, FeatBatch, ReplBatch
from repro_torch.core.state import (LayerState, TopoState, init_layer,
                                    init_topo)
from repro_torch.core.tick import layer_tick_body
from repro_torch.graph.sage import GraphSAGE

N_PARTS = 1024
NODE_CAP = 1024          # per-part vertex slots  (~1M vertices w/ replicas)
EDGE_CAP = 16384         # per-part edge slots    (~16M edges)
REPL_CAP = 4096
FEAT_CAP = 16384         # event rows per tick
EDGE_TICK_CAP = 16384
D_IN, D_HID = 602, 64
# the tick's window (`step`): tumbling, every 4 ticks
WINDOW = win.WindowConfig(kind=win.TUMBLING, interval=4)

SHAPES = {
    "stream_tick": ShapeSpec(
        "stream_tick", "serve",
        {"n_parts": N_PARTS, "node_cap": NODE_CAP, "edge_cap": EDGE_CAP,
         "feat_cap": FEAT_CAP, "d_in": D_IN, "d_hid": D_HID}),
}


def build(device=None, seed=0):
    """GraphSAGE (602, 64, 64), drawn on the host (D3Pipeline moves it to
    its device); moved to `device` when one is given (the dry run's
    `meta` build allocates nothing)."""
    model = GraphSAGE((D_IN, D_HID, D_HID), seed=seed)
    return model if device is None else model.to(device)


def build_reduced(device=None, seed=0):
    model = GraphSAGE((8, 8, 8), seed=seed)
    return model if device is None else model.to(device)


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


def input_specs(model, shape_name: str, n_parts: int = N_PARTS) -> dict:
    """The tick's inputs at the production sizing; `n_parts` cuts the
    part count (the dry run's one-card cell at 512 parts: the tick's
    [P * EDGE_CAP, 602] lanes are 40 GB each at 1024)."""
    meta = torch.device("meta")
    return {
        "topo": _spec_of(init_topo(n_parts, EDGE_CAP, REPL_CAP, NODE_CAP,
                                   meta)),
        "state0": _spec_of(init_layer(n_parts, NODE_CAP, D_IN, D_IN, meta)),
        "state1": _spec_of(init_layer(n_parts, NODE_CAP, D_HID, D_HID,
                                      meta)),
        "inbox": _batch_spec(FeatBatch, FEAT_CAP, D_IN),
        "eb": _batch_spec(EdgeBatch, EDGE_TICK_CAP),
        "rb": _batch_spec(ReplBatch, EDGE_TICK_CAP),
        "now": ((), torch.int64),
    }


# the record type of each group of `input_specs`
RECORDS = {"topo": TopoState, "state0": LayerState, "state1": LayerState,
           "inbox": FeatBatch, "eb": EdgeBatch, "rb": ReplBatch}


def step(model, shape_name: str):
    """One tick of both layers: stream_step(topo, state0, state1, inbox,
    eb, rb, now) -> (state0, state1, layer 1's output batch). A group is
    its record (TopoState, LayerState, ...) or the dict of its fields
    that `input_specs` describes (the dry run's)."""
    wconf = WINDOW

    def stream_step(topo, state0, state1, inbox, eb, rb, now):
        topo, state0, state1, inbox, eb, rb = (
            RECORDS[name](**g) if isinstance(g, dict) else g
            for name, g in zip(("topo", "state0", "state1", "inbox", "eb",
                                "rb"), (topo, state0, state1, inbox, eb, rb)))
        s0, out0, _, _ = layer_tick_body(model.layers[0], topo, state0,
                                         inbox, eb, rb, now, wconf, FEAT_CAP)
        s1, out1, _, _ = layer_tick_body(model.layers[1], topo, state1,
                                         out0, eb, rb, now, wconf, FEAT_CAP)
        return s0, s1, out1

    return stream_step


def _layer_state(layer, topo: dict, spec: dict, touched, gen) -> dict:
    """A layer's state in the steady state of `steady_tick`: features
    everywhere (a replica holding its master's), the synopses the sums of
    their in-edges' messages of the values last sent, and the touched
    vertices' features moved since they were last sent, pending at the
    window's boundary (masters also due to forward)."""
    P, N, d = spec["feat"][0]
    dev = touched.device
    nm = int(topo["is_master"][0].sum())
    x_sent = torch.randn(P, N, d, generator=gen, device=dev)
    x_sent[:, nm:] = torch.roll(x_sent[:, :N - nm], shifts=-1, dims=0)
    feat = x_sent + torch.where(touched[..., None], torch.randn(
        P, N, d, generator=gen, device=dev), 0.0)
    flat = x_sent.reshape(P * N, d)
    agg = torch.zeros(P * N, spec["agg"][0][2], device=dev)
    cnt = torch.zeros(P * N, device=dev)
    pp = torch.arange(P, device=dev)[:, None]
    src = (pp * N + topo["e_src_slot"])
    dst = (topo["e_dst_mpart"] * N + topo["e_dst_mslot"])
    for p0 in range(0, P, 16):    # 16 parts' edges at a time
        ok = topo["e_valid"][p0:p0 + 16]
        s, t = src[p0:p0 + 16][ok], dst[p0:p0 + 16][ok]
        agg.index_add_(0, t, layer.message(flat[s]))
        cnt.index_add_(0, t, torch.ones(t.shape[0], device=dev))
    now = WINDOW.interval
    state = {
        "feat": feat, "has_feat": torch.ones(P, N, dtype=torch.bool,
                                             device=dev),
        "x_sent": x_sent, "has_sent": torch.ones(P, N, dtype=torch.bool,
                                                 device=dev),
        "agg": agg.reshape(P, N, -1), "agg_cnt": cnt.reshape(P, N),
        "red_pending": touched, "red_deadline": touched * now,
        "fwd_pending": touched & topo["is_master"],
        "fwd_deadline": touched * now}
    return {k: state[k] if k in state else torch.zeros(
        shp, dtype=dt, device=dev) for k, (shp, dt) in spec.items()}


@torch.no_grad()
def steady_tick(model, specs: dict, device, gen) -> dict:
    """The tick's inputs in a steady state, at the sizes of `specs`
    (`input_specs`'), drawn from `gen` on `device`:

      * every node slot holds a vertex; the last quarter of each part's
        slots are replicas of the next part's first quarter (a ring, so
        every broadcast crosses parts), the rest masters;
      * half of each part's edge slots are live, between random local
        slots, each to its destination's master;
      * the vertices touched in the last window, a random share that is
        the inbox's rows over four ticks, are pending at `now`, the
        window's boundary: round B sends them and psi evicts them;
      * a full inbox of feature updates at distinct masters, a full
        batch of new edges spread evenly over the parts into free slots,
        no new replica.

    Groups are dicts of fields, as `step` takes them; "now" is the
    boundary."""
    topo_spec = specs["topo"]
    P, E = topo_spec["e_valid"][0]
    N = topo_spec["v_exists"][0][1]
    nm = N - N // 4                               # masters a part
    F, C = specs["inbox"]["valid"][0][0], specs["eb"]["valid"][0][0]
    assert N // 4 <= topo_spec["r_valid"][0][1] and F <= P * nm \
        and C // P + (C % P > 0) <= E - E // 2, "caps too small"
    dev = torch.device(device)
    ints = lambda hi, *shape: torch.randint(0, hi, shape, generator=gen,
                                            device=dev)
    pp = torch.arange(P, device=dev)[:, None]
    slots = torch.arange(N, device=dev)[None, :]
    is_master = (slots < nm).expand(P, N)
    m_part = torch.where(is_master, pp, (pp + 1) % P)
    m_slot = torch.where(is_master, slots, slots - nm)
    j = torch.arange(topo_spec["r_valid"][0][1], device=dev)[None, :]
    r_valid = (j < N - nm).expand(P, -1)
    e_src, e_dst = ints(N, P, E), ints(N, P, E)
    topo = {
        "e_src_slot": e_src, "e_dst_slot": e_dst,
        "e_dst_mpart": torch.gather(m_part, 1, e_dst),
        "e_dst_mslot": torch.gather(m_slot, 1, e_dst),
        "e_valid": (torch.arange(E, device=dev) < E // 2).expand(P, E),
        "r_master_slot": torch.where(r_valid, j, 0),
        "r_rep_part": torch.where(r_valid, (pp - 1) % P, 0),
        "r_rep_slot": torch.where(r_valid, nm + j, 0), "r_valid": r_valid,
        "v_exists": torch.ones(P, N, dtype=torch.bool, device=dev),
        "is_master": is_master, "m_part": m_part, "m_slot": m_slot}
    topo = {k: topo[k].contiguous() for k in topo_spec}
    share = min(1.0, 4 * F / (P * nm))
    touched = torch.rand(P, N, generator=gen, device=dev) < share
    pick = torch.randperm(P * nm, generator=gen, device=dev)[:F]
    inbox = {"part": pick // nm, "slot": pick % nm,
             "feat": torch.randn(F, specs["inbox"]["feat"][0][1],
                                 generator=gen, device=dev),
             "valid": torch.ones(F, dtype=torch.bool, device=dev)}
    part = torch.arange(C, device=dev) % P
    src, dst = ints(N, C), ints(N, C)
    eb = {"part": part, "edge_slot": E // 2 + torch.arange(C, device=dev) // P,
          "src_slot": src, "dst_slot": dst,
          "dst_master_part": m_part[part, dst],
          "dst_master_slot": m_slot[part, dst],
          "valid": torch.ones(C, dtype=torch.bool, device=dev)}
    rb = {k: torch.zeros(shp, dtype=dt, device=dev)
          for k, (shp, dt) in specs["rb"].items()}
    return {"topo": topo,
            "state0": _layer_state(model.layers[0], topo, specs["state0"],
                                   touched, gen),
            "state1": _layer_state(model.layers[1], topo, specs["state1"],
                                   touched, gen),
            "inbox": inbox, "eb": eb, "rb": rb,
            "now": torch.tensor(WINDOW.interval, device=dev)}


SPEC = ArchSpec(
    name="d3gnn-sage", family="d3gnn",
    build=build, build_reduced=build_reduced,
    shapes=SHAPES,
    input_specs=input_specs,
    step=step,
    notes="the paper's streaming engine itself, one tick of both layers.")
