"""Unified streaming event format (paper §4.1) + padded device batches.

Counterpart of `repro/core/events.py`. The partitioner turns a tick's worth
of host events into fixed-capacity, mask-padded struct-of-tensors batches
that the layer tick consumes. Every row is pre-addressed to (part, slot),
so the device program never needs a hash lookup.

The `*_from_numpy` builders take `device=`: a torch device puts the
batch's tensors there; None keeps numpy leaves — the super-tick driver
stages T batches on the host and `stack_batches` copies only their valid
rows to the device in ONE copy a batch class, where the padded `[T, cap,
...]` lanes are built. Index columns are int64 (torch's index type),
flags are bool, payloads float32.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch.telemetry import spans


def _map(fn, *batches):
    """Apply fn field-wise over same-typed batches -> a new batch."""
    cls = type(batches[0])
    return cls(**{f.name: fn(*(getattr(b, f.name) for b in batches))
                  for f in fields(cls)})


@dataclass(frozen=True)
class EdgeBatch:
    """New-edge records for one tick: each scatters one directed edge
    (u -> v) into the part the vertex-cut partitioner chose."""
    part: torch.Tensor             # [C] destination part of the record
    edge_slot: torch.Tensor        # [C] slot in the part's edge table
    src_slot: torch.Tensor         # [C] local slot of u in `part`
    dst_slot: torch.Tensor         # [C] local slot of v in `part`
    dst_master_part: torch.Tensor  # [C] master coordinates of v
    dst_master_slot: torch.Tensor  # [C]
    valid: torch.Tensor            # [C] bool


@dataclass(frozen=True)
class ReplBatch:
    """New replica records: master (part, slot) -> replica (part, slot)."""
    part: torch.Tensor             # [C] master part (where the record lives)
    repl_slot: torch.Tensor        # [C] slot in the replication table
    master_slot: torch.Tensor      # [C] master's local slot
    rep_part: torch.Tensor         # [C] replica coordinates
    rep_slot: torch.Tensor         # [C]
    valid: torch.Tensor            # [C] bool


@dataclass(frozen=True)
class VertexBatch:
    """New vertex (replica) records: existence + mastership flags."""
    part: torch.Tensor
    slot: torch.Tensor
    is_master: torch.Tensor        # [C] bool
    valid: torch.Tensor            # [C] bool


@dataclass(frozen=True)
class FeatBatch:
    """Feature updates addressed to master (part, slot)."""
    part: torch.Tensor
    slot: torch.Tensor
    feat: torch.Tensor             # [C, d] float32
    valid: torch.Tensor            # [C] bool


@dataclass(frozen=True)
class LabelBatch:
    """Label observations addressed to master (part, slot): the training
    plane's admission unit (capacity = PipelineConfig.train_cap)."""
    part: torch.Tensor
    slot: torch.Tensor
    label: torch.Tensor            # [C] gold class
    valid: torch.Tensor            # [C] bool


@dataclass(frozen=True)
class MsgBatch:
    """Fixed-capacity, part-addressed message records — one round's
    cross-part traffic. Round-A broadcast rows SET a feature value, Round-B
    RMI rows ADD an aggregator (delta, dcnt) record."""
    part: torch.Tensor             # [C] destination part
    slot: torch.Tensor             # [C] destination slot in that part
    vec: torch.Tensor              # [C, d] float payload
    cnt: torch.Tensor              # [C] float count delta (zeros for A)
    src_part: torch.Tensor         # [C] emitting part (cross-part stats)
    valid: torch.Tensor            # [C] bool


def _check_fits(what: str, n: int, cap: int) -> None:
    if n > cap:
        raise ValueError(f"{what} batch overflow: {n} rows > capacity {cap}")


def _leaf(a: np.ndarray, device):
    return a if device is None else torch.as_tensor(a).to(device)


def _padded(col, n: int, cap: int, dtype=np.int64) -> np.ndarray:
    out = np.zeros((cap,), dtype)
    out[:n] = col
    return out


def _valid(n: int, cap: int) -> np.ndarray:
    v = np.zeros((cap,), bool)
    v[:n] = True
    return v


def vertex_batch_from_numpy(rows: dict, cap: int, device=None) -> VertexBatch:
    n = len(rows["part"])
    _check_fits("vertex", n, cap)
    return VertexBatch(
        part=_leaf(_padded(rows["part"], n, cap), device),
        slot=_leaf(_padded(rows["slot"], n, cap), device),
        is_master=_leaf(_padded(rows["is_master"], n, cap, bool), device),
        valid=_leaf(_valid(n, cap), device))


def edge_batch_from_numpy(rows: dict, cap: int, device=None) -> EdgeBatch:
    n = len(rows["part"])
    _check_fits("edge", n, cap)
    col = lambda k: _leaf(_padded(rows[k], n, cap), device)
    return EdgeBatch(part=col("part"), edge_slot=col("edge_slot"),
                     src_slot=col("src_slot"), dst_slot=col("dst_slot"),
                     dst_master_part=col("dst_master_part"),
                     dst_master_slot=col("dst_master_slot"),
                     valid=_leaf(_valid(n, cap), device))


def repl_batch_from_numpy(rows: dict, cap: int, device=None) -> ReplBatch:
    n = len(rows["part"])
    _check_fits("repl", n, cap)
    col = lambda k: _leaf(_padded(rows[k], n, cap), device)
    return ReplBatch(part=col("part"), repl_slot=col("repl_slot"),
                     master_slot=col("master_slot"), rep_part=col("rep_part"),
                     rep_slot=col("rep_slot"),
                     valid=_leaf(_valid(n, cap), device))


def feat_batch_from_numpy(parts, slots, feats, cap: int, d: int,
                          device=None) -> FeatBatch:
    n = len(parts)
    _check_fits("feat", n, cap)
    f = np.zeros((cap, d), np.float32)
    if n:
        f[:n] = feats
    return FeatBatch(part=_leaf(_padded(parts, n, cap), device),
                     slot=_leaf(_padded(slots, n, cap), device),
                     feat=_leaf(f, device),
                     valid=_leaf(_valid(n, cap), device))


def empty_label_batch(cap: int, device=None) -> LabelBatch:
    z = np.zeros(0, np.int64)
    return label_batch_from_numpy(z, z, z, cap, device)


def label_batch_from_numpy(parts, slots, labels, cap: int,
                           device=None) -> LabelBatch:
    n = len(parts)
    _check_fits("label", n, cap)
    return LabelBatch(part=_leaf(_padded(parts, n, cap), device),
                      slot=_leaf(_padded(slots, n, cap), device),
                      label=_leaf(_padded(labels, n, cap), device),
                      valid=_leaf(_valid(n, cap), device))


def concat_msg_batches(a: MsgBatch, b: MsgBatch) -> MsgBatch:
    """Concatenate two MsgBatches along the record axis (same payload
    dim): Round B's new-edge and windowed delta RMIs ride as one lane."""
    return _map(lambda x, y: torch.cat([x, y]), a, b)


def coalesce_msg_batch(b: MsgBatch, n_slots: int, delivery) -> MsgBatch:
    """Coalesce same-destination records of one additive MsgBatch.

    Aggregator RMIs are additive, so the records addressed to one (part,
    slot) in a tick can be summed before the routing plane: the result
    keeps the capacity C but carries one live row per distinct
    destination, in destination-key order (key part * n_slots + slot,
    int64; invalid rows sort past every valid key). A STABLE sort makes
    each run's head its first record in record order; the head carries
    that record's part, slot and src_part, and the run's vec / cnt sums
    land at the run's index. The sums go through the delivery plane
    (`delivery.add_rows`, kernel A on the "kernel" backend), each run's
    records added in record order. Rows past the last run are dead and
    carry zeros. ADD semantics only: never coalesce a set lane this way.
    """
    C = b.part.shape[0]
    dev = b.part.device
    past = torch.iinfo(torch.int64).max
    key = torch.where(b.valid, b.part * n_slots + b.slot,
                      torch.full_like(b.part, past))
    key_s, order = torch.sort(key, stable=True)
    valid_s = b.valid[order]
    head = torch.ones_like(valid_s)
    head[1:] = key_s[1:] != key_s[:-1]
    run = torch.cumsum(head, 0) - 1                 # run index, sorted row
    # each record's run, at its own position; invalid records drop
    idx = torch.empty_like(run)
    idx[order] = torch.where(valid_s, run, torch.full_like(run, C))
    vec, cnt = delivery.add_rows(C, idx, b.vec, b.cnt)
    # the sorted position of each run's head (dead rows: position 0, the
    # last row the largest non-head position), as JAX's .at[pos].max
    pos = torch.where(head, run, torch.full_like(run, C - 1))
    take = torch.zeros(C, dtype=torch.int64, device=dev).scatter_reduce(
        0, pos, torch.arange(C, device=dev), "amax")
    src = order[take]
    live = (torch.arange(C, device=dev) <= run[-1]) & valid_s[take]
    return MsgBatch(part=b.part[src], slot=b.slot[src], vec=vec, cnt=cnt,
                    src_part=b.src_part[src], valid=live)


def stack_batches(batches, device):
    """Stack same-capacity numpy-leaf batches along a new leading tick
    axis on `device`: field-wise equal to `np.stack` of the host arrays
    (super-tick staging; capacities derive from PipelineConfig, so shapes
    agree).

    Only each tick's valid rows travel. Every builder makes `valid` a
    prefix of n_t rows and zero-pads past it, so the rows `[:n_t]` of
    every field of the T ticks are packed into ONE host buffer (pinned
    on CUDA, through the caching host allocator, and copied
    non-blocking), after two int64 [T] columns: each tick's end in the
    packed rows and its shift to the flat `[T*cap]` row index. On the
    device each field's lane starts zero-filled and takes its rows by
    `index_copy_`. Every size is known on the host: no host sync. The
    padded rows on the host are never read, so their zero pages are
    never touched.

    The launch log counts the bytes copied to the device
    (`upload.bytes`: rows, the two columns, 8-byte alignment), the bytes
    of the valid rows (`upload.live_bytes`) and the bytes of the lanes
    built (`upload.lane_bytes`)."""
    if not batches:
        raise ValueError("cannot stack an empty batch list")
    T = len(batches)
    cap = batches[0].valid.shape[0]
    ns = [int(np.count_nonzero(b.valid)) for b in batches]
    for b, n in zip(batches, ns):
        if not b.valid[:n].all():
            raise ValueError(f"{type(b).__name__}.valid is not a prefix")
    N = sum(ns)
    names = [f.name for f in fields(batches[0])]
    first = [getattr(batches[0], k) for k in names]
    rows = [a.itemsize * int(np.prod(a.shape[1:])) for a in first]
    offs, end = [], 16 * T      # each field's rows start 8-byte aligned
    for rb in rows:
        offs.append(end)
        end += -(-N * rb // 8) * 8
    dev = torch.device(device)
    host = torch.empty(end, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    ends = np.cumsum(ns, dtype=np.int64)
    buf[:16 * T].view(np.int64)[:] = np.concatenate(
        [ends, np.arange(T, dtype=np.int64) * cap - (ends - ns)])
    packed = []                 # (name, dtype, row shape, offset, bytes)
    for k, a, rb, o in zip(names, first, rows, offs):
        seg = buf[o:o + N * rb].view(a.dtype).reshape(N, *a.shape[1:])
        np.concatenate([getattr(b, k)[:n] for b, n in zip(batches, ns)],
                       out=seg)
        packed.append((k, torch.from_numpy(seg).dtype, a.shape[1:], o,
                       N * rb))
    spans.count("upload.bytes", end)
    spans.count("upload.live_bytes", sum(rows) * N)
    spans.count("upload.lane_bytes", sum(a.nbytes for a in first) * T)

    dbuf = host.to(dev, non_blocking=True)
    ends_d, shift = dbuf[:16 * T].view(torch.int64).view(2, T)
    r = torch.arange(N, device=dev)
    pos = r + shift[torch.searchsorted(ends_d, r, right=True)]
    lanes = {}
    for k, dt, tail, o, nb in packed:
        lane = torch.zeros((T * cap, *tail), dtype=dt, device=dev)
        lane.index_copy_(0, pos, dbuf[o:o + nb].view(dt).view(N, *tail))
        lanes[k] = lane.view(T, cap, *tail)
    return type(batches[0])(**lanes)


def batch_at(batch, t: int):
    """Tick t of a stacked batch (a view along the leading axis)."""
    return _map(lambda x: x[t], batch)
