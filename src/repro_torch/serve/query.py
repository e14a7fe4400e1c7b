"""The QUERY plane: on-device point queries over the live sharded state —
the paper's "online query setting".

Counterpart of `repro/serve/query.py`. The streaming tick is four planes:
COMPUTE (core/tick.py) emits part-addressed records, ROUTING
(dist/router.py) moves them to the owning rank, DELIVERY
(core/delivery.py) lands them in state, and QUERY (here) answers point
reads from the state the other three maintain, without copying the sink
to the host.

  QueryBatch  : admissions (host-built, replicated like the FeatBatch
                inbox; each part keeps its own rows) AND the wire format
                of the link-score forwarding hop, which rides layer 0's
                round-B exchange as a second lane of the same all_to_all.
  QueryState  : the per-part pending-query table ([P, Q] slots), so held
                `consistent` queries survive super-ticks and sharding;
                plus the wire lane's defer ring on a capped mesh.
  AnswerBatch : one row per pending slot per tick plus the tick's
                admission-overflow rows; `valid` marks the rows answered
                this tick. The drivers read them back in the tick's (or
                the super-tick's) one stats read.

Query kinds: KIND_EMBED reads one vertex's sink embedding; KIND_LINK
scores an edge (u, v) = <h_u, h_v> in two hops: the query lands at u's
master part, gathers h_u when ready and forwards a KIND_LINK_TAIL wire
record (vec = h_u) to v's master part, where the dot product fires.

Freshness (per query): `stale_ok` answers in its admission tick from the
current sink (bit-equal to a host `read_nodes` of the same tick);
`consistent` holds while its target has red/fwd pending state at any
layer or the tick was not globally silent, so it answers only at a
quiescent tick (the static oracle's value after a drain flush).
Consistent link heads fire only at a START-silent tick (no pending work
anywhere and an empty update batch), so both hops answer in one tick.

Admission overflow is never silent: dropped records come back as
ok=False answer rows in the same tick. Integer fields are int64, as
everywhere in the port; on the packed f32 wire they are value-cast,
exact below 2**24 (the host refuses qids at or above it).

Every stage is shape-static and reads nothing back to the host: scatters
go through the one-row-padded `core/state.py:scatter_set`, never an
out-of-range index or a boolean mask.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from repro_torch.core.state import scatter_set
from repro_torch.core.termination import pending_work
from repro_torch.dist.wire import lane_width

# query kinds (host submits EMBED/LINK; LINK_TAIL is the device-internal
# second hop of a link-score query, never admitted from host)
KIND_EMBED = 0
KIND_LINK = 1
KIND_LINK_TAIL = 2


@dataclass(frozen=True)
class QueryBatch:
    """Fixed-capacity query records — admissions and the link-tail wire.

    `part`/`slot` address the record's target master; `part2`/`slot2`
    carry the second endpoint of a KIND_LINK query. `vec` is zero on
    admission and carries h_u on the KIND_LINK_TAIL wire. `ok`
    accumulates the seen-flags of gathered endpoints."""
    qid: torch.Tensor          # [C] int64 host-assigned query id
    kind: torch.Tensor         # [C] int64 KIND_*
    part: torch.Tensor         # [C] int64 target master part (routing key)
    slot: torch.Tensor         # [C] int64 target master slot
    part2: torch.Tensor        # [C] int64 second endpoint master part
    slot2: torch.Tensor        # [C] int64
    consistent: torch.Tensor   # [C] bool  freshness mode
    ok: torch.Tensor           # [C] bool  seen-flag accumulator
    issue: torch.Tensor        # [C] int64 issue tick (host-stamped)
    vec: torch.Tensor          # [C, d] float32 payload (tail hop: h_u)
    valid: torch.Tensor        # [C] bool


@dataclass(frozen=True)
class QueryState:
    """Per-part pending-query table: [P, Q] (vec [P, Q, d]); `pending`
    marks occupied slots, which free as soon as they answer or forward.
    wire_defer / wire_defer_ok: the wire lane's defer ring on a capped
    mesh ([K, W] packed rows a rank, K = 0 otherwise)."""
    qid: torch.Tensor          # [P, Q] int64
    kind: torch.Tensor         # [P, Q] int64
    slot: torch.Tensor         # [P, Q] int64 local target slot
    part2: torch.Tensor        # [P, Q] int64
    slot2: torch.Tensor        # [P, Q] int64
    consistent: torch.Tensor   # [P, Q] bool
    ok: torch.Tensor           # [P, Q] bool
    issue: torch.Tensor        # [P, Q] int64
    vec: torch.Tensor          # [P, Q, d] float32 (h_u for tail rows)
    pending: torch.Tensor      # [P, Q] bool
    wire_defer: torch.Tensor   # [K, W] float32
    wire_defer_ok: torch.Tensor  # [K] bool


@dataclass(frozen=True)
class AnswerBatch:
    """One tick's answer rows, `valid` = answered. `vec` holds the
    embedding of KIND_EMBED rows, `score` the link score of KIND_LINK rows
    (tail hops answer as KIND_LINK); `ok` is False when a gathered
    endpoint never materialized or the row is an admission overflow."""
    qid: torch.Tensor          # [A] int64
    kind: torch.Tensor         # [A] int64 (KIND_EMBED | KIND_LINK)
    ok: torch.Tensor           # [A] bool
    tick: torch.Tensor         # [A] int64 answer tick
    issue: torch.Tensor        # [A] int64 issue tick
    vec: torch.Tensor          # [A, d] float32
    score: torch.Tensor        # [A] float32
    valid: torch.Tensor        # [A] bool


@dataclass(frozen=True)
class QueryStats:
    """Per-tick query-plane counters (0-d int64, summed over the ranks)."""
    admitted: torch.Tensor     # queries that found a pending slot
    answered: torch.Tensor     # answers emitted this tick
    dropped: torch.Tensor      # admissions lost to a full pending table
    held_ticks: torch.Tensor   # pending-query-ticks (backlog integral)
    wire_backlog: torch.Tensor  # wire rows still deferred after the tick


QSTAT_FIELDS = tuple(f.name for f in fields(QueryStats))


def wire_width(d: int) -> int:
    """Packed row width of the QueryBatch wire lane (dist/wire.py)."""
    return lane_width(empty_query_batch(1, d))


def init_query_state(n_parts: int, query_cap: int, d: int, device,
                     wire_defer_rows: int = 0) -> QueryState:
    """wire_defer_rows: this rank's rows of the wire lane's defer ring (0
    off a capped mesh)."""
    zi = lambda: torch.zeros((n_parts, query_cap), dtype=torch.int64,
                             device=device)
    zb = lambda: torch.zeros((n_parts, query_cap), dtype=torch.bool,
                             device=device)
    return QueryState(
        qid=zi(), kind=zi(), slot=zi(), part2=zi(), slot2=zi(),
        consistent=zb(), ok=zb(), issue=zi(),
        vec=torch.zeros((n_parts, query_cap, d), dtype=torch.float32,
                        device=device),
        pending=zb(),
        wire_defer=torch.zeros((wire_defer_rows, wire_width(d)),
                               dtype=torch.float32, device=device),
        wire_defer_ok=torch.zeros((wire_defer_rows,), dtype=torch.bool,
                                  device=device))


def zero_query_stats(device) -> QueryStats:
    z = torch.zeros((), dtype=torch.int64, device=device)
    return QueryStats(**{f: z for f in QSTAT_FIELDS})


def add_query_stats(a: QueryStats, b: QueryStats) -> QueryStats:
    return QueryStats(**{f: getattr(a, f) + getattr(b, f)
                         for f in QSTAT_FIELDS})


def _leaf(a: np.ndarray, device):
    return a if device is None else torch.as_tensor(a).to(device)


def empty_query_batch(cap: int, d: int, device=None) -> QueryBatch:
    """An all-invalid batch; device=None keeps numpy leaves (super-tick
    staging)."""
    zi = lambda: _leaf(np.zeros((cap,), np.int64), device)
    zb = lambda: _leaf(np.zeros((cap,), bool), device)
    return QueryBatch(qid=zi(), kind=zi(), part=zi(), slot=zi(), part2=zi(),
                      slot2=zi(), consistent=zb(), ok=zb(), issue=zi(),
                      vec=_leaf(np.zeros((cap, d), np.float32), device),
                      valid=zb())


def query_batch_from_numpy(rows: dict, cap: int, d: int,
                           device=None) -> QueryBatch:
    """rows: {qid, kind, part, slot, part2, slot2, consistent, issue}
    numpy columns (vec is zero on admission; ok starts True)."""
    n = len(rows["qid"])
    if n > cap:
        raise ValueError(f"query batch overflow: {n} rows > capacity {cap}")

    def pad(a, dtype=np.int64):
        out = np.zeros((cap,), dtype)
        out[:n] = a
        return _leaf(out, device)

    first = np.arange(cap) < n
    return QueryBatch(qid=pad(rows["qid"]), kind=pad(rows["kind"]),
                      part=pad(rows["part"]), slot=pad(rows["slot"]),
                      part2=pad(rows["part2"]), slot2=pad(rows["slot2"]),
                      consistent=pad(rows["consistent"], bool),
                      ok=_leaf(first.copy(), device),
                      issue=pad(rows["issue"]),
                      vec=_leaf(np.zeros((cap, d), np.float32), device),
                      valid=_leaf(first, device))


# ===================================================== device-side stages

def admit(qs: QueryState, qb: QueryBatch, part0):
    """Land incoming query records in free pending-table slots.

    Each part ranks its valid arrivals by record order (a cumsum over a
    one-hot [C, P] membership) and gives them its free slots in ascending
    order, so the slot of every query is the JAX package's whatever the
    router, driver or backend. Arrivals beyond the free capacity are
    dropped; the returned mask turns them into ok=False answer rows.

    Returns (new state, n_admitted 0-d int64, dropped mask [C])."""
    P_loc, Q = qs.qid.shape
    dev = qs.qid.device
    lp = qb.part - part0
    ok = qb.valid & (lp >= 0) & (lp < P_loc)
    member = (torch.where(ok, lp, P_loc)[:, None]
              == torch.arange(P_loc, device=dev)[None, :])        # [C, P]
    rank = torch.cumsum(member.to(torch.int64), dim=0) - 1
    r = torch.where(member, rank, 0).sum(dim=1)                   # [C]
    # free slot ids per part, ascending (occupied slots sort to the tail)
    free = torch.sort(torch.where(
        qs.pending, Q, torch.arange(Q, device=dev)[None, :]), dim=1).values
    dest = free[torch.clamp(lp, 0, P_loc - 1), torch.clamp(r, max=Q - 1)]
    admitted = ok & (r < Q) & (dest < Q)
    flat = torch.where(admitted, lp * Q + dest, P_loc * Q)

    def scat(tbl, val):
        return scatter_set(tbl.reshape(P_loc * Q), flat,
                           val).reshape(P_loc, Q)

    d = qs.vec.shape[-1]
    new = replace(
        qs, qid=scat(qs.qid, qb.qid), kind=scat(qs.kind, qb.kind),
        slot=scat(qs.slot, qb.slot), part2=scat(qs.part2, qb.part2),
        slot2=scat(qs.slot2, qb.slot2),
        consistent=scat(qs.consistent, qb.consistent),
        ok=scat(qs.ok, qb.ok), issue=scat(qs.issue, qb.issue),
        vec=scatter_set(qs.vec.reshape(P_loc * Q, d), flat,
                        qb.vec).reshape(P_loc, Q, d),
        pending=scat(qs.pending, admitted))
    return new, admitted.sum(), ok & ~admitted


def _drop_answers(qb: QueryBatch, dropped, now, d: int) -> AnswerBatch:
    """Admission-overflow records as ok=False answer rows: the client
    keeps a retriable qid instead of a leaked one."""
    C = qb.valid.shape[0]
    dev = qb.valid.device
    return AnswerBatch(
        qid=qb.qid,
        kind=torch.where(qb.kind == KIND_LINK_TAIL, KIND_LINK, qb.kind),
        ok=torch.zeros((C,), dtype=torch.bool, device=dev),
        tick=now.expand(C), issue=qb.issue,
        vec=torch.zeros((C, d), dtype=torch.float32, device=dev),
        score=torch.zeros((C,), dtype=torch.float32, device=dev),
        valid=dropped)


def _target(qs: QueryState, N: int):
    """Flat [P*Q] sink row of every pending slot's target."""
    P_loc, Q = qs.qid.shape
    return (torch.arange(P_loc, device=qs.qid.device)[:, None] * N
            + torch.clamp(qs.slot, 0, N - 1)).reshape(-1)


def _plane_work(qs: QueryState, layer_states, router=None,
                extra_work=None):
    """The shared inputs of both silence gates: per-row clean flags (no
    red/fwd pending at any layer) and the local pending-work count — the
    same `termination.pending_work` the quiescence gates use, so the
    consistent-snapshot guarantee and flush termination agree on what is
    in flight. On a 2-D mesh each stage holds only its layers' states, so
    the dirty flags are OR'd over the stage axis, and `extra_work`
    carries the inter-stage ring occupancy."""
    P_loc, N = layer_states[0].red_pending.shape
    dirty = torch.zeros((P_loc, N), dtype=torch.bool,
                        device=qs.qid.device)
    for ls in layer_states:
        dirty = dirty | ls.red_pending | ls.fwd_pending
    if router is not None and router.n_stages > 1:
        dirty = router.psum_stage(dirty.to(torch.int32)) > 0
    return (~dirty.reshape(P_loc * N),
            pending_work(layer_states, qs, extra_work))


def query_admit_stage(qs: QueryState, qb: QueryBatch, layer_states, sink,
                      sink_seen, router, batch_work, extra_work=None):
    """START-of-tick half of the query plane (before the layer ticks).

    1. admit the host's new queries (replicated batch, local filter);
    2. link head hop: ready KIND_LINK rows gather h_u from the
       start-of-tick sink and emit a KIND_LINK_TAIL wire record to the
       second endpoint's master part. The wire batch rides layer 0's
       round-B exchange and reaches `query_answer_stage` the same tick.

    Consistent heads fire only at a START-silent tick: no pending work
    anywhere (`router.psum_vote`) and an empty update batch
    (`batch_work`, a 0-d bool), when nothing can move during the tick.
    On a capped mesh a head fires only if the wire's defer ring could
    hold its tail were nothing shipped, so no tail is ever dropped.

    Returns (new state, wire QueryBatch [P_loc*Q], admission-drop mask,
    n_admitted). Q == 0 returns (qs, None, None, 0)."""
    P_loc, Q = qs.qid.shape
    dev = qs.qid.device
    if Q == 0:
        return qs, None, None, torch.zeros((), dtype=torch.int64, device=dev)
    part0 = router.part0()
    d = qs.vec.shape[-1]
    N = sink.shape[1]
    sink_flat = sink.reshape(P_loc * N, d)
    seen_flat = sink_seen.reshape(P_loc * N)
    clean_flat, work = _plane_work(qs, layer_states, router, extra_work)
    silent_start = (router.psum_vote(work) == 0) & ~batch_work

    qs, n_adm, drop = admit(qs, qb, part0)

    tgt = _target(qs, N)
    fire_head = (qs.pending & (qs.kind == KIND_LINK)
                 & (~qs.consistent
                    | (clean_flat[tgt] & silent_start).reshape(P_loc, Q)))
    K = qs.wire_defer_ok.shape[0]
    if K:
        # wire-ring headroom gate: heads past the ring's free rows wait
        free = K - qs.wire_defer_ok.sum()
        fh_flat = fire_head.reshape(-1)
        head_rank = torch.cumsum(fh_flat.to(torch.int64), dim=0) - 1
        fire_head = (fh_flat & (head_rank < free)).reshape(P_loc, Q)
    fh = fire_head.reshape(-1)
    zeros = torch.zeros((P_loc * Q,), dtype=torch.int64, device=dev)
    wire = QueryBatch(
        qid=qs.qid.reshape(-1),
        kind=torch.full((P_loc * Q,), KIND_LINK_TAIL, dtype=torch.int64,
                        device=dev),
        part=qs.part2.reshape(-1), slot=qs.slot2.reshape(-1),
        part2=zeros, slot2=zeros, consistent=qs.consistent.reshape(-1),
        ok=qs.ok.reshape(-1) & seen_flat[tgt], issue=qs.issue.reshape(-1),
        vec=torch.where(fh[:, None], sink_flat[tgt], 0.0), valid=fh)
    qs = replace(qs, pending=qs.pending & ~fire_head)
    return qs, wire, drop, n_adm


def query_answer_stage(qs: QueryState, wire_d, qb: QueryBatch, drop1,
                       n_adm, layer_states, sink, sink_seen, now,
                       stats_all, router, extra_work=None):
    """END-of-tick half, after the sink update.

    1. admit the delivered wire records (link tails, possibly carried
       over from an earlier tick by the wire lane's defer ring);
    2. answer: ready KIND_EMBED rows gather the sink row, ready
       KIND_LINK_TAIL rows fire <vec, h_v>; answered slots free. Rows
       dropped by a full pending table answer ok=False.

    Readiness: stale_ok rows always; consistent rows at clean targets of
    an end-of-tick silent tick: no message moved (the reduced TickStats)
    and no pending work anywhere (`router.psum_vote`).

    Returns (new state, AnswerBatch [P_loc*Q + C_adm + |wire_d|],
    QueryStats summed over the ranks in one collective). Q == 0 returns
    (qs, None, None)."""
    P_loc, Q = qs.qid.shape
    if Q == 0:
        return qs, None, None
    dev = qs.qid.device
    d = qs.vec.shape[-1]
    part0 = router.part0()
    N = sink.shape[1]
    sink_flat = sink.reshape(P_loc * N, d)
    seen_flat = sink_seen.reshape(P_loc * N)
    clean_flat, timers = _plane_work(qs, layer_states, router, extra_work)
    moved = torch.zeros((), dtype=torch.int64, device=dev)
    for s in stats_all:
        moved = moved + s.emitted + s.reduce_msgs + s.broadcast_msgs
    if router.n_stages > 1:
        # on a 2-D mesh the stats cover this stage's layers only
        moved = router.psum_stage(moved)
    silent = (moved == 0) & (router.psum_vote(timers) == 0)

    qs, _, drop2 = admit(qs, wire_d, part0)   # tail re-admits: not counted

    tgt = _target(qs, N)
    fire = (qs.pending & (qs.kind != KIND_LINK)
            & (~qs.consistent | (clean_flat[tgt] & silent).reshape(P_loc, Q)))
    ff = fire.reshape(-1)
    h = sink_flat[tgt]
    is_tail = (qs.kind == KIND_LINK_TAIL).reshape(-1)
    score = (qs.vec.reshape(P_loc * Q, d) * h).sum(dim=-1)
    ans = AnswerBatch(
        qid=qs.qid.reshape(-1),
        kind=torch.where(is_tail, KIND_LINK, qs.kind.reshape(-1)),
        ok=ff & seen_flat[tgt] & (qs.ok.reshape(-1) | ~is_tail),
        tick=now.expand(P_loc * Q), issue=qs.issue.reshape(-1),
        vec=torch.where((ff & ~is_tail)[:, None], h, 0.0),
        score=torch.where(ff & is_tail, score, 0.0), valid=ff)
    qs = replace(qs, pending=qs.pending & ~fire)

    # overflow-dropped admissions (host batch + wire) answer ok=False
    parts = (ans, _drop_answers(qb, drop1, now, d),
             _drop_answers(wire_d, drop2, now, d))
    ans = AnswerBatch(**{f.name: torch.cat([getattr(a, f.name)
                                            for a in parts])
                         for f in fields(AnswerBatch)})
    # the plane's counters reduced over the ranks in ONE collective
    g = router.psum(torch.stack([
        n_adm, fire.sum(), drop1.sum() + drop2.sum(), qs.pending.sum(),
        qs.wire_defer_ok.sum()]).to(torch.int64))
    stats = QueryStats(**{f: g[i] for i, f in enumerate(QSTAT_FIELDS)})
    return qs, ans, stats
