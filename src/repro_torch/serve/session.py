"""Host-side serving loop: interleave graph updates and point queries.

Counterpart of `repro/serve/session.py`. `ServeSession` wraps a
query-enabled `D3Pipeline` (cfg.query_cap > 0) and drives EITHER pipeline
driver with queries aboard:

  * driver="tick"  — per-tick reference path: queued submissions admit in
    the very next micro-tick (`advance(edges, feats)`);
  * driver="super" — the super-tick driver: `advance_super` stages T
    update micro-ticks and spreads the queued submissions over them, so
    queries admit while updates are still flowing through the same
    device launch. Answers come back in the launch's single host read.

The session keeps the host-side truth the device never sees: wall-clock
enqueue times per qid. Every harvested answer gets an end-to-end
enqueue->answer latency (submission to host-visible result, including the
super-tick batching delay) plus tick-domain staleness (answer_tick -
issue_tick). `latency_stats()` reports p50/p95/p99 summaries and, with the telemetry
plane on, stamps them into the pipeline's trace meta.

Degraded-mode serving: under overload or mid-recovery the session sheds
instead of stalling —

  * `degrade(reason)` declares degraded mode: `stale_ok` submissions keep
    flowing while `consistent` submissions are HELD in the host queue
    until `restore_normal()` (consistent queries already admitted ride
    the device QueryState and answer normally);
  * `shed_threshold` bounds `outstanding`: submissions beyond it get an
    immediate ok=False shed answer instead of unbounded queue growth;
  * `max_retries > 0` gives retriable ok=False answers (admission
    overflow, endpoint not yet materialized) an in-session bounded
    retry: same qid resubmitted after an exponential tick backoff
    (`retry_backoff_ticks * 2**attempt`), capped at `max_retries`
    attempts, retry state capped by the `max_retained` bound.

All of it is observable: `latency_stats()` carries retried / shed /
retry_exhausted / degraded_ticks counters and the declared reason.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.query import KIND_EMBED, KIND_LINK


@dataclass
class Answer:
    """One resolved point query (host view)."""
    qid: int
    kind: int                 # KIND_EMBED | KIND_LINK
    ok: bool                  # False: endpoint never materialized, the
                              # vertex was unknown, or the pending table
                              # overflowed (re-submit in that case)
    vec: np.ndarray           # embedding (KIND_EMBED; zeros otherwise)
    score: float              # link score (KIND_LINK; 0.0 otherwise)
    issue_tick: int
    answer_tick: int
    latency_s: float          # wall-clock enqueue -> host-visible answer;
                              # None for adopted answers (queries restored
                              # from a checkpoint another session issued)

    @property
    def staleness_ticks(self) -> int:
        return self.answer_tick - self.issue_tick


@dataclass
class _PendingMeta:
    enqueued_at: float
    kind: int
    row: tuple = None         # (kind, u, v, consistent) — the original
                              # submission, kept so a failed answer can
                              # be resubmitted under the same qid
    attempts: int = 0         # bounded-retry attempts consumed so far


@dataclass
class ServeSession:
    pipe: object                                   # a query-enabled D3Pipeline
    driver: str = "super"                          # "super" | "tick"
    super_ticks: int = 8                           # T per device launch
    qid_base: int = 0                              # first qid this session
                                                   # assigns — hand over the
                                                   # previous session's
                                                   # _next_qid when restoring
                                                   # a checkpoint that holds
                                                   # its pending queries
    max_retained: int = 65536                      # retention bound on
                                                   # `answers`: a long-lived
                                                   # serving loop would grow
                                                   # the dict per answer
                                                   # forever; beyond the
                                                   # bound the OLDEST
                                                   # harvested answers are
                                                   # evicted (dict insertion
                                                   # order). Read results
                                                   # promptly or raise it.
    max_retries: int = 0                           # bounded in-session retry
                                                   # of ok=False answers
                                                   # (0 = off)
    retry_backoff_ticks: int = 2                   # exponential backoff base:
                                                   # attempt k waits
                                                   # base * 2**(k-1) ticks
    shed_threshold: int | None = None              # outstanding bound: beyond
                                                   # it new submissions shed
                                                   # (immediate ok=False)
    answers: dict = field(default_factory=dict)    # qid -> Answer
    counters: dict = field(default_factory=lambda: {
        "retried": 0, "shed": 0, "retry_exhausted": 0,
        "degraded_ticks": 0})
    _queue: list = field(default_factory=list)     # un-admitted submissions
    _meta: dict = field(default_factory=dict)      # qid -> _PendingMeta
    _retry_queue: list = field(default_factory=list)  # (due_tick, qid)
    _degraded: str | None = None                   # declared reason or None
    _next_qid: int = 0

    def __post_init__(self):
        if self.pipe.cfg.query_cap <= 0:
            raise ValueError(
                "ServeSession needs a query-enabled pipeline: set "
                "PipelineConfig.query_cap > 0 (the query plane is "
                "compiled away at query_cap=0)")
        if self.driver not in ("super", "tick"):
            raise ValueError(f"driver={self.driver!r}: 'super' or 'tick'")
        if self.max_retained <= 0:
            raise ValueError(
                f"max_retained={self.max_retained} must be > 0 (it bounds "
                "the retained-answer dict, not whether answers arrive)")
        self._next_qid = max(self._next_qid, int(self.qid_base))

    # --------------------------------------------------------- degradation
    @property
    def degraded(self) -> str | None:
        """The declared degraded-mode reason, or None when normal."""
        return self._degraded

    def degrade(self, reason: str = "recovery") -> None:
        """Declare degraded mode (overload / mid-recovery): `stale_ok`
        submissions keep admitting, `consistent` submissions are held in
        the host queue until `restore_normal()`. Queries already admitted
        are untouched — held consistent queries ride the device state
        (incl. across a `pipe.reshard`) and answer normally."""
        self._degraded = str(reason)

    def restore_normal(self) -> None:
        self._degraded = None

    def _shed(self, qid: int, kind: int) -> None:
        self.counters["shed"] += 1
        self.answers[qid] = Answer(
            qid=qid, kind=kind, ok=False,
            vec=np.zeros(getattr(self.pipe, "d_out", 0), np.float32),
            score=0.0, issue_tick=-1, answer_tick=-1, latency_s=None)

    def _release_due_retries(self) -> None:
        """Move retries whose backoff expired to the queue front (same
        qid, original enqueue time — end-to-end latency stays honest)."""
        if not self._retry_queue:
            return
        now = self.pipe.now
        due = sorted(x for x in self._retry_queue if x[0] <= now)
        self._retry_queue = [x for x in self._retry_queue if x[0] > now]
        released = [(qid,) + self._meta[qid].row for _, qid in due
                    if qid in self._meta]
        self._queue = released + self._queue

    def _take(self, n: int) -> list:
        """Dequeue up to n submissions for admission; degraded mode holds
        `consistent` submissions back (row = (qid, kind, u, v, cons))."""
        if self._degraded is None:
            q, self._queue = self._queue[:n], self._queue[n:]
            return q
        take, keep = [], []
        for row in self._queue:
            if len(take) < n and not row[4]:
                take.append(row)
            else:
                keep.append(row)
        self._queue = keep
        return take

    # ------------------------------------------------------------- submit
    def _submit(self, rows) -> list:
        now = time.perf_counter()
        qids = []
        for row in rows:
            qid = self._next_qid
            self._next_qid += 1
            qids.append(qid)
            if (self.shed_threshold is not None
                    and self.outstanding >= self.shed_threshold):
                self._shed(qid, row[0])
                continue
            self._queue.append((qid,) + row)
            self._meta[qid] = _PendingMeta(enqueued_at=now, kind=row[0],
                                           row=tuple(row))
        return qids

    def submit_embed(self, vids, consistent: bool = False) -> list:
        """Enqueue embedding reads; returns the assigned qids."""
        return self._submit([(KIND_EMBED, int(v), 0, consistent)
                             for v in np.asarray(vids).reshape(-1)])

    def submit_link(self, pairs, consistent: bool = False) -> list:
        """Enqueue link-score queries for (u, v) pairs; returns qids."""
        return self._submit([(KIND_LINK, int(u), int(v), consistent)
                             for u, v in pairs])

    # ------------------------------------------------------------ advance
    def advance(self, edges=None, feats=None, window=None):
        """One micro-tick (driver='tick'): queued submissions admit now,
        up to the per-tick admission budget (the rest stay queued)."""
        cap = self.pipe.cfg.capacities().query_admissions
        self._release_due_retries()
        q = self._take(cap)
        if self._degraded is not None:
            self.counters["degraded_ticks"] += 1
        stats = self.pipe.tick(edges, feats, window=window,
                               queries=q or None)
        self._harvest()
        return stats

    def advance_super(self, edge_chunks=None, feat_chunks=None,
                      T=None, window=None, quiet0: int = 0):
        """One super-tick (driver='super'): queued submissions spread
        over the launch's T micro-ticks (earliest first, at most
        `capacities().query_admissions` per tick), so admission
        interleaves with the update stream on device. Submissions beyond
        the launch's admission budget stay queued for the next advance —
        they never overflow a tick's fixed-capacity query batch."""
        edge_chunks = list(edge_chunks) if edge_chunks is not None else []
        feat_chunks = list(feat_chunks) if feat_chunks is not None else []
        n = max(len(edge_chunks), len(feat_chunks), 1)
        T = int(T) if T is not None else n
        per_tick = self.pipe.cfg.capacities().query_admissions
        self._release_due_retries()
        q = self._take(per_tick * T)
        if self._degraded is not None:
            self.counters["degraded_ticks"] += T
        q_chunks = [q[i * per_tick: (i + 1) * per_tick] for i in range(T)]
        out = self.pipe.run_super_tick(edge_chunks, feat_chunks, T=T,
                                       window=window, quiet0=quiet0,
                                       query_chunks=q_chunks)
        self._harvest()
        return out

    def step(self, edges=None, feats=None, **kw):
        """Driver-agnostic advance: one tick or one super-tick."""
        if self.driver == "tick":
            return self.advance(edges, feats, **kw)
        e = [edges] if edges is not None else None
        f = [feats] if feats is not None else None
        return self.advance_super(e, f, T=self.super_ticks, **kw)

    def flush(self, max_ticks: int = 128):
        """Drain the pipeline (and any held consistent queries answer at
        the first silent tick)."""
        if self.driver == "tick":
            ran = self.pipe.flush(max_ticks=max_ticks)
        else:
            ran = self.pipe.flush_super(max_ticks=max_ticks,
                                        T=self.super_ticks)
        self._harvest()
        return ran

    # ------------------------------------------------------------ results
    def _harvest(self):
        cols = self.pipe.drain_answers()
        t_now = time.perf_counter()
        for i in range(len(cols["qid"])):
            qid = int(cols["qid"][i])
            ok = bool(cols["ok"][i])
            meta = self._meta.get(qid)
            if (not ok and self.max_retries > 0 and meta is not None
                    and meta.row is not None
                    and meta.attempts < self.max_retries):
                # bounded in-session retry: resubmit the same qid after
                # an exponential tick backoff instead of surfacing the
                # retriable failure (admission overflow / endpoint not
                # yet materialized) to the client
                meta.attempts += 1
                due = int(self.pipe.now) + self.retry_backoff_ticks * (
                    2 ** (meta.attempts - 1))
                self._retry_queue.append((due, qid))
                self.counters["retried"] += 1
                # retry state rides the max_retained bound too — beyond
                # it the OLDEST retry gives up with a final failed answer
                while len(self._retry_queue) > self.max_retained:
                    _, old = self._retry_queue.pop(0)
                    m = self._meta.pop(old, None)
                    self.counters["retry_exhausted"] += 1
                    self.answers[old] = Answer(
                        qid=old, kind=m.kind if m else 0, ok=False,
                        vec=np.zeros(getattr(self.pipe, "d_out", 0),
                                     np.float32),
                        score=0.0, issue_tick=-1, answer_tick=-1,
                        latency_s=None)
                continue
            self._meta.pop(qid, None)
            if not ok and meta is not None and meta.attempts > 0:
                self.counters["retry_exhausted"] += 1
            self.answers[qid] = Answer(
                qid=qid, kind=int(cols["kind"][i]), ok=ok,
                vec=np.asarray(cols["vec"][i]),
                score=float(cols["score"][i]),
                issue_tick=int(cols["issue"][i]),
                answer_tick=int(cols["tick"][i]),
                # adopted answers (restored pending queries another session
                # issued) have no enqueue time — excluded from percentiles
                latency_s=(t_now - meta.enqueued_at) if meta else None)
        # retention bound: evict the oldest harvested answers (dict
        # preserves insertion order) so an always-on loop stays bounded
        overflow = len(self.answers) - self.max_retained
        if overflow > 0:
            for qid in list(self.answers)[:overflow]:
                del self.answers[qid]

    @property
    def outstanding(self) -> int:
        """Submitted but not yet answered (queued + held on device)."""
        return len(self._meta) + len(self._queue)

    def latency_stats(self) -> dict:
        """p50/p95/p99 end-to-end latency (ms) + staleness + counts.

        Latency AND staleness percentiles are computed over the SAME
        population: answers this session issued itself (latency_s set).
        Adopted answers (queries restored from another session's
        checkpoint, latency_s=None) have no enqueue time here, so mixing
        them into only one of the two distributions would silently skew
        the comparison — they are excluded from both and reported in the
        separate `adopted` count."""
        timed = [a for a in self.answers.values()
                 if a.latency_s is not None]
        degr = {"degraded": self._degraded, **self.counters}
        if not timed:
            return {"answered": len(self.answers),
                    "adopted": len(self.answers),
                    "outstanding": self.outstanding, **degr}
        lats = np.asarray([a.latency_s for a in timed])
        stale = np.asarray([a.staleness_ticks for a in timed])
        out = {
            "answered": len(self.answers),
            "adopted": len(self.answers) - len(timed),
            "outstanding": self.outstanding,
            **degr,
            "p50_ms": float(np.percentile(lats, 50) * 1e3),
            "p95_ms": float(np.percentile(lats, 95) * 1e3),
            "p99_ms": float(np.percentile(lats, 99) * 1e3),
            "staleness_ticks_p50": float(np.percentile(stale, 50)),
            "staleness_ticks_max": int(stale.max()),
        }
        # telemetry plane: the serving percentiles ride the trace meta, so
        # a saved trace carries them next to the occupancy rows
        if getattr(self.pipe, "trace", None) is not None:
            self.pipe.trace.annotate(
                serving_p50_ms=out["p50_ms"], serving_p95_ms=out["p95_ms"],
                serving_p99_ms=out["p99_ms"],
                serving_answered=out["answered"])
        return out
