"""Host-side online-training loop: interleave graph updates and labels.

Counterpart of `repro/serve/train_session.py`. `TrainSession` wraps a
training-enabled `D3Pipeline` (cfg.train_cap > 0 and a TrainConfig) and
drives either pipeline driver with label admissions aboard:

  * driver="tick"  — queued labels admit in the next micro-tick
    (`advance(edges, feats)`);
  * driver="super" — `advance_super` stages T micro-ticks and spreads the
    queued labels over them, so the windowed training step runs inside
    the same launch as the update stream: still one host sync a
    super-tick.

Labels wait in a host-side queue until a tick has budget
(`capacities().train_cap` a tick); vids the partitioner has never seen
are dropped at admission (there is no master slot to label). Progress —
loss, gradient norm, fired steps — is read on demand with
`train_stats()`, which adds the label backlog. Nothing here stops the
stream, unlike the halt-flush `TrainingCoordinator`.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TrainSession:
    pipe: object                                 # a training-enabled D3Pipeline
    driver: str = "super"                        # "super" | "tick"
    super_ticks: int = 8                         # T per device launch
    _queue: list = field(default_factory=list)   # un-admitted (vid, gold)

    def __post_init__(self):
        if getattr(self.pipe, "train_cfg", None) is None:
            raise ValueError(
                "TrainSession needs a training-enabled pipeline: set "
                "PipelineConfig.train_cap > 0 and pass "
                "D3Pipeline(..., train=TrainConfig(...))")
        if self.driver not in ("super", "tick"):
            raise ValueError(f"driver={self.driver!r}: 'super' or 'tick'")

    # ------------------------------------------------------------- labels
    def observe_labels(self, labels):
        """Enqueue ground-truth labels: {vid: gold_class} or [(vid,
        gold_class), ...]; they admit on the next advance, oldest first."""
        pairs = labels.items() if isinstance(labels, dict) else labels
        self._queue.extend((int(vid), int(y)) for vid, y in pairs)

    # ------------------------------------------------------------ advance
    def advance(self, edges=None, feats=None, window=None):
        """One micro-tick (driver='tick'): queued labels admit now, up to
        the per-tick label budget (the rest stay queued)."""
        cap = self.pipe.cfg.capacities().train_cap
        lab, self._queue = self._queue[:cap], self._queue[cap:]
        return self.pipe.tick(edges, feats, window=window,
                              labels=lab or None)

    def advance_super(self, edge_chunks=None, feat_chunks=None, T=None,
                      window=None, quiet0: int = 0):
        """One super-tick (driver='super'): queued labels spread over the
        launch's T micro-ticks, earliest first, at most
        `capacities().train_cap` a tick; labels past the launch's budget
        stay queued."""
        edge_chunks = list(edge_chunks) if edge_chunks is not None else []
        feat_chunks = list(feat_chunks) if feat_chunks is not None else []
        n = max(len(edge_chunks), len(feat_chunks), 1)
        T = int(T) if T is not None else n
        per_tick = self.pipe.cfg.capacities().train_cap
        lab = self._queue[:per_tick * T]
        self._queue = self._queue[per_tick * T:]
        l_chunks = [lab[i * per_tick:(i + 1) * per_tick] for i in range(T)]
        return self.pipe.run_super_tick(edge_chunks, feat_chunks, T=T,
                                        window=window, quiet0=quiet0,
                                        label_chunks=l_chunks)

    def step(self, edges=None, feats=None, **kw):
        """Driver-agnostic advance: one tick or one super-tick."""
        if self.driver == "tick":
            return self.advance(edges, feats, **kw)
        e = [edges] if edges is not None else None
        f = [feats] if feats is not None else None
        return self.advance_super(e, f, T=self.super_ticks, **kw)

    def flush(self, max_ticks: int = 128):
        """Drain: the label backlog admits first, then the pipeline's
        flush runs to quiescence, so the final fire at the quiescent fixed
        point sees every label submitted so far."""
        ran = 0
        while self._queue and ran < max_ticks:
            if self.driver == "tick":
                self.advance()
                ran += 1
            else:
                self.advance_super(T=self.super_ticks)
                ran += self.super_ticks
        remaining = max(max_ticks - ran, 8)
        if self.driver == "tick":
            return ran + self.pipe.flush(max_ticks=remaining)
        return ran + self.pipe.flush_super(max_ticks=remaining,
                                           T=self.super_ticks)

    # ------------------------------------------------------------ results
    @property
    def backlog(self) -> int:
        """Labels submitted but not yet admitted on the device."""
        return len(self._queue)

    def train_stats(self) -> dict:
        """Device training diagnostics (one host read) + label backlog."""
        out = dict(self.pipe.train_stats())
        out["backlog"] = self.backlog
        return out
