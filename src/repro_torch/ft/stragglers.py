"""Straggler mitigation for the synchronous tick loop.

Counterpart of `repro/ft/stragglers.py`. With the telemetry plane on
(`PipelineConfig(telemetry=True)`) both pipeline drivers feed
`StragglerMitigator.observe_tick` every launch — the per-tick wall time
(super-tick wall / T on the super-tick driver) and the per-shard busy
proxies folded from `TickStats.busy` — through `D3Pipeline._trace_ticks`;
`D3Pipeline.parts_per_shard()` gives the work-steal planner its part map.

A straggling rank slows every lock-step collective. The module provides:

  * tick-deadline detection: an EWMA of tick wall times flags ticks (and,
    with per-shard busy proxies, the shards) that exceed k x the EWMA;
  * work-stealing re-map: persistent stragglers get logical parts moved to
    the fastest shards via an Alg. 5-compatible override table (keyed
    state moves with the part, as in an elastic rescale);
  * backup-task semantics for the host partitioner's chunks (speculative
    re-execution after a timeout): chunk ingestion is idempotent, since
    slots are allocated once and a replayed chunk hits the slot_of table.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerMitigator:
    n_shards: int
    ewma_alpha: float = 0.2
    threshold: float = 2.0            # x EWMA flags a straggler
    patience: int = 3                 # consecutive flags before re-map
    _ewma: float = 0.0
    _flags: np.ndarray = field(default=None)
    overrides: dict = field(default_factory=dict)   # logical part -> shard
    ticks_observed: int = 0           # observe_tick feed counter — lets
                                      # tests/telemetry assert the drivers
                                      # actually wire the mitigator in

    def __post_init__(self):
        if self._flags is None:
            self._flags = np.zeros(self.n_shards, np.int64)

    def observe_tick(self, wall_s: float, busy_per_shard: np.ndarray):
        """Feed one tick; returns list of shards flagged this tick.

        Flagged (slow) ticks do NOT update the EWMA baseline — otherwise a
        persistent straggler would poison its own detection threshold."""
        self.ticks_observed += 1
        busy_per_shard = np.asarray(busy_per_shard)
        flagged = []
        if self._ewma and wall_s > self.threshold * self._ewma \
                and busy_per_shard.sum() > 0:
            # attribute the slowdown to the busiest shard(s)
            worst = int(np.argmax(busy_per_shard))
            self._flags[worst] += 1
            flagged.append(worst)
        else:
            self._flags[:] = np.maximum(self._flags - 1, 0)
            self._ewma = (wall_s if self._ewma == 0.0 else
                          (1 - self.ewma_alpha) * self._ewma
                          + self.ewma_alpha * wall_s)
        return flagged

    def persistent_stragglers(self) -> list[int]:
        return [int(s) for s in np.nonzero(self._flags >= self.patience)[0]]

    def plan_work_steal(self, parts_per_shard: list[np.ndarray],
                        busy_per_shard: np.ndarray) -> dict:
        """Move half the straggler's logical parts to the least-busy shard.

        Returns {logical_part: new_shard} merged into self.overrides; the
        engine applies it as a routing override on top of Alg. 5 (keyed
        state moves with the part, same as rescale)."""
        stealers = np.argsort(busy_per_shard)
        for s in self.persistent_stragglers():
            victim_parts = parts_per_shard[s]
            give = victim_parts[: max(1, len(victim_parts) // 2)]
            target = int(stealers[0]) if int(stealers[0]) != s else int(
                stealers[1]) if len(stealers) > 1 else s
            for lp in give:
                self.overrides[int(lp)] = target
            self._flags[s] = 0
        return dict(self.overrides)


def speculative_chunks(chunk_ids: list[int], started_s: dict,
                       now_s: float, timeout_s: float) -> list[int]:
    """Backup-task planner for partitioner chunks: re-issue chunks that
    have been running longer than `timeout_s` (idempotent re-execution)."""
    return [c for c in chunk_ids
            if c in started_s and now_s - started_s[c] > timeout_s]
