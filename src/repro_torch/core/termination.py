"""Termination detection (paper §5.3).

Counterpart of `repro/core/termination.py`. The pipeline is quiescent
when, for `quiet_sweeps` consecutive ticks, no layer moved a message and
no layer holds pending work (window timers, routing defer rings, the
query plane's wire-lane backlog, and on a 2-D mesh the rows in flight
between stages). On a mesh the movement vote reads the already reduced
TickStats (on a 2-D mesh each stage's stats cover only its layers, so
they take one more sum over the stage axis) and the pending-work vote is
summed over every rank (`router.psum_vote`), so every rank sees the same
counter. Two observation paths:

  * per-tick (host): `TerminationCoordinator.observe` reads each tick's
    stats — one host sync per tick, fine for the reference driver;
  * super-tick (device): `quiet_update` advances a consecutive-quiet-tick
    counter on the device, read once per super-tick (`observe_flag`).
"""
from __future__ import annotations

import torch

from repro_torch.core.tick import has_work


def moved_msgs(tick_stats):
    """Total MOVEMENT of one layer's TickStats: emissions + reduces +
    broadcasts (the vote both observation paths share)."""
    return tick_stats.emitted + tick_stats.reduce_msgs \
        + tick_stats.broadcast_msgs


def pending_work(layer_states, queries=None, extra_work=None):
    """LOCAL in-flight-work count (0-d int64): layers with pending timers
    or occupied defer rings, plus the query plane's wire-lane backlog
    (occupied rows of its defer ring) when a QueryState is given, plus
    the caller's `extra_work` (the 2-D pipeline's inter-stage ring
    occupancy). Held `consistent` queries are not in-flight work.

    The single aggregation every quiescence and silence gate reads:
    `quiet_update`, `TerminationCoordinator.observe` and the query
    plane's gates (serve/query.py:_plane_work)."""
    work = torch.zeros((), dtype=torch.int64,
                       device=layer_states[0].feat.device)
    for ls in layer_states:
        work = work + has_work(ls).to(torch.int64)
    if queries is not None:
        work = work + queries.wire_defer_ok.sum()
    if extra_work is not None:
        work = work + extra_work
    return work


def quiet_update(quiet, layer_states, tick_stats, router=None,
                 queries=None, extra_work=None):
    """One on-device step of quiescence tracking: the consecutive quiet
    tick counter resets to 0 on any movement or pending work (summed over
    the ranks when a router is given; `queries` adds the wire backlog,
    `extra_work` the inter-stage ring's rows)."""
    if router is not None and router.n_stages > 1:
        moved = router.psum_stage(sum(moved_msgs(s) for s in tick_stats)) > 0
    else:
        moved = torch.zeros((), dtype=torch.bool, device=quiet.device)
        for s in tick_stats:
            moved = moved | (moved_msgs(s) > 0)
    work = pending_work(layer_states, queries, extra_work)
    if router is not None:
        work = router.psum_vote(work)
    busy = moved | (work > 0)
    return torch.where(busy, torch.zeros_like(quiet), quiet + 1)


class TerminationCoordinator:
    def __init__(self, quiet_sweeps: int = 2):
        self.quiet_sweeps = quiet_sweeps
        self._quiet = 0

    def seed_quiet(self) -> int:
        """Seed for a device-resident quiet counter when chaining
        super-ticks: quiescence streaks survive the host round-trip."""
        return self._quiet

    def observe(self, layer_states, tick_stats, router=None,
                queries=None, extra_work=None) -> bool:
        """Feed one tick's observations (host values; the per-layer stats
        of every layer); True once terminated. With a router the
        pending-work vote is summed over the ranks; `queries` (a
        QueryState) votes the wire backlog, `extra_work` the rank's
        inter-stage ring rows."""
        moved = any(int(moved_msgs(s)) for s in tick_stats)
        work = pending_work(layer_states, queries, extra_work)
        if router is not None:
            work = router.psum_vote(work)
        if moved or bool(work):
            self._quiet = 0
        else:
            self._quiet += 1
        return self._quiet >= self.quiet_sweeps

    def observe_flag(self, quiet_ticks: int) -> bool:
        """Feed a device-computed consecutive-quiet counter (it replaces,
        not adds to, the host count)."""
        self._quiet = int(quiet_ticks)
        return self._quiet >= self.quiet_sweeps
