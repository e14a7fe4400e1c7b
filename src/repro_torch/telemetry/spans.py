"""The launch log: host spans and counters of every driver launch, and the
program's profiler ranges.

Always on, host clock only. A driver call opens one launch record
(`launch`) and moves it through the five contiguous phases of a launch:

  stage    : the host builds the T ticks' padded batches (partitioning,
             cold features, the query and label resolves, packing);
  upload   : packing the valid rows, pinning, issuing the host-to-device
             copies and building the padded device lanes (0 on the
             per-tick driver, whose uploads happen in packing);
  dispatch : the host enqueues the T tick programs, up to the one read;
  wait     : the host blocked in the read of the launch's stats;
  post     : unstacking the read, answers and metrics after it.

Each boundary is ONE `perf_counter` read that ends one phase and starts
the next, so the five phases sum to the record's wall exactly. Inside a
phase, `span(name)` adds the seconds between its boundaries to the open
record under `name` (staging's `stage.*` children), and `count(name, n)`
adds to its counters. A closed record joins a ring of the last `RING`
records of the process; `records()` hands them out as plain dicts, oldest
first. `build` records one pipeline's construction the same way, with
the kind "build".

While torch's profiler is on, every phase and span also enters
`record_function("d3." + name)`, and `region(name)` gives the tick
program's fixed-name ranges, so a profiler trace shows each program
phase on the host (user_annotation) and over the kernels it launched
(gpu_user_annotation). With the profiler off no range is entered: the
cost of a launch's record is its clock reads and dict updates, and it
reads no device value.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

RING = 1024
PREFIX = "d3."
PHASES = ("stage", "upload", "dispatch", "wait", "post")
COUNTS = ("edges", "feats", "queries", "labels", "upload.bytes",
          "upload.live_bytes", "upload.lane_bytes")

_ring: collections.deque = collections.deque(maxlen=RING)
_seq = itertools.count()
_pipelines = itertools.count()
_open = threading.local()          # .rec: the innermost open record
_NULL = contextlib.nullcontext()


def new_pipeline() -> int:
    """A process-unique serial for a pipeline's records (the newest
    pipeline has the largest)."""
    return next(_pipelines)


def region(name: str):
    """A profiler range `d3.<name>` while the profiler is on, else a
    context that does nothing."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return _NULL


def _enter(name: str):
    if not _profiler._is_profiler_enabled:
        return None
    rf = _profiler.record_function(PREFIX + name)
    rf.__enter__()
    return rf


def _exit(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


class Record:
    """One open launch (or build) record; `close` appends it to the
    ring."""

    def __init__(self, kind: str, pipeline: int, tick: int, T: int,
                 phase: str | None):
        self.kind, self.pipeline, self.tick, self.T = kind, pipeline, tick, T
        self.seq = next(_seq)
        is_launch = kind == "launch"
        self.spans = dict.fromkeys(PHASES, 0.0) if is_launch else {}
        self.counts = dict.fromkeys(COUNTS, 0) if is_launch else {}
        self.wall_s = 0.0
        self.profiled = _profiler._is_profiler_enabled
        self._outer_rf = _enter("launch" if is_launch else "pipeline.build")
        self._parent = getattr(_open, "rec", None)
        _open.rec = self
        self._phase, self._rf = None, None
        self._t0 = self._t = time.perf_counter()
        if phase is not None:
            self._start(phase, self._t0)

    def _start(self, name: str, t: float) -> None:
        self._phase, self._t = name, t
        self._rf = _enter(name)
        self.profiled |= self._rf is not None

    def _end(self, t: float) -> None:
        if self._phase is not None:
            _exit(self._rf)
            self.spans[self._phase] += t - self._t
            self._phase = self._rf = None

    def phase(self, name: str) -> None:
        """End the running phase and start `name` at one clock read."""
        t = time.perf_counter()
        self._end(t)
        self._start(name, t)

    def closed_s(self) -> float:
        """Seconds of the phases ended so far (no clock read)."""
        return sum(self.spans[p] for p in PHASES)

    def host_s(self) -> float:
        """The launch's host staging: its `stage` and `upload` phases."""
        return self.spans["stage"] + self.spans["upload"]

    def close(self) -> None:
        t = time.perf_counter()
        self._end(t)
        self.wall_s = t - self._t0
        if self.kind == "build":
            self.spans["pipeline.build"] = self.wall_s
        _exit(self._outer_rf)
        self.profiled |= self._outer_rf is not None
        _open.rec = self._parent
        _ring.append(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def as_dict(self) -> dict:
        return {"kind": self.kind, "pipeline": self.pipeline,
                "seq": self.seq, "tick": self.tick, "T": self.T,
                "profiled": self.profiled, "wall_s": self.wall_s,
                "spans": dict(self.spans), "counts": dict(self.counts)}


def launch(pipeline: int, tick: int, T: int) -> Record:
    """Open a driver launch of T ticks from `tick`; its `stage` phase
    starts now. Use as a context manager: leaving it closes the record."""
    return Record("launch", pipeline, tick, T, "stage")


def build(pipeline: int) -> Record:
    """Open the record of one pipeline's construction."""
    return Record("build", pipeline, 0, 0, None)


def current() -> Record | None:
    """The innermost open record of this thread, or None."""
    return getattr(_open, "rec", None)


class span:
    """Adds the seconds inside the block to the open record under `name`
    (a no-op outside a launch), inside `d3.<name>` while profiling."""

    __slots__ = ("name", "rec", "t", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = getattr(_open, "rec", None)
        self.rf = _enter(self.name)
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        _exit(self.rf)
        if self.rec is not None:
            s = self.rec.spans
            s[self.name] = s.get(self.name, 0.0) + t - self.t
            self.rec.profiled |= self.rf is not None


def phase(name: str) -> None:
    """Move the open launch to phase `name` (outside a launch: a
    no-op)."""
    rec = getattr(_open, "rec", None)
    if rec is not None and rec.kind == "launch":
        rec.phase(name)


def count(name: str, n: int) -> None:
    """Add n to the open record's counter `name` (outside a launch: a
    no-op)."""
    rec = getattr(_open, "rec", None)
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + int(n)


def records() -> list:
    """The ring's records as plain dicts, oldest first."""
    return [r.as_dict() for r in list(_ring)]


def clear() -> None:
    _ring.clear()
