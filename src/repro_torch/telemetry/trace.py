"""Trace recorder for the telemetry plane.

Counterpart of `repro/telemetry/trace.py`, and the same file format, so
each package loads the other's traces. With
`PipelineConfig(telemetry=True)` the pipeline appends ONE row per tick:
the per-plane occupancy gauges measured on the device (the [21] int row
that rides the drivers' one stats read), host wall timings, exact wire
bytes and the tick's ingest counts. `save()` writes a compressed `.npz`
(one int64 / float64 column per field plus the meta as one JSON blob:
config summary, caps, lane widths, schema version); `load_trace()`
checks the schema and hands the columns back as numpy arrays. The cost
model (`telemetry/cost_model.py`) fits per-plane cost coefficients from
a trace; the capacity advisor (`telemetry/advisor.py`) turns the
occupancy peaks into recommended capacities.

Device columns (`TRACE_DEVICE_COLS`, in the order the pipeline stacks
the occupancy row):

  emitted_final  : last layer's forward emissions (the events/s numerator)
  emitted_sum    : forward emissions summed over layers
  reduce_msgs    : round-B RMI records emitted (sum over layers)
  broadcast_msgs : round-A replica broadcasts (sum over layers)
  wire_rows      : live rows shipped on the all_to_all
  route_deferred : rows pushed into the defer rings this tick
  route_dropped  : rows lost to a FULL defer ring (0 when healthy)
  dropped        : forward emissions deferred by outbox capacity
  suppressed     : delta-gate suppressed out-edge RMIs
  occ_bc_defer   : END-OF-TICK broadcast defer-ring population
  occ_rmi_defer  : END-OF-TICK RMI defer-ring population
  route_peak     : peak per-destination bucket demand before the cap
                   (the zero-defer route_cap for this tick's traffic)
  outbox_demand  : max over layers of (emitted + dropped)
  outbox_part_peak : max over layers of the max PER-PART eviction demand
                   before the quota; zero-drop needs
                   outbox_cap >= n_parts x outbox_part_peak
  query_pending  : held consistent queries (slot occupancy)
  query_backlog  : query wire rows waiting in the query defer ring
  train_labeled  : train-table rows holding a label
  train_dirty    : labeled rows currently dirty (the pending batch)
  q_admitted / q_answered / q_dropped : query-plane flow counters

Host columns (`TRACE_HOST_COLS`):

  tick       : stream clock at the START of the row's tick
  ticks      : micro-ticks this row covers (1)
  wall_s     : wall seconds of the tick (per-tick driver: measured;
               super-tick driver: the super-tick's wall / T)
  host_s     : host staging seconds (0 on the super-tick driver, whose
               staging spreads over the whole super-tick)
  amortized  : 1 when wall_s is a super-tick average, else 0
  wire_bytes : exact bytes on the wire this tick (host arithmetic,
               `D3Pipeline._static_wire_bytes`)
  edges_in / feats_in / queries_in / labels_in : ingest counts
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

TRACE_SCHEMA_VERSION = 1

TRACE_DEVICE_COLS: List[str] = [
    "emitted_final", "emitted_sum", "reduce_msgs", "broadcast_msgs",
    "wire_rows", "route_deferred", "route_dropped", "dropped",
    "suppressed", "occ_bc_defer", "occ_rmi_defer", "route_peak",
    "outbox_demand", "outbox_part_peak",
    "query_pending", "query_backlog", "train_labeled",
    "train_dirty", "q_admitted", "q_answered", "q_dropped",
]

TRACE_HOST_COLS: List[str] = [
    "tick", "ticks", "wall_s", "host_s", "amortized", "wire_bytes",
    "edges_in", "feats_in", "queries_in", "labels_in",
]

_FLOAT_COLS = {"wall_s", "host_s"}


class TraceRecorder:
    """Accumulates per-tick telemetry rows; `save()` -> compressed .npz."""

    def __init__(self, meta: dict | None = None):
        self.meta: dict = dict(meta or {})
        self.meta.setdefault("schema", TRACE_SCHEMA_VERSION)
        self._cols: Dict[str, list] = {
            c: [] for c in TRACE_HOST_COLS + TRACE_DEVICE_COLS}

    def __len__(self) -> int:
        return len(self._cols["tick"])

    def annotate(self, **kv) -> None:
        """Attach extra metadata (e.g. serving latency percentiles)."""
        self.meta.update(kv)

    def append(self, host_row: dict, device_row) -> None:
        """One tick: `host_row` keyed by TRACE_HOST_COLS (missing keys
        default to 0), `device_row` an int sequence in TRACE_DEVICE_COLS
        order (the occupancy row read off the device)."""
        dev = np.asarray(device_row).reshape(-1)
        if dev.shape[0] != len(TRACE_DEVICE_COLS):
            raise ValueError(
                f"device row has {dev.shape[0]} columns, expected "
                f"{len(TRACE_DEVICE_COLS)}")
        for c in TRACE_HOST_COLS:
            v = host_row.get(c, 0)
            self._cols[c].append(float(v) if c in _FLOAT_COLS else int(v))
        for c, v in zip(TRACE_DEVICE_COLS, dev):
            self._cols[c].append(int(v))

    def columns(self) -> Dict[str, np.ndarray]:
        out = {}
        for c, vals in self._cols.items():
            dt = np.float64 if c in _FLOAT_COLS else np.int64
            out[c] = np.asarray(vals, dtype=dt)
        return out

    def save(self, path) -> None:
        np.savez_compressed(
            path, __meta__=np.asarray(json.dumps(self.meta)),
            **self.columns())


class Trace:
    """A loaded trace: `.meta` dict + named numpy columns via `col()`."""

    def __init__(self, meta: dict, cols: Dict[str, np.ndarray]):
        self.meta = meta
        self._cols = cols

    def __len__(self) -> int:
        return int(self._cols["tick"].shape[0])

    def col(self, name: str) -> np.ndarray:
        return self._cols[name]

    @property
    def columns(self) -> Dict[str, np.ndarray]:
        return dict(self._cols)


def load_trace(path) -> Trace:
    """Load a trace written by `TraceRecorder.save` (either package's),
    checking its schema."""
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z:
            raise ValueError(f"{path}: not a telemetry trace (no meta)")
        meta = json.loads(str(z["__meta__"]))
        schema = meta.get("schema")
        if schema != TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"{path}: trace schema {schema!r}, this loader reads "
                f"{TRACE_SCHEMA_VERSION}")
        cols = {}
        for c in TRACE_HOST_COLS + TRACE_DEVICE_COLS:
            if c not in z:
                raise ValueError(f"{path}: missing trace column {c!r}")
            cols[c] = np.asarray(z[c])
        n = {v.shape[0] for v in cols.values()}
        if len(n) != 1:
            raise ValueError(f"{path}: ragged trace columns {sorted(n)}")
    return Trace(meta, cols)
