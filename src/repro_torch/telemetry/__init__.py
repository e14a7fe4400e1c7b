"""Telemetry plane: the plane that watches the other five.

Counterpart of `repro/telemetry`, in two parts:

  * the device occupancy trace, gated by `PipelineConfig(telemetry=True)`
    (off, the tick launches nothing for it): `trace` records exact
    per-plane occupancy gauges and host timings per tick; `cost_model`
    fits seconds-per-row coefficients from a trace and answers what-if
    queries; `advisor` turns occupancy peaks into recommended
    `PipelineConfig` capacities under a zero-drop budget;
  * the launch log, always on (`spans`, the port's own): each driver
    launch's host phases (stage, upload, dispatch, wait, post), staging
    spans and counters in a ring of the last 1,024 launches, read by an
    operator with `spans.records()`; while torch's profiler is on, the
    same phases and the tick program's stages as `d3.*` profiler ranges.
"""
from repro_torch.telemetry.trace import (TRACE_DEVICE_COLS,
                                         TRACE_HOST_COLS,
                                         TRACE_SCHEMA_VERSION, Trace,
                                         TraceRecorder, load_trace)
from repro_torch.telemetry.cost_model import (CostModel, FEATURES,
                                              fit_cost_model)
from repro_torch.telemetry.advisor import (apply_recommendation, recommend,
                                           replay_ok)

__all__ = [
    "TRACE_DEVICE_COLS", "TRACE_HOST_COLS", "TRACE_SCHEMA_VERSION",
    "Trace", "TraceRecorder", "load_trace", "CostModel", "FEATURES",
    "fit_cost_model", "apply_recommendation", "recommend", "replay_ok",
]
