"""Telemetry plane: the plane that watches the other five.

Counterpart of `repro/telemetry`. `trace` records exact per-plane
occupancy gauges and host timings per tick; `cost_model` fits
seconds-per-row coefficients from a trace and answers what-if queries;
`advisor` turns occupancy peaks into recommended `PipelineConfig`
capacities under a zero-drop budget. Recording is on with
`PipelineConfig(telemetry=True)`; off, the tick launches nothing for it.
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
