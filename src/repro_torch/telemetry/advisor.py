"""Capacity advisor for the telemetry plane.

Counterpart of `repro/telemetry/advisor.py`; for the same trace it gives
the same recommendations (and the CLI prints the same JSON). It reads a
recorded trace (`telemetry/trace.py`, either package's) and recommends
`PipelineConfig` capacities under a zero-drop / bounded-defer budget,
each from an EXACT occupancy gauge the device measured:

  outbox_cap     : n_parts x (max outbox_part_peak x slack) — the outbox
                   quota binds PER PART, so zero-drop sizing comes from
                   the recorded per-part demand peak;
  feat_cap       : max per-tick feature ingest x slack, floored at
                   outbox_cap;
  edge_tick_cap  : max per-tick edge ingest x slack;
  route_cap      : defer_budget == 0 -> max route_peak (replay defers
                   nothing at the recorded demand); defer_budget > 0 ->
                   the (1 - defer_budget) quantile of route_peak, the
                   ring left at the lane default so tail overflow
                   re-enters later exchanges instead of dropping;
  query_tick_cap : max per-tick query ingest x slack (query_cap keeps the
                   recorded per-part slots, floored so the pending peak
                   fits);
  train_cap      : max per-tick label ingest x slack (0 stays 0).

Record the trace with route_cap=None (dense): peaks recorded under a
capped exchange reflect that config's deferral. The advisor checks its
output against `PipelineConfig.validate()` before emitting it;
`replay_ok(pipe)` is the zero-drop assertion for a pipeline that streamed
the recorded workload under the recommended caps.

CLI:  python -m repro_torch.telemetry.advisor TRACE.npz [--out RECS.json]
          [--slack 1.25] [--defer-budget 0]
"""
from __future__ import annotations

import argparse
import json
import math
from dataclasses import replace

import numpy as np

from repro_torch.telemetry.trace import Trace, load_trace

ADVISOR_SCHEMA = 1


def _ceil_mult(x: float, m: int) -> int:
    return max(m, int(math.ceil(x / m)) * m)


def recommend(trace: Trace, slack: float = 1.25,
              defer_budget: float = 0.0) -> dict:
    """Recommended capacity knobs from a trace's occupancy gauges.

    slack: headroom multiplier on every observed peak. defer_budget:
    fraction of ticks allowed to push route overflow into the defer
    rings (0 = zero-defer sizing)."""
    c = trace.columns
    m = trace.meta
    n_parts = int(m["n_parts"])
    peak = lambda col: int(c[col].max()) if len(trace) else 0

    outbox = n_parts * _ceil_mult(peak("outbox_part_peak") * slack, 1)
    feat = max(_ceil_mult(peak("feats_in") * slack, 1), outbox)
    edge_tick = _ceil_mult(max(peak("edges_in"), 1) * slack, 1)

    rp = c["route_peak"]
    if int(m["n_devices"]) <= 1 or peak("route_peak") == 0:
        route_cap, route_defer = None, None
    elif defer_budget <= 0.0:
        route_cap, route_defer = int(rp.max()), None
    else:
        q = float(np.quantile(rp[rp > 0], 1.0 - defer_budget))
        route_cap = max(1, int(math.ceil(q)))
        route_defer = None          # lane-capacity default: never drops

    query_cap = int(m["query_cap"])
    if query_cap > 0:
        query_cap = max(query_cap,
                        _ceil_mult(peak("query_pending") * slack / n_parts,
                                   1))
        query_tick = _ceil_mult(max(peak("queries_in"), 1) * slack, 1)
    else:
        query_tick = None
    train_cap = (_ceil_mult(max(peak("labels_in"), 1) * slack, 1)
                 if int(m["train_cap"]) > 0 else 0)

    recs = {
        "schema": ADVISOR_SCHEMA,
        "slack": slack,
        "defer_budget": defer_budget,
        "caps": {
            "outbox_cap": outbox, "feat_cap": feat,
            "edge_tick_cap": edge_tick, "route_cap": route_cap,
            "route_defer_cap": route_defer, "query_cap": query_cap,
            "query_tick_cap": query_tick, "train_cap": train_cap,
        },
        "basis": {
            "ticks": len(trace),
            "outbox_demand_peak": peak("outbox_demand"),
            "outbox_part_peak": peak("outbox_part_peak"),
            "route_peak_max": peak("route_peak"),
            "feats_in_peak": peak("feats_in"),
            "edges_in_peak": peak("edges_in"),
            "queries_in_peak": peak("queries_in"),
            "labels_in_peak": peak("labels_in"),
            "query_pending_peak": peak("query_pending"),
            "occ_defer_peak": max(peak("occ_bc_defer"),
                                  peak("occ_rmi_defer")),
        },
        "trace_meta": {k: m[k] for k in
                       ("n_parts", "n_devices", "n_stages", "window",
                        "route_cap", "wire_bytes_per_tick")},
    }
    check_bounds(recs)
    return recs


def apply_recommendation(cfg, recs: dict):
    """A copy of `cfg` with the recommended caps applied (keys with value
    None take the config's default meaning, e.g. route_cap=None =
    dense)."""
    return replace(cfg, **recs["caps"])


def check_bounds(recs: dict) -> None:
    """Fail fast if the recommended caps would not pass
    `PipelineConfig.validate()`: the advisor never emits a config the
    pipeline rejects."""
    from repro_torch.core.pipeline import PipelineConfig
    caps = recs["caps"]
    n_parts = int(recs["trace_meta"]["n_parts"])
    cfg = PipelineConfig(n_parts=n_parts, **caps)
    cfg.validate(n_devices=int(recs["trace_meta"]["n_devices"])
                 * max(int(recs["trace_meta"]["n_stages"]), 1))


def replay_ok(pipe) -> dict:
    """The zero-drop replay assertion: a pipeline that streamed the
    recorded workload under the recommended caps dropped nothing."""
    m = pipe.metrics
    out = {"dropped": int(m.dropped), "route_dropped": int(m.route_dropped),
           "queries_dropped": int(m.queries_dropped),
           "wire_bytes": int(m.wire_bytes)}
    if out["dropped"] or out["route_dropped"]:
        raise AssertionError(f"recommended caps dropped work: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.advisor",
        description="Recommend PipelineConfig capacities from a "
                    "telemetry trace.")
    ap.add_argument("trace", help="trace .npz written by save_trace()")
    ap.add_argument("--out", default=None,
                    help="write recommendations JSON here (default: stdout)")
    ap.add_argument("--slack", type=float, default=1.25,
                    help="headroom multiplier on observed peaks")
    ap.add_argument("--defer-budget", type=float, default=0.0,
                    help="fraction of ticks allowed to defer route "
                         "overflow (0 = zero-defer sizing)")
    args = ap.parse_args(argv)
    recs = recommend(load_trace(args.trace), slack=args.slack,
                     defer_budget=args.defer_budget)
    text = json.dumps(recs, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
