"""Replay cost model for the telemetry plane.

Counterpart of `repro/telemetry/cost_model.py`: fits per-plane cost
coefficients from a recorded trace (`telemetry/trace.py`) by
non-negative least squares over per-tick row counts,

    wall_s  ~=  c0  +  sum_plane  c_plane * rows_plane(tick)

The features are the per-plane work volumes the trace carries (compute
emissions, delivery messages, routed wire rows, query rows, training
batch rows, host ingest rows), so each coefficient reads as "seconds per
row through that plane" and a what-if query is a dot product. Wire BYTES
are not fitted: they are exact constants of (config, mesh) recorded in
the trace meta, and `what_if` re-prices them at a candidate route_cap,
device count or stage count.

The one departure from the reference: `what_if` prices the wire-byte
delta at a link rate the caller passes (`link_bw`, bytes/s, no default).
The reference divides by an interconnect constant of its TPU roofline;
the port's exchange rate is the caller's to measure on its own machine
(`chip_smoke.py` prints the gloo all_to_all rate of its mesh phase).

Fitting masks, as in the reference:

  * amortized rows (super-tick driver, wall = super-tick / T) are
    preferred — per-tick-driver rows carry host jitter and the first
    rows of a session carry one-time set-up;
  * rows whose wall time exceeds `outlier x median` are dropped;
  * coefficients are clamped non-negative by iterative re-fitting.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.telemetry.trace import Trace

COST_MODEL_SCHEMA = 1

# feature name -> trace columns summed into it (one feature per plane)
FEATURES: Dict[str, tuple] = {
    "compute_rows": ("emitted_sum",),
    "deliver_rows": ("reduce_msgs", "broadcast_msgs"),
    "wire_rows": ("wire_rows", "route_deferred"),
    "query_rows": ("q_admitted", "query_pending"),
    "train_rows": ("train_dirty",),
    "ingest_rows": ("edges_in", "feats_in", "queries_in", "labels_in"),
}


def feature_matrix(cols: Dict[str, np.ndarray]) -> np.ndarray:
    """[T, F] per-tick plane work volumes in FEATURES order."""
    return np.stack(
        [sum(cols[c].astype(np.float64) for c in parts)
         for parts in FEATURES.values()], axis=1)


def _fit_mask(cols, prefer_amortized: bool, outlier: float) -> np.ndarray:
    y = cols["wall_s"]
    mask = y > 0
    am = cols["amortized"].astype(bool)
    if prefer_amortized and am.any():
        mask &= am
    if mask.any():
        med = np.median(y[mask])
        if med > 0:
            mask &= y <= outlier * med
    return mask


def _nnls(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with coefficients clamped >= 0 by iteratively
    dropping negative columns and re-fitting (column 0, the intercept,
    is never dropped)."""
    active = list(range(X.shape[1]))
    while True:
        beta, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        neg = [i for i, b in zip(active, beta) if b < 0 and i != 0]
        if not neg:
            break
        active = [i for i in active if i not in neg]
    out = np.zeros(X.shape[1])
    out[active] = np.maximum(beta, 0.0)
    return out


@dataclass
class CostModel:
    """Fitted per-plane linear cost model; see `fit_cost_model`."""
    intercept: float
    coef: Dict[str, float]            # feature name -> seconds per row
    meta: dict = field(default_factory=dict)   # the trace's meta blob

    def predict(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """Predicted per-tick wall seconds for trace columns."""
        X = feature_matrix(cols)
        w = np.array([self.coef[k] for k in FEATURES])
        return self.intercept + X @ w

    def report(self, trace: Trace, tol: float = 0.25,
               prefer_amortized: bool = True,
               outlier: float = 10.0) -> dict:
        """Prediction against measurement on the trace's fit-eligible
        rows: the share within `tol` relative error (hit_frac) and the
        mean relative error (mae_frac)."""
        cols = trace.columns
        mask = _fit_mask(cols, prefer_amortized, outlier)
        y = cols["wall_s"][mask]
        pred = self.predict(cols)[mask]
        if y.size == 0:
            return {"n": 0, "hit_frac": 0.0, "mae_frac": float("nan")}
        rel = np.abs(pred - y) / y
        return {"n": int(y.size),
                "hit_frac": float(np.mean(rel <= tol)),
                "mae_frac": float(np.mean(rel))}

    # ------------------------------------------------------- what-if
    def wire_bytes_at(self, route_cap=..., n_devices: Optional[int] = None,
                      n_stages: Optional[int] = None) -> int:
        """Exact capped-exchange wire bytes per tick at a candidate
        route_cap, re-derived from the recorded lane list (the constants
        `D3Pipeline._static_wire_bytes` prices). Candidate device/stage
        counts rescale the all_to_all multiplier exactly and the fixed
        bytes (training lanes) proportionally, an approximation."""
        m = self.meta
        D0, S0 = int(m["n_devices"]), int(m["n_stages"])
        D = D0 if n_devices is None else int(n_devices)
        S = S0 if n_stages is None else int(n_stages)
        rc = m.get("route_cap") if route_cap is ... else route_cap
        lane = (lambda c: c) if rc is None else \
            (lambda c: max(1, min(int(rc), c)))
        a2a_mult = S * D * D * 4 if D > 1 else 0
        a2a = a2a_mult * sum(lane(int(c)) * int(w)
                             for c, w in m["wire_lanes"])
        fixed = int(m["fixed_wire_bytes"])
        if (D, S) != (D0, S0) and D0 * S0 > 0:
            fixed = fixed * (D * S) // (D0 * S0)
        return a2a + fixed

    def what_if(self, trace: Trace, route_cap=...,
                n_devices: Optional[int] = None,
                n_stages: Optional[int] = None, *,
                link_bw: float) -> dict:
        """Predicted mean per-tick seconds if the recorded stream were
        replayed at a candidate route_cap / device count / stage count:
        the fitted per-row model on the observed work volumes, plus the
        EXACT wire-byte delta priced at `link_bw` bytes/s (the caller's
        measured exchange rate)."""
        if not link_bw > 0:
            raise ValueError(f"link_bw={link_bw} must be a rate > 0 "
                             "(bytes/s)")
        cols = trace.columns
        base = float(np.mean(self.predict(cols)))
        bytes0 = int(self.meta["wire_bytes_per_tick"])
        bytes1 = self.wire_bytes_at(route_cap=route_cap,
                                    n_devices=n_devices,
                                    n_stages=n_stages)
        delta_s = (bytes1 - bytes0) / link_bw
        return {"wire_bytes_per_tick": bytes1,
                "wire_bytes_delta": bytes1 - bytes0,
                "pred_tick_s": base + delta_s,
                "wire_delta_s": delta_s}

    # ------------------------------------------------- (de)serialization
    def to_dict(self) -> dict:
        return {"schema": COST_MODEL_SCHEMA, "intercept": self.intercept,
                "coef": dict(self.coef), "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        if d.get("schema") != COST_MODEL_SCHEMA:
            raise ValueError(f"cost model schema {d.get('schema')!r}, "
                             f"expected {COST_MODEL_SCHEMA}")
        return cls(intercept=float(d["intercept"]),
                   coef={k: float(d["coef"].get(k, 0.0)) for k in FEATURES},
                   meta=d.get("meta", {}))


def fit_cost_model(trace: Trace, prefer_amortized: bool = True,
                   outlier: float = 10.0) -> CostModel:
    """Fit per-plane cost coefficients from a recorded trace."""
    cols = trace.columns
    mask = _fit_mask(cols, prefer_amortized, outlier)
    if not mask.any():
        raise ValueError("trace has no fit-eligible rows (wall_s > 0)")
    X = feature_matrix(cols)[mask]
    y = cols["wall_s"][mask]
    X1 = np.concatenate([np.ones((X.shape[0], 1)), X], axis=1)
    beta = _nnls(X1, y)
    coef = {k: float(b) for k, b in zip(FEATURES, beta[1:])}
    return CostModel(intercept=float(beta[0]), coef=coef,
                     meta=dict(trace.meta))
