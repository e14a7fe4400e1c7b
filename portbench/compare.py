"""The numbers that decide `correct`, and the tail statistic.

Each number has its limit in the configuration's file (`limits`); a run is
correct when every number is at or under its limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rel_max(got, ref) -> float:
    """max |got - ref| / max(1, |ref|) over every element (float64)."""
    if got.numel() == 0:
        return 0.0
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def leaf_norms(tree) -> dict:
    return {p: float(torch.linalg.vector_norm(x.double()))
            for p, x in _leaves(tree)}


def leaf_gaps(got, ref, keep=None) -> dict:
    """Each leaf's | |got| - |ref| | / max(|ref|, the median leaf's |ref|),
    over the leaves in `keep` (all when None)."""
    g, r = leaf_norms(got), leaf_norms(ref)
    keys = [k for k in r if keep is None or k in keep]
    med = float(np.median([r[k] for k in keys]))
    return {k: abs(g[k] - r[k]) / max(r[k], med, 1e-300) for k in keys}


def median_leaf_gap(got, ref, keep=None) -> float:
    """The median over the leaves of `leaf_gaps`: steady from seed to seed
    where the worst leaf is not (an int8 rounding or top-k flip moves one
    leaf's norm by far more than rounding does)."""
    return float(np.median(list(leaf_gaps(got, ref, keep).values())))


def moving_leaves(ref_grad) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    r = leaf_norms(ref_grad)
    med = float(np.median(list(r.values())))
    return {k for k, v in r.items() if v >= 1e-3 * med}


def tail_population(ok_latencies, n_due: int) -> list:
    """Every due request's latency: each answered ok's, and infinity for
    each that did not come back ok (answered not ok, dropped at
    admission, or never answered)."""
    lat = sorted(ok_latencies)
    return lat + [math.inf] * (n_due - len(lat))


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank (a sample, never an interpolation)."""
    v = sorted(values)
    if not v:
        return math.inf
    return v[max(0, math.ceil(q * len(v)) - 1)]
