"""Incremental streaming aggregators (paper §4.2.1).

Counterpart of `repro/core/aggregators.py` (`mean_read`, `sum_read`,
`READERS` and the delta gates `GATES`). The engine represents reduce /
replace / remove as one additive delta record (delta_vec, delta_cnt), so
the MEAN synopsis is (sigma, n) and its read is sigma / n; SUM reads
sigma.
"""
from __future__ import annotations

import torch


def mean_read(agg_sum, agg_cnt):
    """Read the MEAN synopsis; rows with n <= 0 read zeros (a neighborhood
    emptied by remove/replace RMIs may keep a float residual in sigma)."""
    cnt = agg_cnt[..., None]
    return torch.where(cnt > 0, agg_sum / torch.clamp(cnt, min=1.0),
                       torch.zeros((), dtype=agg_sum.dtype,
                                   device=agg_sum.device))


def sum_read(agg_sum, agg_cnt):
    del agg_cnt
    return agg_sum


READERS = {"mean": mean_read, "sum": sum_read}


# ------------------------------------------------------------ delta gates
# Per-aggregator re-emission gates of delta-gated propagation
# (core/tick.py:round_b_emit). Given a source vertex that already sent
# phi(x_sent), is the un-emitted delta to phi(x) too small to move the
# destination synopsis by more than eps? True = suppress the re-emission
# (the residual stays un-sent and is re-gated against the same x_sent on
# the next touch).
#
# MEAN/SUM are additive: the synopsis moves by at most the L2 norm of the
# delta. MAX/MIN are one-sided: a message that does not EXCEED the one
# sent (componentwise, beyond eps) cannot raise a MAX synopsis, however
# large its drop.

def _l2_gate(msg_new, msg_old, eps: float):
    d2 = torch.sum(torch.square(msg_new - msg_old), dim=-1)
    return d2 <= eps * eps


def _max_gate(msg_new, msg_old, eps: float):
    return torch.all(msg_new <= msg_old + eps, dim=-1)


def _min_gate(msg_new, msg_old, eps: float):
    return torch.all(msg_new >= msg_old - eps, dim=-1)


GATES = {"mean": _l2_gate, "sum": _l2_gate,
         "max": _max_gate, "min": _min_gate}
