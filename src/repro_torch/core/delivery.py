"""The DELIVERY plane: how routed records land in operator state.

Counterpart of `repro/core/delivery.py`. A backend provides the three
state effects of the tick's hot path:

  deliver_set   : feature rows SET at local masters/replicas — last-
                  writer-wins plus a touched flag per row;
  deliver_add   : aggregator RMI records ADD (delta vec, delta cnt) at
                  local masters plus a dirty flag;
  agg_read_rows : the MEAN-synopsis read at the forward stage's rows.

plus `add_rows`, deliver_add into a zero table: the run sums of the
delta-gated tick's coalescer and the training plane's gradient folds.

Two registered backends:

  "kernel"  — the default, counterpart of `PallasDelivery`: every delivery
              is one stable sort plus one `ops.deliver_rows` call (CUDA
              kernel A on the card), which gathers the records, reads the
              table and writes the new one in one pass; the read goes
              through `ops.mean_rows` (kernel B, gather fused), so the full
              mean table is never materialized.
  "scatter" — counterpart of `XlaDelivery`: plain torch scatters into
              tables padded with the drop-sentinel row. Used as the
              reference by the tests and `chip_smoke.py`.

Both resolve duplicate `deliver_set` targets by a STABLE sort on the
destination (the last record wins): `index_put_` with duplicate indices is
unordered on CUDA.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.aggregators import mean_read
from repro_torch.core.state import mark_rows
from repro_torch.kernels.segment_reduce import ops


@dataclass(frozen=True)
class ScatterDelivery:
    """Reference backend: torch scatters guarded by the drop sentinel."""

    name = "scatter"

    def deliver_set(self, dst, idx, vals):
        """Set rows of dst [R, d] at idx [C] to vals [C, d]; idx outside
        [0, R) drops. Returns (dst', touched [R] bool)."""
        R = dst.shape[0]
        valid = (idx >= 0) & (idx < R)
        seg = torch.where(valid, idx, torch.full_like(idx, R))
        seg_s, order = torch.sort(seg, stable=True)
        last = torch.ones_like(valid)
        last[:-1] = seg_s[1:] != seg_s[:-1]
        # only each run's last record keeps its target: unique writes
        tgt = torch.where(valid[order] & last, seg_s,
                          torch.full_like(seg_s, R))
        buf = torch.cat([dst, dst.new_zeros((1, dst.shape[1]))])
        buf[tgt] = vals[order]
        return buf[:-1], mark_rows(R, tgt, dst.device)

    def deliver_add(self, agg, cnt, idx, vec, dcnt):
        """Add (vec [C, d], dcnt [C]) into (agg [R, d], cnt [R]) at idx.
        Returns (agg', cnt', dirty [R] bool); cnt and dcnt may both be
        None (cnt' is None then).

        The tick's records are summed in float64 into a zero table and
        added to the synopsis once, so the reference depends neither on the
        order of CUDA's atomic adds nor on the synopsis' magnitude. At full
        width on the card (hubs of ~1e5 in-edges), f32 scatter-adds drifted
        from the float64 oracle by 1.1e-3 (each record added straight into
        the synopsis, as JAX's `XlaDelivery` does) and 6.7e-4 (summed into
        zeros first), where the kernel backend stays at 3e-6."""
        R = agg.shape[0]
        live = (idx >= 0) & (idx < R)
        tgt = torch.where(live, idx, torch.full_like(idx, R))
        d_vec = torch.zeros((R + 1, agg.shape[1]), dtype=torch.float64,
                            device=agg.device).index_add_(
            0, tgt, torch.where(live[:, None], vec, 0.0).double()
        ).to(agg.dtype)
        cnt_out = None
        if cnt is not None:
            cnt_out = cnt + cnt.new_zeros(R + 1).index_add_(
                0, tgt, torch.where(live, dcnt, 0.0))[:-1]
        return agg + d_vec[:-1], cnt_out, mark_rows(R, tgt, agg.device)

    def add_rows(self, n_rows, idx, vec, dcnt=None):
        """deliver_add into a zero table of n_rows rows, as the plain f32
        index_add_: (sums [n_rows, d], count sums [n_rows] or None)."""
        live = (idx >= 0) & (idx < n_rows)
        tgt = torch.where(live, idx, torch.full_like(idx, n_rows))
        out = vec.new_zeros((n_rows + 1, vec.shape[1])).index_add_(
            0, tgt, vec)[:-1]
        if dcnt is None:
            return out, None
        return out, dcnt.new_zeros(n_rows + 1).index_add_(0, tgt, dcnt)[:-1]

    def agg_read_rows(self, agg, cnt, rows):
        """MEAN synopsis at `rows` [K] (full table, then the gather)."""
        return mean_read(agg, cnt)[rows]


@dataclass(frozen=True)
class KernelDelivery:
    """Kernel backend: sorted gather-form deliveries (kernel A, the table
    read and written in the same pass) and the fused gather + mean read
    (kernel B)."""

    name = "kernel"

    def deliver_set(self, dst, idx, vals):
        order, row_ptr = ops.sort_runs(idx, dst.shape[0])
        out, _, touched = ops.deliver_rows(vals, row_ptr, order, base=dst,
                                           mode="set")
        return out, touched

    def deliver_add(self, agg, cnt, idx, vec, dcnt):
        order, row_ptr = ops.sort_runs(idx, agg.shape[0])
        return ops.deliver_rows(vec, row_ptr, order, dcnt, base=agg,
                                base_cnt=cnt, mode="add")

    def add_rows(self, n_rows, idx, vec, dcnt=None):
        order, row_ptr = ops.sort_runs(idx, n_rows)
        out, cnt, _ = ops.deliver_rows(vec, row_ptr, order, dcnt,
                                       mode="add")
        return out, cnt

    def agg_read_rows(self, agg, cnt, rows):
        return ops.mean_rows(agg, cnt, rows)


BACKENDS = {"kernel": KernelDelivery, "scatter": ScatterDelivery}


def make_delivery(name: str):
    """Build a registered delivery backend; unknown names fail with the
    registry listed."""
    try:
        return BACKENDS[name]()
    except KeyError:
        raise ValueError(
            f"unknown delivery_backend {name!r}: expected one of "
            f"{sorted(BACKENDS)}") from None
