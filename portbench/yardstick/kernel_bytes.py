"""Bytes that kernels 1 and 2 of the port must move, per launch, from its
arguments' shapes and live counts. Frozen copy of the byte formulas of
`chip_smoke.py:phase_timing` (PERF.md's kernel table, rows 1 and 2):
each input byte read once, each output byte written once.

  kernel 1, add form (`deliver_rows(..., mode="add")`): the live records'
  vec rows, order entries and counts; row_ptr; base and base_cnt; out,
  cnt_out and the flag written;
  kernel 1, set form: each touched row's last record (vec row, order
  entry); row_ptr; base at the untouched rows; out and the flag written;
  kernel 2 (`mean_rows_gather`): indices and counts at the picks, the
  rows with cnt > 0, out written.
"""
from __future__ import annotations


def deliver_bytes(mode: str, n: int, d: int, live: int, touched: int,
                  order: bool, cnt: bool, base: bool, base_cnt: bool) -> int:
    rec = d * 4 + (8 if order else 0) + (4 if cnt else 0)
    out = n * d * 4 + (n * 4 if cnt else 0) + n
    if mode == "set":
        kept = n - touched         # rows that keep their base
        return (touched * rec + (n + 1) * 8 + out
                + (kept * d * 4 if base else 0)
                + (kept * 4 if base_cnt else 0))
    return (live * rec + (n + 1) * 8 + out + (n * d * 4 if base else 0)
            + (n * 4 if base_cnt else 0))


def mean_rows_bytes(k: int, d: int, live: int) -> int:
    return k * 8 + k * 4 + live * d * 4 + k * d * 4


# device kernels that each entry launches (the profiler's names)
KERNELS = {"deliver_rows": ("segment_deliver_kernel",
                            "segment_deliver_fixup_kernel"),
           "mean_rows_gather": ("mean_rows_gather_kernel",)}


def roofline_share(ctx, entry: str):
    """% of the least time (bytes / peak HBM rate) the entry's launches in
    the profiled window could take, over their measured device time; None
    where the window has none."""
    from portbench.yardstick import peaks
    t = ctx.trace
    if not t or entry not in ctx.kernels:
        return None
    measured = sum(s for n, s in t["by_name_s"].items()
                   if any(k in n for k in KERNELS[entry]))
    if not measured:
        return None
    return 100.0 * ctx.kernels[entry][0] / peaks.BYTES_PER_S / measured
