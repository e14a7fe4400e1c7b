"""Kernel 2 through `ops.mean_rows_gather` (mean_rows_gather_kernel).
Frozen copy of the byte formula of `chip_smoke.py:phase_timing` (PERF.md's
kernel table, row 2): indices and counts at the picks, the rows with
cnt > 0, out written.
"""
from __future__ import annotations

# the program's entry: (module, attribute)
TARGET = ("repro_torch.kernels.segment_reduce.ops", "mean_rows_gather")
# the device kernels it launches, as the profiler names them
KERNELS = ("mean_rows_gather_kernel",)


def log(args: dict):
    """(static shape facts, device scalar [live picks]) of a launch on the
    card, or None."""
    agg, cnt, rows = args["agg"], args["cnt"], args["rows"]
    if not (rows.is_cuda and rows.numel() and agg.shape[1]):
        return None
    return (dict(k=rows.numel(), d=agg.shape[1]),
            (cnt[rows] > 0).sum().reshape(1))


def launch_bytes(static: dict, values: list) -> int:
    return mean_rows_bytes(live=values[0], **static)


def mean_rows_bytes(k: int, d: int, live: int) -> int:
    return k * 8 + k * 4 + live * d * 4 + k * d * 4
