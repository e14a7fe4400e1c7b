"""Kernel 1 through `ops.deliver_rows` (segment_deliver_kernel and its
fixup). Frozen copy of the byte formula of `chip_smoke.py:phase_timing`
(PERF.md's kernel table, row 1): each input byte read once, each output
byte written once.

  add form (`mode="add"`): the live records' vec rows, order entries and
  counts; row_ptr; base and base_cnt; out, cnt_out and the flag written;
  set form: each touched row's last record (vec row, order entry);
  row_ptr; base at the untouched rows; out and the flag written.
"""
from __future__ import annotations

import torch

# the program's entry: (module, attribute)
TARGET = ("repro_torch.kernels.segment_reduce.ops", "deliver_rows")
# the device kernels it launches, as the profiler names them
KERNELS = ("segment_deliver_kernel", "segment_deliver_fixup_kernel")


def log(args: dict):
    """(static shape facts, device scalars [live, touched]) of a launch on
    the card, or None."""
    rp = args["row_ptr"]
    if not (rp.is_cuda and rp.numel() > 1):
        return None
    return (dict(mode=args["mode"], n=rp.numel() - 1,
                 d=args["vec"].shape[1], order=args["order"] is not None,
                 cnt=args["cnt"] is not None, base=args["base"] is not None,
                 base_cnt=args["base_cnt"] is not None),
            torch.stack([rp[-1], (rp[1:] > rp[:-1]).sum()]))


def launch_bytes(static: dict, values: list) -> int:
    live, touched = values
    return deliver_bytes(live=live, touched=touched, **static)


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
