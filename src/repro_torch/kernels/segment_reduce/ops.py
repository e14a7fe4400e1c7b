"""Segment-reduce wrappers: layout in PyTorch, reduction in CUDA.

Counterpart of `repro/kernels/segment_reduce/ops.py`. The layout step
(stable sort by destination, run offsets) is plain PyTorch, as it is XLA
on the TPU side; the reductions are the kernels of
`csrc/segment_reduce.cu`:

  segment_sum_rows  (kernel A) — replaces kernel.py:segment_sum_kernel
  mean_rows_gather  (kernel B) — replaces kernel.py:mean_rows_kernel

Each wrapper runs its plain version (`ref.py`) for CPU tensors and, for
CUDA tensors, launches its kernel or raises. `LAUNCHES` counts kernel
launches per wrapper (plain integers; `reset_launches()` zeroes them) so
a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.segment_reduce import ref

LAUNCHES = {"segment_sum_rows": 0, "mean_rows_gather": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"d3_segment_sum_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
               "d3_mean_rows_gather": [_P, _P, _P, _P, _I, _I, _P]}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load("segment_reduce")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.d3_segment_sum_tile_rows.argtypes = []
    lib.d3_segment_sum_tile_rows.restype = ctypes.c_int64
    return lib


def _check(t, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.ndim}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def segment_sum_rows(rows, seg, row_ptr):
    """Kernel A: out[r] = sum(rows[row_ptr[r]:row_ptr[r + 1]]).

    rows [E, W] float32 sorted by destination; seg [E] int64 their sorted
    segment ids; row_ptr [n + 1] int64 the run offsets, row_ptr[n] <= E
    (rows past it are padding and are never read). Returns [n, W]; empty
    runs read zero. Deterministic: no atomics, fixed tiles."""
    if rows.device.type == "cpu":
        return ref.segment_sum_rows_ref(rows, seg, row_ptr)
    dev = rows.device
    _check(rows, "rows", torch.float32, 2, dev)
    _check(seg, "seg", torch.int64, 1, dev)
    _check(row_ptr, "row_ptr", torch.int64, 1, dev)
    if seg.shape[0] != rows.shape[0]:
        raise ValueError(f"seg has {seg.shape[0]} ids for {rows.shape[0]} "
                         "rows")
    n, width = row_ptr.numel() - 1, rows.shape[1]
    out = torch.empty((n, width), dtype=torch.float32, device=dev)
    if n > 0 and width > 0:
        lib = _lib()
        tile = lib.d3_segment_sum_tile_rows()
        n_tiles = -(-rows.shape[0] // tile)
        carry = torch.empty((2 * n_tiles, width), dtype=torch.float32,
                            device=dev)
        rc = lib.d3_segment_sum_rows(
            rows.data_ptr(), seg.data_ptr(), row_ptr.data_ptr(),
            out.data_ptr(), carry.data_ptr(), n, width, n_tiles,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "segment_sum_rows")
        LAUNCHES["segment_sum_rows"] += 1
    return out


def mean_rows_gather(agg, cnt, rows):
    """Kernel B: out[k] = agg[rows[k]] / max(cnt[rows[k]], 1), zero where
    cnt[rows[k]] <= 0. agg [R, d] float32, cnt [R] float32, rows [K]
    int64 in [0, R)."""
    if agg.device.type == "cpu":
        return ref.mean_rows_gather_ref(agg, cnt, rows)
    dev = agg.device
    _check(agg, "agg", torch.float32, 2, dev)
    _check(cnt, "cnt", torch.float32, 1, dev)
    _check(rows, "rows", torch.int64, 1, dev)
    if cnt.shape[0] != agg.shape[0]:
        raise ValueError(f"cnt has {cnt.shape[0]} rows, agg {agg.shape[0]}")
    k, d = rows.shape[0], agg.shape[1]
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    if k > 0 and d > 0:
        rc = _lib().d3_mean_rows_gather(
            agg.data_ptr(), cnt.data_ptr(), rows.data_ptr(), out.data_ptr(),
            k, d, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "mean_rows_gather")
        LAUNCHES["mean_rows_gather"] += 1
    return out


def run_offsets(seg_sorted, n_segments: int):
    """row_ptr [n_segments + 1] of sorted segment ids (ids >= n_segments
    are padding and fall outside every run)."""
    counts = torch.zeros(n_segments + 1, dtype=torch.int64,
                         device=seg_sorted.device)
    counts.index_add_(0, torch.clamp(seg_sorted, max=n_segments),
                      torch.ones_like(seg_sorted))
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts[:-1], 0)])


def segment_sum_sorted(msgs, seg_ids, n_segments: int):
    """Segment-sum of msgs [E, W] by seg_ids [E] (MUST be sorted
    ascending; id >= n_segments = padding). Returns [n_segments, W]."""
    return segment_sum_rows(msgs, seg_ids, run_offsets(seg_ids, n_segments))


def deliver_layout(idx, vec, cnt, n_rows: int, mode: str = "add"):
    """The layout half of `segment_deliver`: mask, STABLE sort by
    destination, and the packed payload [vec | cnt | touch] of the live
    records. Returns (payload [C, d + 2] sorted, seg [C] sorted ids,
    row_ptr [n_rows + 1]) — kernel A's inputs."""
    if mode not in ("add", "set"):
        raise ValueError(f"segment_deliver mode must be 'add' or 'set', "
                         f"got {mode!r}")
    C, d = vec.shape
    valid = (idx >= 0) & (idx < n_rows)
    seg = torch.where(valid, idx, torch.full_like(idx, n_rows))
    seg_s, order = torch.sort(seg, stable=True)
    live = valid[order]
    if mode == "set":
        # last-writer-wins: only the final record of each run carries
        # payload (the stable sort keeps record order within a run)
        is_last = torch.ones_like(live)
        is_last[:-1] = seg_s[1:] != seg_s[:-1]
        live = live & is_last
    payload = torch.empty((C, d + 2), dtype=torch.float32, device=vec.device)
    payload[:, :d] = vec[order]
    payload[:, d] = cnt[order]
    payload[:, d + 1] = 1.0
    payload.masked_fill_(~live[:, None], 0.0)
    return payload, seg_s, run_offsets(seg_s, n_rows)


def segment_deliver(idx, vec, cnt, n_rows: int, mode: str = "add"):
    """Fixed-capacity message delivery as ONE sorted segment reduction.

    idx [C] destination rows (outside [0, n_rows) = drop sentinel); vec
    [C, d] float32 payload; cnt [C] float32 count deltas.
    Returns (vec_out [n_rows, d], cnt_out [n_rows], touched [n_rows]):
      mode="add": per-row sums of vec and cnt (aggregator RMI apply);
      mode="set": the LAST valid writer's vec/cnt per row — the stable
                  sort makes last-writer-wins deterministic on every
                  device.
    The packed payload goes through one kernel A call."""
    d = vec.shape[1]
    out = segment_sum_rows(*deliver_layout(idx, vec, cnt, n_rows, mode))
    return out[:, :d], out[:, d], out[:, d + 1] > 0


def mean_rows(sums, cnts, rows=None):
    """Aggregator read: sums / max(cnts, 1) with cnt <= 0 rows reading
    ZERO, at `rows` (default: every row) — kernel B with the gather
    fused."""
    if rows is None:
        rows = torch.arange(sums.shape[0], device=sums.device)
    return mean_rows_gather(sums, cnts, rows)
