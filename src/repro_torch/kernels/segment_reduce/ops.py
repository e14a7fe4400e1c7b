"""Segment-reduce wrappers: layout in PyTorch, reduction in CUDA.

Counterpart of `repro/kernels/segment_reduce/ops.py`. The layout step
(stable sort by destination, run offsets, the merge-path plan) is plain
PyTorch, as it is XLA on the TPU side; the reductions are the kernels of
`csrc/segment_reduce.cu`:

  deliver_rows      (kernel A) — replaces kernel.py:segment_sum_kernel;
                    segment_sum_rows, segment_sum_sorted,
                    segment_deliver and gather_segment_sum are its forms
  mean_rows_gather  (kernel B) — replaces kernel.py:mean_rows_kernel
  rmi_apply_read    kernel A's add onto a base, then kernel B at the
                    read rows

Each wrapper runs its plain version (`ref.py`) for CPU tensors and, for
CUDA tensors, launches its kernel or raises; the kernels have no
backward, so a CUDA call under autograd with an input that requires
grad raises (`cuda_lib.refuse_grad`) rather than return an output
without a graph. The embedding bag's backward calls `deliver_rows` on
the gradient, which requires none. On the `meta` device (the dry
run's) kernels A and B check and allocate their outputs and launch
nothing; each call notes its operands (`repro_torch.work.note`) for an
operation counter to price. `LAUNCHES` counts kernel
launches per wrapper (plain integers; `reset_launches()` zeroes them) so
a run can show that its path went through the kernels; every form of
kernel A counts under "segment_sum_rows".
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import work
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.segment_reduce import ref

LAUNCHES = {"segment_sum_rows": 0, "mean_rows_gather": 0}

# merge-path items (output rows + live records) one warp takes in add
# mode; output rows one warp takes in set mode
SHARE = 64
# the kernels' column chunks a lane (kernels A and B, instantiated in
# segment_reduce.cu): the main path's widths take 1 (d = 64 at float4),
# 2 (64 at VEC 1 on a strided wire), 10 (602 at float2; 602 at VEC 1 in
# two column tiles); 6 is the yardstick's (604 at float4). Any other
# width runs in column tiles of at most 32 * vec * max(K_CHOICES), each
# with the smallest K that covers it
K_CHOICES = (1, 2, 6, 10)

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "d3_segment_deliver": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P,
                           _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    "d3_mean_rows_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}
_LIB: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = cuda_lib.load("segment_reduce")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB["lib"] = lib
    return lib


def _check(t, name: str, dtype, ndim: int, device, contiguous=True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.ndim}-d {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if (not contiguous and ndim == 2 and t.numel() > 0 and t.shape[1] > 1
            and t.stride(1) != 1):
        raise ValueError(f"{name} must have contiguous rows (stride(1) == 1)")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def run_offsets(seg_sorted, n_segments: int):
    """row_ptr [n_segments + 1] of sorted segment ids: row_ptr[r] is the
    first position whose id is >= r, so ids >= n_segments (padding) fall
    outside every run."""
    return torch.searchsorted(
        seg_sorted, torch.arange(n_segments + 1, dtype=seg_sorted.dtype,
                                 device=seg_sorted.device))


def sort_runs(idx, n_rows: int):
    """The layout of a delivery: a STABLE sort of the records by
    destination. idx [C] int64 rows, outside [0, n_rows) = drop (sorts to
    the sentinel n_rows, past every run). Returns (order [C], row_ptr
    [n_rows + 1]); within a run, records keep their order."""
    valid = (idx >= 0) & (idx < n_rows)
    seg = torch.where(valid, idx, torch.full_like(idx, n_rows))
    seg_s, order = torch.sort(seg, stable=True)
    return order, run_offsets(seg_s, n_rows)


def delivery_plan(row_ptr, n_records: int, share: int = SHARE):
    """The merge-path partition of an add-mode delivery.

    The path walks n = row_ptr.numel() - 1 output-row ends and the
    row_ptr[n] live records in order (row r's records, then its end). It
    is cut every `share` items into S = ceil((n + n_records) / share)
    shares, n_records >= row_ptr[n] being the host's bound on the live
    records (the record capacity), so no value is read back; shares past
    the path's end are empty. Returns plan [2, S + 1] int64: plan[0, s]
    the rows ended and plan[1, s] the records consumed before share s,
    from one searchsorted over the items at which each row ends."""
    n = row_ptr.numel() - 1
    dev = row_ptr.device
    n_shares = max(1, -(-(n + n_records) // share))
    diag = torch.minimum(
        torch.arange(n_shares + 1, dtype=torch.int64, device=dev) * share,
        row_ptr[-1] + n)
    ends = row_ptr[1:] + torch.arange(1, n + 1, dtype=torch.int64,
                                      device=dev)
    rows = torch.searchsorted(ends, diag, right=True)
    return torch.stack([rows, diag - rows])


def _vec_width(d: int, tables) -> int:
    """Widest float vector (4, 2, 1) every row of every (tensor, row
    stride) in `tables` is aligned to, d a multiple of it."""
    for v in (4, 2, 1):
        if d % v == 0 and all(t.data_ptr() % (4 * v) == 0 and ld % v == 0
                              for t, ld in tables):
            return v
    return 1


def _column_tiles(d: int, v: int):
    """[(c0, c1, K)]: column tiles of at most 32 * v * max(K_CHOICES)
    columns, each with the smallest K that covers it."""
    vectors = d // v
    n_tiles = max(1, -(-vectors // (32 * max(K_CHOICES))))
    per = -(-vectors // n_tiles)
    tiles = []
    for t in range(n_tiles):
        a, b = t * per, min(vectors, (t + 1) * per)
        need = max(1, -(-(b - a) // 32))
        tiles.append((a * v, b * v, min(k for k in K_CHOICES if k >= need)))
    return tiles


def deliver_rows(vec, row_ptr, order=None, cnt=None, base=None,
                 base_cnt=None, mode: str = "add"):
    """Kernel A, gather form, over destination-sorted runs: run r holds
    records j in [row_ptr[r], row_ptr[r + 1]), record j being vec row
    order[j] (order None: row j).

      add: out[r] = base[r] + sum_j vec[order[j]], cnt_out[r] = base_cnt[r]
           + sum_j cnt[order[j]] (f32 sums);
      set: out[r] = vec[order[row_ptr[r + 1] - 1]] if the run is non-empty,
           else base[r]; cnt_out likewise (the run's last record);
      flag[r] = the run is non-empty (dirty / touched).

    vec [E, d] float32 with contiguous rows (any row stride); row_ptr
    [n + 1] int64; order [C] int64 or None; cnt [E] float32 (any stride)
    or None; base [n, d] float32 and base_cnt [n] or None (zeros).
    Returns new tensors (out [n, d], cnt_out [n] or None when cnt is None,
    flag [n] bool); nothing is updated in place. Deterministic: no
    atomics."""
    if mode not in ("add", "set"):
        raise ValueError(f"deliver_rows mode must be 'add' or 'set', got "
                         f"{mode!r}")
    if base_cnt is not None and cnt is None:
        raise ValueError("base_cnt needs cnt (the counts it adds to)")
    if vec.device.type == "cpu":
        return ref.deliver_rows_ref(vec, row_ptr, order, cnt, base,
                                    base_cnt, mode)
    dev = vec.device
    cuda_lib.refuse_grad("deliver_rows", vec, cnt, base, base_cnt)
    _check(vec, "vec", torch.float32, 2, dev, contiguous=False)
    _check(row_ptr, "row_ptr", torch.int64, 1, dev)
    n, d = row_ptr.numel() - 1, vec.shape[1]
    if order is not None:
        _check(order, "order", torch.int64, 1, dev)
    if cnt is not None:
        _check(cnt, "cnt", torch.float32, 1, dev, contiguous=False)
        if cnt.shape[0] != vec.shape[0]:
            raise ValueError(f"cnt has {cnt.shape[0]} records, vec "
                             f"{vec.shape[0]}")
    if base is not None:
        _check(base, "base", torch.float32, 2, dev, contiguous=False)
        if tuple(base.shape) != (n, d):
            raise ValueError(f"base is {tuple(base.shape)}, expected "
                             f"{(n, d)}")
    if base_cnt is not None:
        _check(base_cnt, "base_cnt", torch.float32, 1, dev, contiguous=False)
        if base_cnt.shape[0] != n:
            raise ValueError(f"base_cnt has {base_cnt.shape[0]} rows, "
                             f"expected {n}")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    cnt_out = None if cnt is None else torch.empty(n, dtype=torch.float32,
                                                   device=dev)
    flag = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, cnt_out, flag
    work.note("segment_sum_rows", mode=mode,
              n_rec=vec.shape[0] if order is None else order.shape[0],
              cnt=cnt, row_ptr=row_ptr, order=order, base=base,
              base_cnt=base_cnt, out=out, cnt_out=cnt_out, flag=flag)
    if dev.type == "meta":
        return out, cnt_out, flag
    set_mode = mode == "set"
    if set_mode:
        plan, n_shares = None, -(-n // SHARE)
    else:
        n_records = order.shape[0] if order is not None else vec.shape[0]
        plan = delivery_plan(row_ptr, n_records)
        n_shares = plan.shape[1] - 1
    carry = carry_cnt = None
    if not set_mode and n_shares > 1:
        carry = torch.empty((n_shares, d), dtype=torch.float32, device=dev)
        if cnt is not None:
            carry_cnt = torch.empty(n_shares, dtype=torch.float32,
                                    device=dev)
    tables = [(vec, vec.stride(0)), (out, d)]
    tables += [] if base is None else [(base, base.stride(0))]
    tables += [] if carry is None else [(carry, d)]
    v = _vec_width(d, tables)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t, col=0):
        return None if t is None else t.data_ptr() + 4 * col

    for c0, c1, k in _column_tiles(d, v):
        first = c0 == 0      # counts and flags ride on the first tile
        rc = lib.d3_segment_deliver(
            ptr(vec, c0), vec.stride(0), ptr(order),
            ptr(cnt) if first else None,
            0 if cnt is None else cnt.stride(0), ptr(row_ptr), ptr(plan),
            ptr(base, c0), 0 if base is None else base.stride(0),
            ptr(base_cnt) if first else None,
            0 if base_cnt is None else base_cnt.stride(0), ptr(out, c0), d,
            ptr(cnt_out) if first else None, ptr(flag) if first else None,
            ptr(carry, c0), ptr(carry_cnt) if first else None, d, n,
            c1 - c0, n_shares, SHARE, int(set_mode), v, k, stream)
        _raise_on(rc, "segment_deliver")
    LAUNCHES["segment_sum_rows"] += 1
    return out, cnt_out, flag


def segment_sum_rows(rows, seg, row_ptr):
    """Kernel A, contiguous form: out[r] = sum(rows[row_ptr[r]:row_ptr[r +
    1]]).

    rows [E, W] float32 sorted by destination; seg [E] int64 their sorted
    segment ids; row_ptr [n + 1] int64 the run offsets, row_ptr[n] <= E
    (rows past it are padding and are never read). Returns [n, W]; empty
    runs read zero. Deterministic: no atomics."""
    if rows.device.type == "cpu":
        return ref.segment_sum_rows_ref(rows, seg, row_ptr)
    _check(seg, "seg", torch.int64, 1, rows.device)
    if seg.shape[0] != rows.shape[0]:
        raise ValueError(f"seg has {seg.shape[0]} ids for {rows.shape[0]} "
                         "rows")
    return deliver_rows(rows, row_ptr)[0]


def mean_rows_gather(agg, cnt, rows):
    """Kernel B: out[k] = agg[rows[k]] / max(cnt[rows[k]], 1), zero where
    cnt[rows[k]] <= 0. agg [R, d] float32, cnt [R] float32, rows [K]
    int64 in [0, R), all contiguous.

    The widest float vector (4, 2, 1) every row of agg and out is aligned
    to picks the kernel's form, as in deliver_rows; rows wider than
    32 * vec * max(K_CHOICES) floats run in column tiles."""
    if agg.device.type == "cpu":
        return ref.mean_rows_gather_ref(agg, cnt, rows)
    dev = agg.device
    cuda_lib.refuse_grad("mean_rows_gather", agg, cnt)
    _check(agg, "agg", torch.float32, 2, dev)
    _check(cnt, "cnt", torch.float32, 1, dev)
    _check(rows, "rows", torch.int64, 1, dev)
    if cnt.shape[0] != agg.shape[0]:
        raise ValueError(f"cnt has {cnt.shape[0]} rows, agg {agg.shape[0]}")
    k, d = rows.shape[0], agg.shape[1]
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    if k == 0 or d == 0:
        return out
    work.note("mean_rows_gather", rows=rows, cnt=cnt, out=out)
    if dev.type == "meta":
        return out
    v = _vec_width(d, [(agg, d), (out, d)])
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0, c1, kc in _column_tiles(d, v):
        # lanes a row: 32 for K > 1, else the fewest (a power of two)
        # that cover the tile's vectors, so narrow rows share a warp
        shift = 5 if kc > 1 else min(5, ((c1 - c0) // v - 1).bit_length())
        _raise_on(lib.d3_mean_rows_gather(
            agg.data_ptr() + 4 * c0, cnt.data_ptr(), rows.data_ptr(),
            out.data_ptr() + 4 * c0, d, k, c1 - c0, v, kc, shift, stream),
            "mean_rows_gather")
    LAUNCHES["mean_rows_gather"] += 1
    return out


def segment_sum_sorted(msgs, seg_ids, n_segments: int):
    """Segment-sum of msgs [E, W] by seg_ids [E] (MUST be sorted
    ascending; id >= n_segments = padding). Returns [n_segments, W]."""
    return segment_sum_rows(msgs, seg_ids, run_offsets(seg_ids, n_segments))


def segment_deliver(idx, vec, cnt, n_rows: int, mode: str = "add"):
    """Fixed-capacity message delivery as ONE sorted segment reduction.

    idx [C] destination rows (outside [0, n_rows) = drop sentinel); vec
    [C, d] float32 payload; cnt [C] float32 count deltas.
    Returns (vec_out [n_rows, d], cnt_out [n_rows], touched [n_rows]):
      mode="add": per-row sums of vec and cnt (aggregator RMI apply);
      mode="set": the LAST valid writer's vec/cnt per row — the stable
                  sort makes last-writer-wins deterministic on every
                  device.
    One stable sort, then one kernel A call that gathers the records."""
    order, row_ptr = sort_runs(idx, n_rows)
    return deliver_rows(vec, row_ptr, order, cnt, mode=mode)


def mean_rows(sums, cnts, rows=None):
    """Aggregator read: sums / max(cnts, 1) with cnt <= 0 rows reading
    ZERO, at `rows` (default: every row) — kernel B with the gather
    fused."""
    if rows is None:
        rows = torch.arange(sums.shape[0], device=sums.device)
    return mean_rows_gather(sums, cnts, rows)


def gather_segment_sum(x, senders, receivers, n_nodes: int, edge_mask=None):
    """out[v] = sum of x[senders[e]] over the valid edges e with
    receivers[e] = v: the reference's fused-graph entry
    (`repro/kernels/segment_reduce/ops.py:gather_segment_sum`), a drop-in
    for graph.segment.segment_sum(x[senders], receivers, n_nodes,
    edge_mask). x [N, d] float32 with contiguous rows; senders, receivers
    [E] int64; edge_mask [E] bool or None. An edge is dropped when
    masked or when its receiver lies outside [0, n_nodes).

    One stable sort of the edges by masked receiver, then kernel A in its
    gather form: each record reads its source row x[senders[e]] in the
    kernel, so the [E, d] messages are never written. Returns [n_nodes,
    d]."""
    if x.device.type == "cpu":
        return ref.gather_segment_sum_ref(x, senders, receivers, n_nodes,
                                          edge_mask)
    cuda_lib.refuse_grad("gather_segment_sum", x)
    seg = receivers if edge_mask is None else torch.where(
        edge_mask, receivers, torch.full_like(receivers, n_nodes))
    order, row_ptr = sort_runs(seg, n_nodes)
    return deliver_rows(x, row_ptr, order=senders[order].long())[0]


def rmi_apply_read(agg, cnt, idx, vec, dcnt, read_idx):
    """A tick's aggregator RMI records (idx [C], vec [C, d], dcnt [C])
    applied onto the (agg [R, d], cnt [R]) synopsis, then the MEAN read at
    read_idx [K]: the reference's single-call form
    (`repro/kernels/segment_reduce/ops.py:rmi_apply_read`). Records whose
    idx lies outside [0, R) are dropped.

    One `sort_runs` and one kernel A launch that adds the records onto
    the base in place of a separate sum (agg' = agg + the run's sum, cnt'
    likewise), then kernel B with the gather fused at read_idx: the full
    [R, d] mean table is never formed. Returns (agg' [R, d], cnt' [R],
    dirty [R] bool, reads [K, d])."""
    if agg.device.type == "cpu":
        return ref.rmi_apply_read_ref(agg, cnt, idx, vec, dcnt, read_idx)
    cuda_lib.refuse_grad("rmi_apply_read", agg, cnt, vec, dcnt)
    order, row_ptr = sort_runs(idx, agg.shape[0])
    agg2, cnt2, dirty = deliver_rows(vec, row_ptr, order, dcnt, base=agg,
                                     base_cnt=cnt)
    return agg2, cnt2, dirty, mean_rows_gather(agg2, cnt2, read_idx)
