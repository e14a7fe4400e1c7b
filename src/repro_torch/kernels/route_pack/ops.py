"""route_pack: sort-by-destination packing of the routing plane's wire.

Counterpart of `repro/kernels/route_pack/ops.py`:

  route_plan : ONE stable sort by destination device, a searchsorted for
               each destination's first sorted position, rank = position
               - run start. Plain PyTorch, as the JAX plan stays XLA.
  route_pack : the send buffer [n_dev * cap, W] of packed rows [N, W]:
               each destination's first `cap` live rows, in sorted order,
               zeros elsewhere.
  route_lane : the router's whole lane step after the plan (fused): the
               send buffer of the defer ring's rows followed by the lane's
               rows, packed as `dist/wire.py` packs them, and the new ring
               (the rows that overflowed their bucket, in FIFO order).

For CUDA tensors both launch `csrc/route_pack.cu` (replaces the Pallas
backend, which ran kernels/segment_reduce's one-hot segment sum; the
fused entry also the router's pack, concatenation and ring gather) or
raise; for CPU tensors they run the plain versions in `ref.py` (the JAX
"xla" backend, and the router's chain around it).

The kernel has no backward: a CUDA call under autograd with an input
that requires grad raises (`cuda_lib.refuse_grad`) rather than return
an output without a graph.

All are bit-exact copies of the shipped rows (NaN, Inf and -0.0
included); the Pallas backend is exact only for finite rows. On the
`meta` device (the dry run's) both entries allocate their outputs and
launch nothing; each notes its operands (`repro_torch.work.note`) for an
operation counter to price. `LAUNCHES`
counts kernel launches per entry (`reset_launches()` zeroes it) so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import work
from repro_torch.dist import wire
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.route_pack import ref

LAUNCHES = {"route_pack": 0, "route_lane": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "d3_route_pack": [_P, _P, _P, _P, _I, _I, _I, _P],
    "d3_route_lane": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P]}
# the kernel's field dtype codes, and its limits (csrc/route_pack.cu)
_DTYPES = {torch.float32: 0, torch.int64: 1, torch.bool: 2}
MAX_DEV, MAX_FIELDS = 1024, 12
_DESC = ctypes.c_int64 * (4 * MAX_FIELDS)
_LIB: dict = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = cuda_lib.load("route_pack")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB["lib"] = lib
    return lib


def route_plan(dst, ok, n_dev: int, cap: int):
    """Compaction plan for one lane.

    dst [N] int64 destination device per record (rows with ok False or a
    destination outside [0, n_dev) are excluded); ok [N] bool live mask.

    Returns (order, ship_s, slot_s, left_s, starts):
      order  [N] : stable sort permutation grouping records by destination
                   (excluded rows sink to the tail);
      ship_s [N] : post-permutation mask of records that fit their bucket;
      slot_s [N] : post-permutation send slot dst * cap + rank, the
                   sentinel n_dev * cap for everything not shipped;
      left_s [N] : post-permutation mask of live records that overflowed
                   (FIFO per destination: the stable sort keeps record
                   order within a destination);
      starts [n_dev + 1] : first sorted position of each destination,
                   starts[n_dev] = the live row count.
    """
    n = dst.shape[0]
    dev = dst.device
    key = torch.where(ok & (dst >= 0) & (dst < n_dev), dst, n_dev)
    key_s, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        key_s, torch.arange(n_dev + 1, dtype=key_s.dtype, device=dev))
    rank = torch.arange(n, device=dev) - starts[key_s]
    live = key_s < n_dev
    ship_s = live & (rank < cap)
    slot_s = torch.where(ship_s, key_s * cap + rank, n_dev * cap)
    return order, ship_s, slot_s, live & ~ship_s, starts


def _check(t, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.ndim}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_plan(order, starts, n_rows: int, n_dev: int, cap: int,
                device) -> None:
    _check(order, "order", torch.int64, 1, device)
    _check(starts, "starts", torch.int64, 1, device)
    if order.shape[0] != n_rows or starts.shape[0] != n_dev + 1:
        raise ValueError(f"plan for {order.shape[0]} rows and "
                         f"{starts.shape[0] - 1} destinations, got "
                         f"{n_rows} rows and n_dev={n_dev}")
    if cap < 1 or n_dev < 1:
        raise ValueError(f"cap={cap} and n_dev={n_dev} must be >= 1")
    if n_rows >= 2 ** 31:
        raise ValueError(f"{n_rows} source rows: the kernel indexes them "
                         "in 32 bits")
    if n_dev > MAX_DEV:
        raise ValueError(f"n_dev={n_dev}: the kernel takes at most "
                         f"{MAX_DEV} destinations")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def route_pack(rows, order, slot_s, starts, n_dev: int, cap: int):
    """Send buffer [n_dev * cap, W] of packed rows [N, W] f32 under the
    plan (order, slot_s, starts) of `route_plan(dst, ok, n_dev, cap)`:
    slot d * cap + r holds rows[order[starts[d] + r]] for r < the
    destination's live count, zeros elsewhere. The CPU path places
    rows[order] at slot_s; the kernel reads order and starts."""
    n_slots = n_dev * cap
    if rows.device.type == "cpu":
        return ref.route_pack_ref(rows[order], slot_s, n_slots)
    dev = rows.device
    cuda_lib.refuse_grad("route_pack", rows)
    _check(rows, "rows", torch.float32, 2, dev)
    _check_plan(order, starts, rows.shape[0], n_dev, cap, dev)
    width = rows.shape[1]
    out = torch.empty((n_slots, width), dtype=torch.float32, device=dev)
    if width > 0:
        work.note("route_pack", order=order, starts=starts, out=out)
    if width > 0 and dev.type != "meta":
        _raise_on(_lib().d3_route_pack(
            rows.data_ptr(), order.data_ptr(), starts.data_ptr(),
            out.data_ptr(), n_dev, cap, width,
            torch.cuda.current_stream(dev).cuda_stream), "route_pack")
        LAUNCHES["route_pack"] += 1
    return out


def _field_descriptors(layout, C: int, device):
    """The kernel's view of a lane's fields (`wire.lane_fields`), read in
    place: a flat list of {pointer, row stride, first column, dtype code}
    per field of nonzero width, by column."""
    desc = []
    for name, t, col, w in layout:
        if w == 0:
            continue
        if t.device != device:
            raise ValueError(f"field {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"field {name} is {t.dtype}; the wire takes "
                             f"{', '.join(map(str, _DTYPES))}")
        if t.shape[0] != C:
            raise ValueError(f"field {name} has {t.shape[0]} rows, the "
                             f"lane {C}")
        if t.ndim == 2 and w > 1 and C > 0 and t.stride(1) != 1:
            raise ValueError(f"field {name} must have contiguous rows "
                             "(stride(1) == 1)")
        desc += [t.data_ptr(), t.stride(0), col, _DTYPES[t.dtype]]
    if len(desc) > 4 * MAX_FIELDS:
        raise ValueError(f"{len(desc) // 4} fields: the kernel takes at "
                         f"most {MAX_FIELDS}")
    return desc


def route_lane(ring, lane, plan, n_dev: int, cap: int):
    """The router's lane step after the plan, fused.

    ring [K, W] f32: the defer ring's packed rows; lane: a part-addressed
    batch of capacity C (`dist/wire.py` layout, width W); plan =
    route_plan(dst, ok, n_dev, cap) over the K + C source rows, source
    row i being ring row i for i < K and lane row i - K packed as
    `wire.pack_lane` packs it (value-cast to f32).

    Returns (send [n_dev * cap, W]: slot d * cap + r holds source row
    order[starts[d] + r] for r < the destination's live count, zeros
    elsewhere; new ring [K, W]: slot j holds the (j + 1)-th row that
    overflowed its bucket in sorted (FIFO) order, zeros from the overflow
    count on). The kernel reads the lane's fields in place, so no packed
    lane and no [K + C, W] buffer is written; the CPU path is the plain
    chain `ref.route_lane_ref`."""
    if ring.device.type == "cpu":
        return ref.route_lane_ref(ring, lane, plan, n_dev, cap)
    order, starts = plan[0], plan[4]
    dev = ring.device
    layout = wire.lane_fields(lane)
    cuda_lib.refuse_grad("route_lane", ring, *(t for _, t, _, _ in layout))
    _check(ring, "ring", torch.float32, 2, dev)
    K, W = ring.shape
    C = lane.part.shape[0]
    width = sum(w for _, _, _, w in layout)
    if W != width:
        raise ValueError(f"ring rows are {W} wide, the lane's wire rows "
                         f"{width}")
    _check_plan(order, starts, K + C, n_dev, cap, dev)
    desc = _field_descriptors(layout, C, dev)
    send = torch.empty((n_dev * cap, W), dtype=torch.float32, device=dev)
    new_ring = torch.empty((K, W), dtype=torch.float32, device=dev)
    if W > 0:
        work.note("route_lane", order=order, starts=starts, send=send,
                  new_ring=new_ring)
    if W > 0 and dev.type != "meta":
        table = _DESC(*desc)
        _raise_on(_lib().d3_route_lane(
            ring.data_ptr(), K, ctypes.addressof(table), len(desc) // 4,
            order.data_ptr(), starts.data_ptr(), send.data_ptr(),
            new_ring.data_ptr(), n_dev, cap, W,
            torch.cuda.current_stream(dev).cuda_stream), "route_lane")
        LAUNCHES["route_lane"] += 1
    return send, new_ring
