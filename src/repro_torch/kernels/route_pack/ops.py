"""route_pack: sort-by-destination packing of the routing plane's wire.

Counterpart of `repro/kernels/route_pack/ops.py`:

  route_plan : ONE stable sort by destination device, a searchsorted for
               each destination's first sorted position, rank = position
               - run start. Plain PyTorch, as the JAX plan stays XLA.
  route_pack : the send buffer [n_dev * cap, W]: each destination's first
               `cap` live rows, in sorted order, zeros elsewhere. For CUDA
               tensors it launches `csrc/route_pack.cu` (replaces the
               Pallas backend, which ran kernels/segment_reduce's one-hot
               segment sum) or raises; for CPU tensors it runs the plain
               version `ref.route_pack_ref` (the JAX "xla" backend).

Both are bit-exact copies of the shipped rows (NaN, Inf and -0.0
included); the Pallas backend is exact only for finite rows. `LAUNCHES`
counts kernel launches (`reset_launches()` zeroes it) so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.route_pack import ref

LAUNCHES = {"route_pack": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _P]


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load("route_pack")
    lib.d3_route_pack.argtypes = _SIGNATURE
    lib.d3_route_pack.restype = ctypes.c_int
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
    _check(rows, "rows", torch.float32, 2, dev)
    _check(order, "order", torch.int64, 1, dev)
    _check(starts, "starts", torch.int64, 1, dev)
    if order.shape[0] != rows.shape[0] or starts.shape[0] != n_dev + 1:
        raise ValueError(f"plan for {order.shape[0]} rows and "
                         f"{starts.shape[0] - 1} destinations, got "
                         f"{rows.shape[0]} rows and n_dev={n_dev}")
    if cap < 1:
        raise ValueError(f"cap={cap} must be >= 1")
    width = rows.shape[1]
    out = torch.empty((n_slots, width), dtype=torch.float32, device=dev)
    if n_slots > 0 and width > 0:
        rc = _lib().d3_route_pack(
            rows.data_ptr(), order.data_ptr(), starts.data_ptr(),
            out.data_ptr(), n_dev, cap, width,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"route_pack launch failed: cudaError {rc}")
        LAUNCHES["route_pack"] += 1
    return out
