"""A counting stand-in for one rank of a stream mesh, for the dry run.

`CountingMesh(size)` is rank 0 of a mesh of `size` ranks that runs no
process group: every collective returns a tensor of the shape the real
one returns (its values are not a collective's: the mesh is meant for
the `meta` device, where nothing is computed) and counts its kind,
calls and bytes in `calls` exactly as `StreamMesh._count` does
(`dist/mesh.py`). A step written against a `StreamMesh` (the locality
step's halo `exchange` and `all_reduce_grads`, the EP dispatch) runs on
it unchanged, so one rank's collective bytes at a production size are
read without the ranks: the port's counterpart of compiling one
partition of the reference's SPMD program (`repro/perf/run.py`).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.dist.mesh import StreamMesh


class CountingMesh(StreamMesh):
    """Rank 0 of `size` ranks on `device` (the `meta` device unless
    given). `exchange`, `all_reduce_grads` and the stage views are
    StreamMesh's own, over the counted primitives below."""

    def __init__(self, size: int, device="meta"):
        super().__init__(rank=0, size=int(size), group=None,
                         device=torch.device(device))

    def all_to_all(self, buf, kind: str = "all_to_all"):
        t0 = time.perf_counter()
        out = torch.empty_like(buf)
        self._count(kind, t0, buf.numel() * buf.element_size())
        return out

    def all_reduce(self, t, op=dist.ReduceOp.SUM, kind: str = "all_reduce"):
        t0 = time.perf_counter()
        out = t.clone()
        self._count(kind, t0, out.numel() * out.element_size())
        return out

    def all_gather(self, t, kind: str = "all_gather"):
        t0 = time.perf_counter()
        out = t.new_empty((self.size,) + tuple(t.shape))
        self._count(kind, t0, t.numel() * t.element_size())
        return out

    def shift(self, rows, kind: str = "stage_shift"):
        t0 = time.perf_counter()
        out = torch.empty_like(rows)
        self._count(kind, t0, rows.numel() * rows.element_size())
        return out
