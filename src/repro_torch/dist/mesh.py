"""One rank's view of a 1-D ("data",) stream mesh.

A `StreamMesh` is what the routing plane (`dist/router.py:MeshRouter`) and
`D3Pipeline(mesh=...)` need from a process group: rank, world size, group
and device, plus the collectives the routing plane issues, each counted
and timed (`StreamMesh.calls`). `launch/mesh.py` builds one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class StreamMesh:
    """One rank of a 1-D stream mesh. Parts are block-sharded: rank r
    owns parts [r * Pl, (r + 1) * Pl) with Pl = n_parts // size."""
    rank: int
    size: int
    group: object
    device: torch.device
    # per collective kind: [calls, host seconds spent in the call, bytes
    # sent by this rank]; a gloo collective on CUDA tensors is a host sync
    calls: dict = field(default_factory=dict, compare=False, repr=False)

    def _count(self, kind: str, t0: float, n_bytes: int) -> None:
        c = self.calls.setdefault(kind, [0, 0.0, 0])
        c[0] += 1
        c[1] += time.perf_counter() - t0
        c[2] += n_bytes

    def reset_calls(self) -> None:
        self.calls.clear()

    def all_to_all(self, buf):
        """[size, X] -> [size, X]: row j goes to rank j, row j of the
        result came from rank j."""
        t0 = time.perf_counter()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf.contiguous(), group=self.group)
        self._count("all_to_all", t0, buf.numel() * buf.element_size())
        return out

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """Elementwise reduction over the ranks (a new tensor)."""
        t0 = time.perf_counter()
        out = t.clone()
        dist.all_reduce(out, op=op, group=self.group)
        self._count("all_reduce", t0, out.numel() * out.element_size())
        return out

    def all_gather(self, t):
        """[size, *t.shape]: rank j's tensor at index j."""
        t0 = time.perf_counter()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        self._count("all_gather", t0, t.numel() * t.element_size())
        return torch.stack(parts)
