"""One rank's view of a stream mesh: 1-D ("data",) or 2-D ("stage", "data").

A `StreamMesh` is what the routing plane (`dist/router.py:MeshRouter`) and
`D3Pipeline(mesh=...)` need from a process group: rank, size, group and
device, plus the collectives the routing plane issues, each counted and
timed under its own kind (`StreamMesh.calls`). `launch/mesh.py` builds one.

The 2-D mesh is an S x D grid of the mesh's ranks: mesh rank r = s * D + d
sits at stage s, data shard d. Two families of subgroups join it: one per
stage row (the data axis: the D ranks of stage s, where parts are
block-sharded and the routing plane exchanges) and one per data column
(the stage axis: the S ranks of data shard d, which hand rows from stage
to stage). `data_view()` and `stage_view()` are this rank's 1-D meshes
along each axis; they share the `calls` table. On a 1-D mesh the data
view is the mesh itself.

A mesh is a set of ranks of the process group's world (`ranks`, world
ranks in mesh order). A process of the world outside the mesh holds a
view with rank -1 (`member` is False): it takes part in the world-wide
collectives that build meshes and reshard pipelines, and in nothing else.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class StreamMesh:
    """One rank of a stream mesh. Parts are block-sharded over the data
    axis: data shard d owns parts [d * Pl, (d + 1) * Pl) with
    Pl = n_parts // n_data, replicated over the stages."""
    rank: int                  # s * n_data + d; -1 outside the mesh
    size: int                  # n_stages * n_data ranks
    group: object              # the whole mesh (None: the default group)
    device: torch.device
    n_stages: int = 1
    ranks: tuple = ()          # world ranks in mesh order (() = 0..size-1)
    row_groups: tuple = ()     # per stage row: its D ranks (2-D only)
    col_groups: tuple = ()     # per data column: its S ranks (2-D only)
    # per collective kind: [calls, host seconds spent in the call, bytes
    # sent by this rank]; a gloo collective on CUDA tensors is a host sync
    calls: dict = field(default_factory=dict, compare=False, repr=False)

    # ------------------------------------------------------------ layout
    @property
    def member(self) -> bool:
        return self.rank >= 0

    @property
    def n_data(self) -> int:
        return self.size // self.n_stages

    @property
    def stage_index(self) -> int:
        return self.rank // self.n_data

    @property
    def data_index(self) -> int:
        return self.rank % self.n_data

    @property
    def world_ranks(self) -> tuple:
        return self.ranks or tuple(range(self.size))

    def data_view(self) -> "StreamMesh":
        """This rank's stage row as a 1-D mesh over the data axis."""
        if self.n_stages == 1:
            return self
        s, D = self.stage_index, self.n_data
        return StreamMesh(rank=self.data_index, size=D,
                          group=self.row_groups[s], device=self.device,
                          ranks=self.world_ranks[s * D:(s + 1) * D],
                          calls=self.calls)

    def stage_view(self) -> "StreamMesh":
        """This rank's data column as a 1-D mesh over the stage axis."""
        if self.n_stages == 1:
            raise ValueError("a 1-D mesh has no stage axis")
        d, D = self.data_index, self.n_data
        return StreamMesh(rank=self.stage_index, size=self.n_stages,
                          group=self.col_groups[d], device=self.device,
                          ranks=self.world_ranks[d::D], calls=self.calls)

    def on(self, device) -> "StreamMesh":
        """The same ranks and groups, tensors on `device`, fresh counts."""
        return replace(self, device=torch.device(device), calls={})

    # ------------------------------------------------------- collectives
    def _count(self, kind: str, t0: float, n_bytes: int) -> None:
        c = self.calls.setdefault(kind, [0, 0.0, 0])
        c[0] += 1
        c[1] += time.perf_counter() - t0
        c[2] += n_bytes

    def reset_calls(self) -> None:
        self.calls.clear()

    def all_to_all(self, buf, kind: str = "all_to_all"):
        """[size, X] -> [size, X]: row j goes to rank j, row j of the
        result came from rank j."""
        t0 = time.perf_counter()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf.contiguous(), group=self.group)
        self._count(kind, t0, buf.numel() * buf.element_size())
        return out

    def exchange(self, buf, kind: str = "all_to_all"):
        """The tiled all_to_all, differentiable: buf [size * C, ...] ->
        [size * C, ...], row block j to rank j and block j of the result
        from rank j (JAX's `lax.all_to_all(..., tiled=True)` on the
        leading axis). Its backward is the same exchange of the
        cotangent, counted under f"{kind} backward"."""
        return _Exchange.apply(buf, self, kind)

    def all_reduce_grads(self, grads: dict, kind: str = "grad_all_reduce"):
        """{name: gradient} summed over the ranks, in f32: one collective
        over the leaves packed end to end (JAX's psum of a gradient
        tree). Returns a new dict of f32 tensors."""
        flat = torch.cat([g.detach().float().reshape(-1)
                          for g in grads.values()])
        total = self.all_reduce(flat, kind=kind)
        out, at = {}, 0
        for name, g in grads.items():
            out[name] = total[at:at + g.numel()].reshape(g.shape)
            at += g.numel()
        return out

    def all_reduce(self, t, op=dist.ReduceOp.SUM, kind: str = "all_reduce"):
        """Elementwise reduction over the ranks (a new tensor)."""
        t0 = time.perf_counter()
        out = t.clone()
        dist.all_reduce(out, op=op, group=self.group)
        self._count(kind, t0, out.numel() * out.element_size())
        return out

    def all_gather(self, t, kind: str = "all_gather"):
        """[size, *t.shape]: rank j's tensor at index j."""
        t0 = time.perf_counter()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        self._count(kind, t0, t.numel() * t.element_size())
        return torch.stack(parts)

    def shift(self, rows, kind: str = "stage_shift"):
        """Circular hand-off along this mesh: rank j's `rows` arrive at
        rank (j + 1) % size, and this rank gets rank (j - 1) % size's.
        Built from one all_to_all with only the next rank's slot filled
        (gloo's point-to-point send/recv take no CUDA tensors)."""
        n = self.size
        buf = rows.new_zeros((n,) + tuple(rows.shape))
        buf[(self.rank + 1) % n] = rows
        t0 = time.perf_counter()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=self.group)
        self._count(kind, t0, rows.numel() * rows.element_size())
        return out[(self.rank - 1) % n]


class _Exchange(torch.autograd.Function):
    """`StreamMesh.exchange`: a tiled all_to_all whose transpose is
    itself (block j of rank i's cotangent goes back to rank j's block
    i)."""

    @staticmethod
    def forward(ctx, buf, mesh, kind):
        ctx.mesh, ctx.kind = mesh, kind
        return mesh.all_to_all(buf, kind)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_to_all(grad, f"{ctx.kind} backward"), None, None
