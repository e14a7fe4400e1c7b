"""Stream meshes: one process per rank.

Counterpart of `repro/launch/mesh.py:make_stream_mesh` and
`survivor_mesh`. JAX runs the sharded tick as ONE program over the mesh's
devices; the port runs one process per rank, each holding its block of
parts, joined by a `torch.distributed` process group. A
`dist/mesh.py:StreamMesh` is that rank's view.

  make_stream_mesh()   : from an already initialized process group (one
                         process per rank started by torchrun or any
                         launcher that calls init_process_group); 1-D, or
                         2-D with stage=S (rank r = s * D + d on an S x D
                         grid), over the whole world or over `ranks=`.
  spawn_stream_mesh()  : start n ranks on this host, run fn(mesh, *args)
                         in each and return their results (rank order).
  survivor_mesh()      : the mesh after losing data columns (the live
                         reshard's target, `D3Pipeline.reshard`).
  make_production_mesh(): the dry run's target mesh, a descriptor with no
                         devices (`ProductionMesh`); `data_axes` and
                         `all_axes` read its axes.

Building a mesh is collective over the WORLD: every process calls it, in
the same order, because every subgroup (the mesh's own, one per stage row,
one per data column) is made with `dist.new_group` on every process,
members or not. A process outside the mesh gets a view with rank -1.

The backend is the caller's choice: "gloo" when ranks share a GPU (NCCL
refuses two ranks on one device) or run on the CPU; gloo moves CUDA
tensors through host memory, so each of its collectives waits for the
device.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device
from repro_torch.dist.mesh import StreamMesh


def make_stream_mesh(device=None, stage: int = 1, group=None,
                     ranks=None) -> StreamMesh:
    """This process's view of a stream mesh over an initialized process
    group. device: where this rank runs (default: cuda:<LOCAL_RANK %
    device count>; raises without CUDA, as every entry point of the port
    does). stage: the number of pipeline stages (1 = the 1-D mesh); the
    rank count must be a multiple of it. ranks: the world ranks the mesh
    spans, increasing (default: all of them, or `group`'s on a 1-D mesh
    over a given group). Collective over the world when it makes
    subgroups: every process calls it, members or not."""
    if not dist.is_initialized():
        raise RuntimeError("make_stream_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    stage = int(stage)
    if stage < 1:
        raise ValueError(f"stage={stage} must be >= 1")
    if device is None:
        resolve_device()                      # raises without CUDA
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if group is not None:
        if ranks is not None or stage != 1:
            raise ValueError("group= builds a 1-D mesh over that group; "
                             "pass ranks= (and stage=) instead")
        return StreamMesh(rank=dist.get_rank(group),
                          size=dist.get_world_size(group), group=group,
                          device=device)
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(
        int(r) for r in ranks)
    if list(ranks) != sorted(set(ranks)) or not ranks \
            or ranks[-1] >= world or ranks[0] < 0:
        raise ValueError(f"ranks={ranks} must be distinct, increasing "
                         f"world ranks below {world}")
    n = len(ranks)
    if n % stage:
        raise ValueError(
            f"requested {n} devices over stage={stage} pipeline stages: "
            "the device count must be a multiple of the stage count "
            f"(each stage gets {n} / {stage} data shards)")
    D = n // stage
    whole = len(ranks) == world
    mesh_group = None if whole else dist.new_group(list(ranks))
    rows = cols = ()
    if stage > 1:
        rows = tuple(dist.new_group([ranks[s * D + d] for d in range(D)])
                     for s in range(stage))
        cols = tuple(dist.new_group([ranks[s * D + d] for s in range(stage)])
                     for d in range(D))
    me = dist.get_rank()
    return StreamMesh(rank=ranks.index(me) if me in ranks else -1, size=n,
                      group=mesh_group, device=device, n_stages=stage,
                      ranks=() if whole else ranks, row_groups=rows,
                      col_groups=cols)


def survivor_mesh(mesh: StreamMesh, lost_data_shards,
                  n_data: int | None = None) -> StreamMesh:
    """The mesh after fail-stop loss of `lost_data_shards` (data-axis
    column indices of `mesh`): the stage extent stays, the lost data
    columns go, and `n_data` optionally trims to the first surviving
    columns (block sharding needs n_parts % n_data == 0, so recovery may
    keep fewer shards than survived). The lost ranks own nothing
    afterwards: `D3Pipeline.reshard(survivor_mesh(...))` relays all state
    onto the survivors. Collective over the world, as make_stream_mesh."""
    S, D = mesh.n_stages, mesh.n_data
    lost = {int(s) for s in lost_data_shards}
    keep = [d for d in range(D) if d not in lost]
    if n_data is not None:
        keep = keep[: int(n_data)]
    if not keep:
        raise ValueError("no surviving data shards after "
                         f"losing {sorted(lost)}")
    wr = mesh.world_ranks
    return make_stream_mesh(mesh.device, stage=S, ranks=[
        wr[s * D + d] for s in range(S) for d in keep])


def _rank_main(rank, n, fn, backend, device, stage, store_path, out_dir,
               args, timeout):
    try:
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout))
        # the ranks share this host's cores: without a split, n ranks of
        # all-core thread pools oversubscribe it many times over
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0 if backend == "gloo" else rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        result = fn(make_stream_mesh(dev, stage=stage), *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    except BaseException:
        # the parent reports every rank's failure, earliest first: the
        # first is the cause, the others' lost connections follow from it
        (Path(out_dir) / f"rank{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _join(ctx, tmp, n, deadline) -> bool:
    """ctx.join for at most 5 s; a failed rank raises RuntimeError with
    the tracebacks the failed ranks wrote, earliest first."""
    try:
        return ctx.join(timeout=max(0.0, min(
            5.0, deadline - time.monotonic())))
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        errs = sorted(Path(tmp).glob("rank*.err"),
                      key=lambda f: f.stat().st_mtime_ns)
        raise RuntimeError(
            f"stream mesh of {n} ranks failed:\n" + ("\n".join(
                f.read_text() for f in errs) or str(e))) from e


def spawn_stream_mesh(n: int, fn, *, backend: str, device, args=(),
                      stage: int = 1, timeout: float = 600.0):
    """Run fn(mesh, *args) on n new ranks of this host and return the n
    results in rank order (fn and its results must pickle).

    Ranks start with the "spawn" method (a parent holding a CUDA context
    cannot fork) and meet through a FileStore in a fresh temporary
    directory, so concurrent meshes on one host never share a port. The
    backend is explicit: "gloo" for ranks sharing a GPU or on the CPU.
    stage > 1 gives each rank its view of an S x (n // S) grid.
    device "cuda" puts every gloo rank on cuda:0 (each NCCL rank on
    cuda:<rank>). A rank that raises, or a mesh that outlives `timeout`
    seconds, kills the other ranks and raises here; the error holds every
    failed rank's traceback, the earliest failure first."""
    if n % int(stage):
        raise ValueError(f"requested {n} devices over stage={stage} "
                         "pipeline stages: the device count must be a "
                         "multiple of the stage count")
    tmp = tempfile.mkdtemp(prefix="stream_mesh-")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(n, fn, backend, str(device), int(stage),
                              os.path.join(tmp, "store"), tmp, tuple(args),
                              timeout),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not _join(ctx, tmp, n, deadline):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"stream mesh of {n} ranks still running "
                                   f"after {timeout} s")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@dataclass(frozen=True)
class ProductionMesh:
    """A named grid of devices that holds no device: what the dry run's
    sharding rules read of a mesh (`axis_names`, `shape` by name, `size`),
    as `dist/sharding.py` reads them. Building one touches neither the
    process group nor CUDA."""
    axis_names: tuple
    dims: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The dry run's production mesh (`repro/launch/mesh.py:15`): (16, 16)
    over ("data", "model"), 256 devices, or (2, 16, 16) over ("pod",
    "data", "model"), 512."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 16, 16))
    return ProductionMesh(("data", "model"), (16, 16))


def data_axes(mesh) -> tuple:
    """The data-parallel axes: ("pod", "data") on multi-pod, else
    ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def all_axes(mesh) -> tuple:
    return tuple(mesh.axis_names)
