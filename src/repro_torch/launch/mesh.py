"""The 1-D ("data",) stream mesh: one process per rank.

Counterpart of `repro/launch/mesh.py:make_stream_mesh` (1-D). JAX runs the
sharded tick as ONE program over the mesh's devices; the port runs one
process per rank, each holding its block of parts, joined by a
`torch.distributed` process group. A `dist/mesh.py:StreamMesh` is that
rank's view.

  make_stream_mesh()   : from an already initialized process group (one
                         process per rank started by torchrun or any
                         launcher that calls init_process_group).
  spawn_stream_mesh()  : start n ranks on this host, run fn(mesh, *args)
                         in each and return their results (rank order).

The backend is the caller's choice: "gloo" when ranks share a GPU (NCCL
refuses two ranks on one device) or run on the CPU; gloo moves CUDA
tensors through host memory, so each of its collectives waits for the
device. The 2-D ("stage", "data") mesh is not ported (ROADMAP Queue 1
item 13).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device
from repro_torch.dist.mesh import StreamMesh


def _refuse_stages(stage: int) -> None:
    if int(stage) != 1:
        raise NotImplementedError(
            f"stage={stage}: the 2-D ('stage', 'data') mesh is not ported "
            "to repro_torch yet (ROADMAP Queue 1 item 13)")


def make_stream_mesh(device=None, stage: int = 1, group=None) -> StreamMesh:
    """This process's rank of the 1-D mesh over `group` (default: the
    initialized default process group). device: where this rank runs
    (default: cuda:<LOCAL_RANK % device count>; raises without CUDA, as
    every entry point of the port does). stage > 1 raises
    NotImplementedError."""
    _refuse_stages(stage)
    if not dist.is_initialized():
        raise RuntimeError("make_stream_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    if device is None:
        resolve_device()                      # raises without CUDA
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return StreamMesh(rank=rank, size=size, group=group,
                      device=torch.device(device))


def _rank_main(rank, n, fn, backend, device, store_path, out_dir, args,
               timeout):
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
        result = fn(make_stream_mesh(dev), *args)
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
    device "cuda" puts every gloo rank on cuda:0 (each NCCL rank on
    cuda:<rank>). A rank that raises, or a mesh that outlives `timeout`
    seconds, kills the other ranks and raises here; the error holds every
    failed rank's traceback, the earliest failure first."""
    _refuse_stages(stage)
    tmp = tempfile.mkdtemp(prefix="stream_mesh-")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(n, fn, backend, str(device),
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
