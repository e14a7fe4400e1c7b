"""Build and load the hand-written CUDA kernels (nvcc -> .so -> ctypes).

Each `csrc/<name>.cu` is compiled with one nvcc call into
`build/kernels/<name>-<hash>.so` at the repository root (listed in
.gitignore), keyed by a hash of the source and the flags, at first use.
Importing this module neither builds nor looks for nvcc, so CPU-only hosts
import it freely. A build failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=None) -> dict:
    """Compile every source in `names` (default: all of csrc/*.cu) that is
    not built yet, one nvcc process per source, all started together.
    Returns {name: path}; the compiler's output (ptxas register and
    shared-memory report) is kept beside each library as <lib>.log."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _LOADED[name] = lib
    return lib


def refuse_grad(entry: str, *tensors) -> None:
    """Raise where a CUDA kernel entry that has no backward is reached
    under autograd. Its output is filled by a ctypes launch and carries
    no graph, so a loss through it would get no gradient and no error.
    Called on CUDA tensors only: the CPU paths are plain PyTorch and
    differentiate."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{entry}: the CUDA kernel has no backward, and an input "
            "requires grad, so its output would carry no gradient; call "
            "it under torch.no_grad(), or differentiate through the "
            "plain PyTorch version")
