"""D3-GNN streaming engine in PyTorch + CUDA (one NVIDIA H100).

A port of the JAX package `repro` that keeps its module layout: each
module here has a counterpart of the same path under `repro/` and is held
against it by the `tests/test_torch_*.py` parity tests. The port imports
neither `jax` nor `repro`.

Entry points (`core.pipeline.D3Pipeline`, `launch.serve`) run on the CUDA
device unless the caller passes `device="cpu"`; with no device given and
no CUDA present they raise (`device.resolve_device`). On CPU tensors every
kernel wrapper runs its plain PyTorch version; on CUDA tensors it launches
the hand-written kernel in `csrc/`.
"""
