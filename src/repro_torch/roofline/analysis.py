"""Roofline terms of one call of a step, from its operation counts.

Counterpart of `repro/roofline/analysis.py`:

    compute term    = dot FLOPs / peak FLOP/s
    memory term     = bytes moved / memory bandwidth
    collective term = collective bytes / link bandwidth

per device. The JAX package reads them off a compiled HLO for a TPU;
here `analyze_step` runs the step once under `op_analyzer.OpCounter`
(on the card, or on the `meta` device, where nothing is computed) and
reads the collective bytes from the mesh the step was given
(`StreamMesh.calls`, or a `dist/dry_mesh.CountingMesh`).

Rates: one NVIDIA H100 SXM, NVIDIA's data sheet, dense (no sparsity),
at its full 700 W power limit: 989e12 FLOP/s in bf16 and fp16 on the
tensor cores, 495e12 in TF32, 67e12 in f32 outside the tensor cores,
3.35e12 B/s of HBM3. `peak_flops` picks the rate by the step's compute
dtype (f32 at TF32 only where `torch.backends.cuda.matmul.allow_tf32`
is on). A card may be set below 700 W: a share stands beside the
card's name and power limit as nvidia-smi prints them.
There is no default link rate: a collective term is computed only from
a rate the caller measured or names (`roofline_terms`' `link_bw`).
"""
from __future__ import annotations

import time

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.roofline.op_analyzer import OpCounter, tensor_bytes

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, tensor cores, dense (also fp16)
PEAK_FLOPS_TF32 = 495e12
PEAK_FLOPS_F32 = 67e12       # outside the tensor cores
HBM_BW = 3.35e12             # bytes/s


def peak_flops(dtype) -> float:
    """The card's peak for products in `dtype`."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_FLOPS_BF16
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return PEAK_FLOPS_TF32
    return PEAK_FLOPS_F32


def roofline_terms(flops: float, nbytes: float, collective_bytes, *,
                   peak_flops: float, hbm_bw: float,
                   link_bw: float | None = None) -> dict:
    """Three terms in seconds and the dominant one, the arithmetic of
    `repro/roofline/analysis.py:roofline_terms` (its per-device branch):
    one device's counts over one device's rates. t_collective_s is None
    when no link rate (or no collective count) is given, and then never
    the bottleneck."""
    t_comp = flops / peak_flops
    t_mem = nbytes / hbm_bw
    t_coll = None if link_bw is None or collective_bytes is None else \
        collective_bytes / link_bw
    terms = {"compute": t_comp, "memory": t_mem}
    if t_coll is not None:
        terms["collective"] = t_coll
    return {"t_compute_s": round(t_comp, 6), "t_memory_s": round(t_mem, 6),
            "t_collective_s": None if t_coll is None else round(t_coll, 6),
            "bottleneck": max(terms, key=terms.get)}


def _arg_bytes(args) -> int:
    return sum({id(x): tensor_bytes(x) for x in tree_leaves(args)
                if isinstance(x, torch.Tensor)}.values())


def analyze_step(fn, *args, mesh=None, compute_dtype=torch.float32,
                 device=None) -> dict:
    """Run fn(*args) once under an OpCounter; the counterpart of
    `analyze_compiled`, with its keys where the port has them:
    op_gflops (dot FLOPs, `hlo_gflops`, causal attention over its
    visible pairs; op_flops the count), op_masked_flops (the masked
    pairs' products a plain attention ran: op_flops + op_masked_flops is
    `hlo_gflops`' count), op_bytes_gb (op_bytes), collective_gb,
    collective_counts and collective_bytes_by_kind (from `mesh.calls`,
    reset first; None without a mesh), peak_memory_gb (on the card the
    allocator's peak over the call; None on `meta` and the CPU),
    argument_gb, step_s (host seconds, synchronised on the card), and
    the roofline terms at the card's rates for `compute_dtype` (no
    collective term: no link rate is assumed). Counts
    are of this call as it ran: per device for a mesh rank, global for
    a single program. "_out" holds fn's result, "_counter" the
    OpCounter. `device` is where the call runs (default: its first
    tensor argument's)."""
    dev = torch.device(device) if device is not None else next(
        (x.device for x in tree_leaves(args) if isinstance(x, torch.Tensor)),
        torch.device("cpu"))
    cuda = dev.type == "cuda"
    if mesh is not None:
        mesh.reset_calls()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with OpCounter() as counter:
        out = fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    result = {
        "op_flops": counter.flops, "op_masked_flops": counter.masked_flops,
        "op_bytes": counter.bytes,
        "op_gflops": counter.flops / 1e9,
        "op_bytes_gb": counter.bytes / 2 ** 30,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                           if cuda else None),
        "argument_gb": _arg_bytes(args) / 2 ** 30,
        "step_s": step_s,
        "collective_gb": None, "collective_counts": None,
        "collective_bytes_by_kind": None,
        "kernels": {k: {"calls": v[0], "gflops": v[1] / 1e9,
                        "gb": v[2] / 2 ** 30}
                    for k, v in counter.kernels.items()},
    }
    coll_bytes = None
    if mesh is not None:
        calls = dict(mesh.calls)
        coll_bytes = sum(c[2] for c in calls.values())
        result["collective_gb"] = coll_bytes / 2 ** 30
        result["collective_counts"] = {k: c[0] for k, c in calls.items()}
        result["collective_bytes_by_kind"] = {k: c[2]
                                              for k, c in calls.items()}
    result["peak_flops"] = peak_flops(compute_dtype)
    result.update(roofline_terms(counter.flops, counter.bytes, coll_bytes,
                                 peak_flops=result["peak_flops"],
                                 hbm_bw=HBM_BW))
    result["_out"], result["_counter"] = out, counter
    return result


def counts_of(result: dict) -> dict:
    """The additive counts of an `analyze_step` result: flops,
    masked_flops, bytes, kernels {name: [calls, flops, bytes]}, collectives {kind: [calls,
    bytes]}."""
    c = result["_counter"]
    return {"flops": c.flops, "masked_flops": c.masked_flops,
            "bytes": c.bytes,
            "kernels": {k: list(v) for k, v in c.kernels.items()},
            "collectives": {k: [result["collective_counts"][k], b]
                            for k, b in (result["collective_bytes_by_kind"]
                                         or {}).items()}}


def extrapolate(count_at, G: int, K: int = 1):
    """The counts of a step at G repeats of its layer group and K
    microbatches from probes at 1 and 2 of each: count_at(g, k) -> the
    `counts_of` dict. c(G, K) = c11 + (G-1) dG + (K-1) dK + (G-1)(K-1)
    dGK, exact for counts bilinear in (G, K), which a step that repeats
    one group over each of K identical microbatches has: the
    counterpart of the reference analyzer's while-loop trip counts.
    Returns (counts, probes)."""
    ks = (1, 2) if K > 1 else (1,)
    gs = (1, 2) if G > 1 else (1,)
    parts = {(g, k): count_at(g, k) for g in gs for k in ks}
    a, b = G - 1, K - 1
    w = {(1, 1): 1 - a - b + a * b}
    if G > 1:
        w[(2, 1)] = a - a * b
    if K > 1:
        w[(1, 2)] = b - a * b
    if G > 1 and K > 1:
        w[(2, 2)] = a * b
    out = {"flops": 0, "masked_flops": 0, "bytes": 0, "kernels": {},
           "collectives": {}}
    for p, wt in w.items():
        for key in ("flops", "masked_flops", "bytes"):
            out[key] += wt * parts[p][key]
        for group in ("kernels", "collectives"):
            for name, row in parts[p][group].items():
                acc = out[group].setdefault(name, [0] * len(row))
                for i, x in enumerate(row):
                    acc[i] += wt * x
    return out, {"layer_groups": list(gs), "to_layer_groups": G,
                 "microbatches": list(ks), "to_microbatches": K}
