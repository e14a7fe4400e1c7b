#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and nvcc.
Phases (any failure exits non-zero; no phase is caught):

  1. the card's name and power limit (nvidia-smi); build of every kernel
     in src/repro_torch/csrc/ with nvcc for sm_90a (seconds, ptxas report);
  2. each kernel against its plain PyTorch version on the card: edge cases
     (last-writer-wins, all-padding, sentinel rows, a hub run, cnt <= 0)
     and the main path's shapes, and the "kernel" delivery backend against
     the "scatter" one;
  3. parity gate: the port's serve CLI at --edges 1500, dims (16,64,64),
     must print the JAX package's pinned counts (tick 3032/2491, super
     3049/2507) with equal materialized counts;
  4. full width: GraphSAGE (602, 64, 64), the paper model's published
     widths, streams ~400K power-law edges through the super-tick driver
     on the "kernel" backend; both kernels must have launched during the
     run; the sink is checked against the float64 static oracle and
     against the same stream through the "scatter" backend;
  5. each kernel timed at main-path shapes beside its plain version, the
     library call computing the same function and its memory bound; one
     JSON `kernels` line;
  6. device time by operator over one steady-state full-width super-tick
     (torch.profiler), beside its wall and host staging time.

Then the sharded 1-D mesh path, four gloo ranks that share the card (one
process each, started after the parent frees its memory; every kernel is
built before any rank starts):

  [mesh-kernel] the route_pack kernel against its plain version, bit for
     bit (int32 views): N = 0, every row dropped, every bucket
     overflowing, cap = 1, D in {2, 4} x W in {1, 5, 69, 607}, NaN / Inf /
     -0.0 rows, hub-skewed destinations, integer columns through the
     packed wire, and the full-width layer-0 RMI lane (W = 607, 299,008
     rows: a 32,768-row ring and 266,240 fresh);
  [mesh-parity] the serve CLI's --edges 1500 stream (dims 16,64,64) at
     route_cap 2176 (C // D) and 16, each on the card and on the CPU over
     the same gloo group: integer TickStats of every super-tick, busy and
     metrics (wire counters included) exactly equal, float state within
     MESH_TOL;
  [mesh-full] GraphSAGE (602, 64, 64) with FULL's caps (16 parts a rank),
     route_cap 4096, route_defer_cap 32,768, 100,000 power-law edges,
     super-tick driver: no row dropped, route_pack launched 4 times a tick
     on every rank, the sink within SINK_TOL of the float64 oracle and of a
     single-rank run whose aggregator counts it equals; edges/s, wire
     counters, collectives (host syncs) per super-tick, time blocked in
     all_to_all and peak memory per rank;
  [mesh-time] route_pack at [mesh-full]'s layer-0 RMI shape and at the
     dense shape beside its bound, its plain version and zeros +
     index_copy_ of pre-gathered rows (timed only, as a yardstick).

Then the LM serve path (mistral-nemo-12b), after the phases above free
their memory:

  [lm-kernel] the flash-attention kernel against its plain version in
     bf16 and f32, each measured against float64 attention per 64-query
     block of one head: causal and not, GQA G in {1, 4}, ragged S and T,
     every head dim, strided q/k/v, and one layer's q/k/v at S = 32768,
     where two planted faults (output x 0.9; one kv tile dropped from one
     block) must be rejected;
  [lm-parity] the reduced config (f32, TF32 off) built on the CPU from a
     seed, its state_dict copied to the card: a 512-token prefill and 8
     greedy decode steps give equal tokens and logits on both;
  [lm-full] the published widths and depth (40 layers), random weights
     drawn on the card: at S = 2048 the kernel path agrees with the
     plain-attention path; one prefill_32k prefill (S = 32768, batch cut
     from 32 to 1) with finite logits and exactly 40 kernel launches; the
     serve CLI at full width (batch 4, 32 tokens); prefill and decode
     tokens/s and peak memory;
  [lm-time] the kernel at the prefill shape beside its bound, its plain
     version and scaled_dot_product_attention (timed only, as a yardstick).

Then the two-tower recsys serve path (two-tower-retrieval), after the LM
phases free their memory:

  [rs-kernel] the embedding-bag kernel against its plain version: sum and
     mean, W in {1, 2, 3, 8, 16}, d in {16, 30, 32, 256}, int32 and int64
     ids, all-padding bags, ids < -1, ids >= V (NaN in the same bags as
     the plain version and nowhere else), B = 0 and B = 100; and 4096 bags
     of the full-width shape (W 8, d 256, the item table's 10,000,384
     rows) against float64 bags;
  [rs-parity] the reduced config built on the CPU from a seed, its
     state_dict copied to the card (TF32 off): serve_p99, serve_bulk and
     retrieval_cand at small batches agree, one kernel launch per tower;
  [rs-full] the published widths, the user table cut to 50,000,384 rows
     for one card (configs/two_tower_retrieval.py), tables drawn on the
     card: 64 serve_p99 requests through the serve CLI, 2 serve_bulk
     steps of 262,144 pairs, 2 retrieval_cand queries over 1,000,448
     candidates; unit-norm user vectors, the first request equal to its
     plain-lookup path, exact launch counts; users/s with p50/p99 ms,
     pairs/s, ms per query, peak memory; one request under torch.profiler;
  [rs-time] the kernel at retrieval_cand's item side (2,000,896 bags)
     on a fresh item-sized table beside its bound, its plain version and
     F.embedding_bag (timed only, as a yardstick).

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the repository around it, the script exits non-zero and prints no
result.
"""
import copy
import gc
import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet), used for the bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12      # tensor cores, dense

# full-width configuration: the paper model's widths (configs/d3gnn_sage.py
# D_IN, D_HID) with depth (parts, caps) cut from the 1024-part sizing
FULL = dict(n_nodes=40_000, n_edges=400_000, tick_edges=4096,
            super_ticks=8, dims=(602, 64, 64),
            caps=dict(n_parts=64, node_cap=4096, edge_cap=16384,
                      repl_cap=8192, feat_cap=8192, edge_tick_cap=4096))

# kernel A vs its plain version: per row, |diff| <= KA_TOL * (1 + sum|x|)
# over the run (f32 sums in another order); count and touch columns exact.
# kernel B vs plain: |diff| <= KB_TOL * (1 + |ref|) (same IEEE division).
# sink vs oracle and vs the scatter backend: |diff| <= SINK_TOL *
# max(1, |ref|) (streamed f32 sums of telescoping deltas vs a static sum).
KA_TOL, KB_TOL, SINK_TOL = 1e-5, 1e-6, 1e-4

# the sharded 1-D mesh path: d3gnn-sage at FULL's widths and caps on 4
# gloo ranks that share the one card (NCCL refuses two ranks on one
# device). Cuts: 100,000 edges (FULL streams 400,000) to hold the script's
# time; route_cap 4096 rows a destination bucket (the dense buckets would
# be 131,072 and 266,240 rows), route_defer_cap 32,768 ring rows a lane a
# rank. `live` is the share of live rows in the synthetic layer-0 RMI lane
# [mesh-kernel] and [mesh-time] pack. [mesh-parity] runs the serve CLI's
# stream (8 parts, 2 a rank) at route_cap 2176 = its RMI lane's C // D
# (512 + 2 x 4096 rows over 4 ranks) and 16, where rows defer without
# dropping. Not at 2: two rows a destination a tick cannot drain the
# stream's backlog within the serve CLI's 64 flush ticks, and serve_stream
# raises "pipeline failed to terminate" (a CPU run).
MESH = dict(ranks=4, n_edges=100_000, route_cap=4096, route_defer_cap=32768,
            live=0.05, parity_edges=1500, parity_caps=(2176, 16),
            timeout=900)
# [mesh-parity] float state, card vs CPU: |diff| <= MESH_TOL * (1 + |cpu|)
# (f32 sums of the same records in another order)
MESH_TOL = 1e-5

# LM serve path: mistral-nemo-12b at its published widths and depth;
# prefill_32k's batch cut from 32 to 1
LM = dict(arch="mistral-nemo-12b", shape="prefill_32k",
          check_s=2048, decode_tokens=32,
          prefill_qkv=(1, 32768, 32, 8, 128))   # B, S, H, Kh, D: one layer
# flash kernel vs its plain version, both measured against float64
# attention on the same inputs, per block of FA_ROWS query rows of one head
# (one CTA of the kernel): ||kernel - f64|| <= FA_RATIO * ||plain - f64|| +
# FA_FLOOR * ||f64||. The two round p and the output at the same points, so
# a right kernel errs as much as the plain version, give or take the order
# of its f32 sums; the floor covers blocks that both get (almost) exact.
FA_ROWS = 64
FA_RATIO = {"bf16": 1.5, "f32": 4.0}
FA_FLOOR = {"bf16": 2.0 ** -10, "f32": 1e-6}
# reduced f32 model, CPU vs card, TF32 off: |diff| <= LM_PARITY_TOL *
# (1 + |cpu|) on logits (f32 sums in another order over 4 layers)
LM_PARITY_TOL = 1e-4
# full width bf16 at S = check_s, over the final hidden states: kernel path
# vs plain-attention path ||h_kernel - h_plain|| / ||h_plain|| <=
# LM_PATH_TOL (40 layers of bf16 rounding at other places), and the kernel
# path no farther than LM_PATH_RATIO times the plain path from a path whose
# attention runs in f32
LM_PATH_TOL, LM_PATH_RATIO = 3e-2, 1.25

# two-tower serve path at full width (the user table cut for one card);
# bulk/cand None: the serve_bulk and retrieval_cand shapes of input_specs
RS = dict(arch="two-tower-retrieval", requests=64, bulk_steps=2, queries=2,
          bulk=None, cand=None, check_bags=4096, time_bags=2_000_896,
          time_rows=10_000_384)
# embedding-bag kernel vs plain version (and vs float64 bags), per element:
# |diff| <= EB_TOL * (1 + sum_i |w_i row_i|): f32 sums of at most W terms
# in another order; mean divides once by the same count
EB_TOL = 1e-6
# reduced f32 two-tower, card vs CPU, TF32 off; the full-width first
# request, kernel vs plain lookup: |diff| <= RS_TOL * (1 + |ref|) (f32
# matmuls in another order; scores are divided by the 0.05 temperature)
RS_TOL = 1e-5


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def sync(t):
    import torch
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# ------------------------------------------------------------- phase 1
def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


def kernel_names(mangled):
    """Short names (flash_wgmma_kernel<128, 3>) of mangled kernel names,
    through c++filt where the host has it, else the names as they are."""
    import shutil
    if not mangled or not shutil.which("c++filt"):
        return list(mangled)
    out = subprocess.run(["c++filt"], input="\n".join(mangled),
                         capture_output=True, text=True, timeout=60).stdout
    return [line.removeprefix("void ").removeprefix("(anonymous namespace)::")
            .split("(")[0] for line in out.splitlines()]


def build_kernels():
    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    paths = cuda_lib.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernel source(s) in {secs:.2f}s: "
          + ", ".join(p.name for p in paths.values()))
    for p in paths.values():
        log = p.with_suffix(".log")
        if not log.exists():
            continue
        entries, lines = [], []   # ptxas's report, line by line, by kernel
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line and "'" in line:
                entries.append(line.split("'")[1])
            elif ("registers" in line or "spill" in line) and entries:
                lines.append((len(entries) - 1, line.strip()))
        names = kernel_names(entries)
        for i, line in lines:
            print(f"[build] {names[i]}: {line}")
    from repro_torch.kernels.flash_attention import ops as fa
    print(f"[build] flash_wgmma_kernel dynamic shared memory: "
          + ", ".join(f"D={D} {fa.wgmma_smem_bytes(D)} bytes"
                      for D in fa.WGMMA_HEAD_DIMS))
    return secs


# ------------------------------------------------------------- phase 2
def kernel_a_check(ops, ref, payload, seg, row_ptr):
    """Kernel A vs its plain version on one layout; returns max abs err."""
    import torch
    got = ops.segment_sum_rows(payload, seg, row_ptr)
    want = ref.segment_sum_rows_ref(payload, seg, row_ptr)
    absum = ref.segment_sum_rows_ref(payload.abs(), seg, row_ptr)
    sync(got)
    d = payload.shape[1] - 2
    err = (got[:, :d] - want[:, :d]).abs()
    check(bool((err <= KA_TOL * (1 + absum[:, :d])).all()),
          f"segment_sum_rows disagrees: max err {float(err.max())}")
    check(torch.equal(got[:, d:], want[:, d:]),
          "segment_sum_rows count/touch columns differ")
    return float(err.max()) if err.numel() else 0.0


def kernel_b_check(ops, ref, agg, cnt, rows):
    import torch
    got = ops.mean_rows_gather(agg, cnt, rows)
    want = ref.mean_rows_gather_ref(agg, cnt, rows)
    sync(got)
    err = (got - want).abs()
    check(bool((err <= KB_TOL * (1 + want.abs())).all()),
          f"mean_rows_gather disagrees: max err {float(err.max())}")
    zero_rows = cnt[rows] <= 0
    check(bool((got[zero_rows] == 0).all()), "cnt <= 0 rows must read 0")
    return float(err.max()) if err.numel() else 0.0


def powerlaw_rows(gen, n_rows, size, alpha=1.5):
    """Destination rows with a power-law skew (row 0 is a hub)."""
    import torch
    w = torch.arange(1, n_rows + 1, dtype=torch.float64,
                     device=gen.device) ** (-alpha)
    return torch.multinomial(w, size, replacement=True, generator=gen)


def phase_kernels_vs_plain(device, full=FULL):
    """Edge cases + main-path shapes; returns max abs errors per kernel."""
    import torch
    from repro_torch.core.delivery import KernelDelivery, ScatterDelivery
    from repro_torch.kernels.segment_reduce import ops, ref
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"segment_sum_rows": 0.0, "mean_rows_gather": 0.0}
    kd, sd = KernelDelivery(), ScatterDelivery()

    def on(t):
        return t.to(device)

    def deliver_case(idx, vec, cnt, n_rows):
        idx, vec, cnt = on(idx), on(vec), on(cnt)
        for mode in ("add", "set"):
            e = kernel_a_check(ops, ref, *ops.deliver_layout(
                idx, vec, cnt, n_rows, mode))
            errs["segment_sum_rows"] = max(errs["segment_sum_rows"], e)
        dst = torch.randn(n_rows, vec.shape[1], generator=gen,
                          device=device)
        got, gt = kd.deliver_set(dst, idx, vec)
        want, wt = sd.deliver_set(dst, idx, vec)
        check(torch.equal(got, want) and torch.equal(gt, wt),
              "kernel deliver_set differs from scatter (last writer wins)")
        cnt0 = torch.zeros(n_rows, device=device)
        ga, gc, gd = kd.deliver_add(dst, cnt0, idx, vec, cnt)
        wa, wc, wd = sd.deliver_add(dst, cnt0, idx, vec, cnt)
        check(torch.equal(gc, wc) and torch.equal(gd, wd),
              "kernel deliver_add counts/dirty differ from scatter")
        # f32 sums in two orders: bounded by the run's sum of magnitudes
        absum = sd.deliver_add(dst.abs(), cnt0, idx, vec.abs(), cnt)[0]
        err = (ga - wa).abs()
        check(bool((err <= KA_TOL * (1 + absum)).all()),
              f"kernel deliver_add sums differ from scatter: max err "
              f"{float(err.max())} (C={idx.shape[0]}, rows={n_rows})")

    # last-writer-wins with duplicates, sentinel and negative rows
    deliver_case(torch.tensor([3, 5, 3, 3, 5, 8, 9, -1, 7]),
                 torch.arange(18, dtype=torch.float32).reshape(9, 2),
                 torch.arange(9, dtype=torch.float32), 8)
    # all padding
    deliver_case(torch.full((300,), 99), torch.ones(300, 5),
                 torch.ones(300), 16)
    # one hub run spanning many kernel tiles
    deliver_case(torch.full((5000,), 11),
                 torch.randn(5000, 70, generator=gen, device=device),
                 torch.ones(5000), 40)
    # main-path shapes (layer 0 at full width): the round-B RMI lane
    # (edge_tick_cap + P * edge_cap records, power-law destinations) and
    # the broadcast lane (P * repl_cap records) into P * node_cap rows
    c = full["caps"]
    n_rows, d = c["n_parts"] * c["node_cap"], full["dims"][0]
    for C in (c["edge_tick_cap"] + c["n_parts"] * c["edge_cap"],
              c["n_parts"] * c["repl_cap"]):
        idx = powerlaw_rows(gen, n_rows, C)
        idx[torch.rand(C, generator=gen, device=device) < 0.4] = n_rows
        deliver_case(idx, torch.randn(C, d, generator=gen, device=device),
                     torch.randint(-1, 2, (C,), generator=gen,
                                   device=device).float(), n_rows)
        del idx
    # kernel B: cnt <= 0 rows, a repeated hub row, main-path shapes
    K = c["n_parts"] * (c["feat_cap"] // c["n_parts"])
    for R, dd in ((50, 3), (n_rows, d), (n_rows, full["dims"][1])):
        agg = torch.randn(R, dd, generator=gen, device=device)
        cnt = torch.randint(-2, 6, (R,), generator=gen,
                            device=device).float()
        rows = torch.cat([torch.zeros(7, dtype=torch.int64, device=device),
                          torch.randint(0, R, (K,), generator=gen,
                                        device=device)])
        errs["mean_rows_gather"] = max(errs["mean_rows_gather"],
                                       kernel_b_check(ops, ref, agg, cnt,
                                                      rows))
    print(f"[kernels] plain-version checks passed; max abs err {errs}")
    return errs


# ------------------------------------------------------------- phase 3
def phase_parity_gate(device):
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.launch import serve
    pinned = {"tick": (3032, 2491), "super": (3049, 2507)}
    materialized = set()
    ops.reset_launches()
    for driver, counts in pinned.items():
        pipe = serve.main(["--edges", "1500", "--driver", driver,
                           "--device", str(device)])
        got = (pipe.metrics.reduce_msgs, pipe.metrics.cross_part_msgs)
        check(got == counts, f"serve --driver {driver}: {got} != {counts}")
        materialized.add(len(pipe.embeddings()))
    check(len(materialized) == 1, f"materialized counts differ: "
                                  f"{materialized}")
    print(f"[parity] serve counts match the JAX pins; materialized "
          f"{materialized.pop()}; launches {dict(ops.LAUNCHES)}")


# ------------------------------------------------------------- phase 4
def make_stream(n_nodes, n_edges, d_in):
    from repro_torch.graph.graphs import powerlaw_edges
    rng = np.random.default_rng(SEED)
    edges = powerlaw_edges(rng, n_nodes, n_edges)
    x = rng.normal(size=(n_nodes, d_in)).astype(np.float32)
    return edges, {v: x[v] for v in range(n_nodes)}


def stream_pipeline(full, backend, device, edges, feats):
    """Stream + flush with the super-tick driver. Returns (pipeline, wall
    seconds, synchronizing CUDA calls by call site during the stream)."""
    import torch
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                         delivery_backend=backend,
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4))
    pipe = D3Pipeline(GraphSAGE(full["dims"], seed=SEED), cfg, device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            pipe.run_stream_super(edges, feats,
                                  tick_edges=full["tick_edges"],
                                  super_ticks=full["super_ticks"])
            pipe.flush_super(max_ticks=256, T=full["super_ticks"])
            if cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    # the harness's own closing torch.cuda.synchronize() is not counted
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchronizing CUDA operation" in str(w.message)
                    and Path(w.filename).name != Path(__file__).name)
    return pipe, secs, sites


def sink_error(got: dict, want):
    """(max over materialized vids of |got - ref| / max(1, |ref|), the vid
    where it occurs); `want(vids)` returns the float64 reference rows."""
    import torch
    vids = sorted(got)
    g = torch.as_tensor(np.stack([got[v] for v in vids]), dtype=torch.float64)
    w = want(vids)
    rel = ((g - w).abs() / torch.clamp(w.abs(), min=1.0)).amax(dim=1)
    i = int(rel.argmax())
    return float(rel[i]), vids[i]


def phase_full_width(full, device, check_launches=True):
    import torch
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    from repro_torch.kernels.segment_reduce import ops
    edges, feats = make_stream(full["n_nodes"], full["n_edges"],
                               full["dims"][0])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    pipe, secs, sync_sites = stream_pipeline(full, "kernel", device, edges,
                                             feats)
    launches = dict(ops.LAUNCHES)
    n_syncs = sum(sync_sites.values())
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    m = pipe.metrics
    emb = pipe.embeddings()
    print(f"[full] caps {full['caps']} dims {full['dims']} "
          f"window session(4) driver super(T={full['super_ticks']})")
    print(f"[full] {full['n_edges']} edges in {secs:.3f}s = "
          f"{full['n_edges'] / secs:.1f} events/s; ticks {m.ticks}; "
          f"RMIs {m.reduce_msgs}; cross-part msgs {m.cross_part_msgs}; "
          f"materialized {len(emb)}; host staging {m.host_seconds:.3f}s; "
          f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    n_super = m.ticks // full["super_ticks"]
    print(f"[full] launches {launches}; synchronizing CUDA calls "
          f"{n_syncs} over {n_super} super-ticks")
    if device.type == "cuda":
        check(n_syncs == n_super, "the super-tick driver must sync with "
              f"the host once per super-tick: {n_syncs} syncs at "
              f"{dict(sync_sites.most_common(8))}")
    if check_launches:
        check(all(v > 0 for v in launches.values()),
              f"a kernel never launched on the main path: {launches}")
    check(len(emb) > 0, "nothing materialized")
    check(all(np.isfinite(v).all() and v.shape == (full["dims"][-1],)
              for v in emb.values()), "non-finite or misshapen embeddings")

    # the float64 static oracle on the final snapshot, on the device
    model64 = copy.deepcopy(pipe.model).double()
    g, _ = build_snapshot(edges, feats, full["dims"][0], full["n_nodes"],
                          device, dtype=torch.float64)
    ref = oracle_embeddings(model64, g).cpu()
    del model64, g
    to_ref = lambda vids: ref[vids]

    # the same stream through the reference scatter backend
    other, _, _ = stream_pipeline(full, "scatter", device, edges, feats)
    check((other.metrics.reduce_msgs, other.metrics.cross_part_msgs,
           other.metrics.ticks) == (m.reduce_msgs, m.cross_part_msgs,
                                    m.ticks),
          "scatter backend counts differ from the kernel backend")
    for a, b in zip(other.states, pipe.states):
        check(torch.equal(a.agg_cnt, b.agg_cnt), "aggregator counts differ")
    emb_s = other.embeddings()
    check(set(emb_s) == set(emb), "materialized sets differ")
    indeg = np.bincount(edges[:, 1], minlength=full["n_nodes"])
    errs = {"kernel vs oracle": sink_error(emb, to_ref),
            "scatter vs oracle": sink_error(emb_s, to_ref),
            "kernel vs scatter": sink_error(emb, lambda vids: torch.as_tensor(
                np.stack([emb_s[v] for v in vids]), dtype=torch.float64))}
    for what, (err, vid) in errs.items():
        print(f"[full] sink {what}: max |diff|/max(1,|ref|) {err:.3e} at "
              f"vid {vid} (in-degree {indeg[vid]}); tolerance {SINK_TOL}")
    for what, (err, _) in errs.items():
        check(err <= SINK_TOL, f"sink {what}: {err:.3e} > {SINK_TOL}")
    del other
    return pipe, launches


# ------------------------------------------------------------- phase 5
def time_ms(fn, iters=10, flush_bytes=256 << 20):
    """Mean device time of fn with CUDA events, one launch per event pair,
    L2 flushed (by a write larger than the 50 MB L2) before each."""
    import torch
    scratch = torch.empty(flush_bytes // 4, dtype=torch.float32,
                          device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound_ms(n_bytes, n_ops):
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S) * 1e3


def phase_timing(pipe, launches, errs):
    """Time both kernels on inputs of the main path at full width: the
    final topology's layer-0 RMI lane with every edge live (the heaviest
    round-B delivery), and the forward stage's per-part picks read from
    the final layer-0 aggregator table."""
    import torch
    from repro_torch.core.state import local_index
    from repro_torch.kernels.segment_reduce import ops, ref
    cfg, topo, ls, dev = pipe.cfg, pipe.topo, pipe.states[0], pipe.device
    P, N, d = ls.agg.shape
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # kernel A: the RMI lane (edge_tick_cap fresh + P * edge_cap records)
    idx, _ = local_index(topo.e_dst_mpart.reshape(-1),
                         topo.e_dst_mslot.reshape(-1), 0, P, N,
                         topo.e_valid.reshape(-1))
    idx = torch.cat([torch.full((cfg.edge_tick_cap,), P * N, device=dev),
                     idx])
    C = idx.shape[0]
    vec = torch.randn(C, d, device=dev, generator=gen)
    payload, seg, row_ptr = ops.deliver_layout(
        idx, vec, torch.ones(C, device=dev), P * N, "add")
    del vec
    errs["segment_sum_rows"] = max(errs["segment_sum_rows"],
                                   kernel_a_check(ops, ref, payload, seg,
                                                  row_ptr))
    live = int(row_ptr[-1])
    W = payload.shape[1]
    a_ms = time_ms(lambda: ops.segment_sum_rows(payload, seg, row_ptr))
    a_plain = time_ms(lambda: ref.segment_sum_rows_ref(payload, seg,
                                                       row_ptr))
    seg_l, rows_l = seg[:live], payload[:live]
    a_lib = time_ms(lambda: torch.zeros(P * N, W, device=dev).index_add_(
        0, seg_l, rows_l))
    a_bound = bound_ms(live * W * 4 + live * 8 + (P * N + 1) * 8
                       + P * N * W * 4, live * W)
    print(f"[time] segment_sum_rows: E={C} live={live} W={W} rows={P * N}")
    del payload, seg, row_ptr, seg_l, rows_l

    # kernel B: the first outbox_per_part evicting masters of every part
    k = cfg.capacities().outbox_per_part
    order = torch.where(topo.is_master, torch.arange(N, device=dev), N)
    picked = torch.clamp(torch.topk(order, k, dim=1, largest=False).values,
                         max=N - 1)
    rows = (torch.arange(P, device=dev)[:, None] * N + picked).reshape(-1)
    agg, cnt = ls.agg.reshape(P * N, d), ls.agg_cnt.reshape(P * N)
    errs["mean_rows_gather"] = max(errs["mean_rows_gather"],
                                   kernel_b_check(ops, ref, agg, cnt, rows))
    K = rows.shape[0]
    b_ms = time_ms(lambda: ops.mean_rows_gather(agg, cnt, rows))
    b_plain = time_ms(lambda: ref.mean_rows_gather_ref(agg, cnt, rows))
    b_bound = bound_ms(K * d * 4 + K * 4 + K * 8 + K * d * 4, K * d)
    print(f"[time] mean_rows_gather: K={K} d={d} table rows={P * N}")

    src = "src/repro_torch/csrc/segment_reduce.cu"
    tpu = "src/repro/kernels/segment_reduce/kernel.py"
    return {"kernels": [
        {"name": "segment_sum_rows", "route": "cuda", "source": src,
         "replaces": f"{tpu}:59",
         "launches": launches["segment_sum_rows"],
         "max_abs_err": errs["segment_sum_rows"], "ms": a_ms,
         "plain_ms": a_plain, "bound_ms": a_bound, "bound_by": "bytes",
         "library_ms": a_lib},
        {"name": "mean_rows_gather", "route": "cuda", "source": src,
         "replaces": f"{tpu}:95",
         "launches": launches["mean_rows_gather"],
         "max_abs_err": errs["mean_rows_gather"], "ms": b_ms,
         "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": "bytes",
         "library_ms": None}]}


# ------------------------------------------------------------- phase 6
def phase_profile(full, device, warm_super_ticks=6, top=12):
    """Device time by operator over ONE steady-state full-width
    super-tick (torch.profiler), after `warm_super_ticks` unprofiled ones
    of the same stream: the per-operator breakdown of the tick program."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.core import windowing as win
    from repro_torch.graph.sage import GraphSAGE
    edges, feats = make_stream(full["n_nodes"], full["n_edges"],
                               full["dims"][0])
    cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4))
    pipe = D3Pipeline(GraphSAGE(full["dims"], seed=SEED), cfg, device=device)
    T = full["super_ticks"]
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, full["tick_edges"])
    for lo in range(0, warm_super_ticks * T, T):
        pipe.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T)
    lo = warm_super_ticks * T
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    host0 = pipe.metrics.host_seconds
    sync(torch.zeros((), device=device))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T)
        sync(torch.zeros((), device=device))
        wall = time.perf_counter() - t0
    host = pipe.metrics.host_seconds - host0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # device-side activities only (kernels, copies, fills): the aten ops
    # that launch them carry the same time again; CUPTI's "Command Buffer
    # Full" marks a full launch queue, not device work
    events = [e for e in prof.key_averages()
              if "CUDA" in str(e.device_type) and dev_us(e) > 0
              and e.key != "Command Buffer Full"]
    total = sum(dev_us(e) for e in events) / 1e3
    print(f"[profile] super-tick of {T} ticks (stream ticks "
          f"{lo}..{lo + T - 1})"
          f": wall {wall * 1e3:.3f} ms; host staging {host * 1e3:.3f} ms; "
          f"device busy {total:.3f} ms "
          + (f"({total / (wall * 1e3):.3f} of wall)" if total else
             "(not measured: no device events)"))
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"[profile] {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}")


# ------------------------------------------------------------- mesh phases
def mesh_inputs(gen, N, D, cap, W, live, hub):
    """Packed rows [N, W] f32 with NaN payloads, +-Inf and -0.0 planted,
    destinations over D ranks (hub: power-law, rank 0 the hub's owner),
    a live mask with `live` of the rows set; and route_plan's plan."""
    import torch
    from repro_torch.kernels.route_pack import ops
    dev = gen.device
    rows = torch.randn(N, W, generator=gen, device=dev)
    if N * W:
        bits = rows.view(torch.int32).reshape(-1)
        spots = torch.randint(0, N * W, (12,), generator=gen, device=dev)
        specials = torch.tensor([0x7FC00000, 0x7F800001, -4194304 + 0x1234,
                                 0x7F800000, -8388608, -2 ** 31],
                                dtype=torch.int32, device=dev)
        bits[spots] = specials.repeat(2)
    dst = (powerlaw_rows(gen, D, N) if hub else
           torch.randint(0, D, (N,), generator=gen, device=dev))
    ok = torch.rand(N, generator=gen, device=dev) < live
    return rows, ops.route_plan(dst, ok, D, cap)


def mesh_pack_check(rows, plan, D, cap):
    """route_pack's kernel against its plain version on one input, bit for
    bit (int32 views). Returns the number of shipped rows and the max
    |kernel - plain| over the entries finite in both."""
    import torch
    from repro_torch.kernels.route_pack import ops, ref
    order, ship_s, slot_s, _, starts = plan
    got = ops.route_pack(rows, order, slot_s, starts, D, cap)
    want = ref.route_pack_ref(rows[order], slot_s, D * cap)
    sync(got)
    check(got.shape == want.shape, f"route_pack gave {tuple(got.shape)}, "
                                   f"its plain version {tuple(want.shape)}")
    n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want).abs()[fin].max()) if bool(fin.any()) else 0.0
    check(n_diff == 0,
          f"route_pack differs from its plain version in {n_diff} 32-bit "
          f"words, max abs err {err} over finite entries (N={rows.shape[0]}, "
          f"W={rows.shape[1]}, D={D}, cap={cap})")
    return int(ship_s.sum()), err


def phase_mesh_kernel(device, full=FULL, m=MESH):
    """The route_pack kernel against its plain version, bit for bit: edge
    cases, integer columns through the wire, the full-width layer-0 RMI
    lane. Returns the max |kernel - plain| over every check's entries
    that are finite in both."""
    import torch
    from repro_torch.core.events import MsgBatch
    from repro_torch.dist import wire
    from repro_torch.kernels.route_pack import ops
    gen = torch.Generator(device=device).manual_seed(SEED)
    n_checks, worst = 0, 0.0
    cases = [  # N, D, cap, W, live, hub
        (0, 4, 3, 5, 1.0, False),          # nothing to send
        (300, 4, 5, 69, 0.0, True),        # every row dropped
        (400, 4, 8, 69, 1.0, False),       # every bucket overflows
        (77, 2, 1, 5, 0.9, True),          # cap = 1
        (64, 4, 64, 12, 1.0, False)]       # dense: cap = N, all live
    cases += [(1000, D, 64, W, 0.7, True) for D in (2, 4)
              for W in (1, 5, 69, 607)]
    for N, D, cap, W, live, hub in cases:
        rows, plan = mesh_inputs(gen, N, D, cap, W, live, hub)
        worst = max(worst, mesh_pack_check(rows, plan, D, cap)[1])
        n_checks += 1
    # integer columns (parts, slots below 2**24) survive the kernel exactly
    C, d = 5000, 16
    ri = lambda hi: torch.randint(0, hi, (C,), generator=gen, device=device)
    b = MsgBatch(part=ri(2 ** 24), slot=ri(2 ** 24),
                 vec=torch.randn(C, d, generator=gen, device=device),
                 cnt=torch.randn(C, generator=gen, device=device),
                 src_part=ri(2 ** 24), valid=ri(2) > 0)
    D, cap = 4, 700
    order, ship_s, slot_s, _, starts = ops.route_plan(b.part % D, b.valid, D,
                                                      cap)
    buf = wire.pack_lane(b)
    worst = max(worst, mesh_pack_check(
        buf, (order, ship_s, slot_s, None, starts), D, cap)[1])
    sent = wire.unpack_lane(ops.route_pack(buf, order, slot_s, starts, D,
                                           cap), b)
    moved = order[ship_s]
    at = slot_s[ship_s]
    for name in ("part", "slot", "vec", "cnt", "src_part", "valid"):
        check(torch.equal(getattr(sent, name)[at], getattr(b, name)[moved]),
              f"wire field {name} changed through route_pack")
    n_checks += 1
    # the full-width layer-0 RMI lane: its ring rows, then its capacity
    c = full["caps"]
    D = m["ranks"]
    C = c["edge_tick_cap"] + c["n_parts"] // D * c["edge_cap"]
    N, W = m["route_defer_cap"] + C, full["dims"][0] + 5
    rows, plan = mesh_inputs(gen, N, D, m["route_cap"], W, m["live"], True)
    n_ship, err = mesh_pack_check(rows, plan, D, m["route_cap"])
    worst = max(worst, err)
    n_checks += 1
    print(f"[mesh-kernel] route_pack vs plain: bit-exact (int32 views) in "
          f"{n_checks} checks: N = 0, all rows dropped, every bucket "
          f"overflowing, cap = 1, dense, D in (2, 4) x W in (1, 5, 69, 607), "
          f"NaN/Inf/-0.0 planted, hub-skewed destinations, integer columns "
          f"< 2**24 through the wire, and the layer-0 RMI lane at full width "
          f"(N={N}, W={W}, D={D}, cap={m['route_cap']}, {n_ship} rows "
          f"shipped); max |kernel - plain| over finite entries {worst}")
    del rows, plan
    free_cuda()
    return worst


def _tick_recorder(record):
    """A D3Pipeline.run_super_tick that also records each call's integer
    TickStats (per layer: the scalar fields, then the busy vector)."""
    from repro_torch.core.pipeline import D3Pipeline
    from repro_torch.core.tick import SCALAR_FIELDS
    run = D3Pipeline.run_super_tick

    def run_super_tick(self, *a, **k):
        stats, quiet = run(self, *a, **k)
        record.append([[int(getattr(s, f)) for f in SCALAR_FIELDS]
                       + s.busy.tolist() for s in stats])
        return stats, quiet
    return run_super_tick


def _mesh_parity_rank(mesh, m):
    """One rank of [mesh-parity]: the serve CLI's stream at each route_cap
    on this rank's card and on the CPU, over the same gloo group."""
    import dataclasses
    import torch
    from repro_torch.core.pipeline import D3Pipeline
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for cap in m["parity_caps"]:
        for dev in (mesh.device, torch.device("cpu")):
            view = dataclasses.replace(mesh, device=dev, calls={})
            record = []
            args = serve.parse_args(["--edges", str(m["parity_edges"])])
            with mock.patch.object(D3Pipeline, "run_super_tick",
                                   _tick_recorder(record)):
                pipe = serve.serve_stream(args, view, route_cap=cap)
            st = lambda name: [getattr(ls, name).cpu().numpy()
                               for ls in pipe.states]
            out[cap, dev.type] = {
                "stats": record,
                "metrics": {k: v for k, v in vars(pipe.metrics).items()
                            if isinstance(v, int)},
                "busy": pipe.metrics.busy_logical.tolist(),
                "agg_cnt": st("agg_cnt"), "agg": st("agg"), "feat": st("feat"),
                "sink": pipe.sink.cpu().numpy(),
                "seen": pipe.sink_seen.cpu().numpy()}
    return out


def phase_mesh_parity(device, m=MESH):
    """4 gloo ranks sharing the card, the serve CLI's --edges 1500 stream
    (dims 16,64,64) at two route_caps: the card run equals the CPU run
    exactly on every integer stat and within MESH_TOL on float state."""
    from repro_torch.launch.mesh import spawn_stream_mesh
    free_cuda()
    t0 = time.perf_counter()
    ranks = spawn_stream_mesh(m["ranks"], _mesh_parity_rank, backend="gloo",
                              device=device, args=(m,), timeout=m["timeout"])
    secs = time.perf_counter() - t0
    worst = 0.0
    for cap in m["parity_caps"]:
        for r, res in enumerate(ranks):
            a, b = res[cap, device.type], res[cap, "cpu"]
            for key in ("stats", "metrics", "busy"):
                check(a[key] == b[key], f"[mesh-parity] cap {cap} rank {r}: "
                                        f"{key} differ, card vs CPU")
            check(a["metrics"]["route_dropped"] == 0,
                  f"[mesh-parity] cap {cap}: rows dropped")
            check(all(np.array_equal(x, y) for x, y in zip(
                a["agg_cnt"], b["agg_cnt"])) and np.array_equal(
                a["seen"], b["seen"]), f"[mesh-parity] cap {cap} rank {r}: "
                                       "counts or sink flags differ")
            for key in ("agg", "feat", "sink"):
                for x, y in zip(*((a[key], b[key]) if key != "sink" else
                                  ([a[key]], [b[key]]))):
                    err = np.abs(x - y)
                    check(bool((err <= MESH_TOL * (1 + np.abs(y))).all()),
                          f"[mesh-parity] cap {cap} rank {r}: {key} max err "
                          f"{float(err.max())}")
                    worst = max(worst, float(err.max()) if err.size else 0.0)
        mt = ranks[0][cap, device.type]["metrics"]
        print(f"[mesh-parity] route_cap {cap}: card = CPU on "
              f"{len(ranks[0][cap, 'cpu']['stats'])} super-ticks of integer "
              f"TickStats, busy and metrics (ticks {mt['ticks']}, RMIs "
              f"{mt['reduce_msgs']}, cross-part {mt['cross_part_msgs']}, "
              f"wire_rows {mt['wire_rows']}, wire_bytes {mt['wire_bytes']}, "
              f"route_deferred {mt['route_deferred']}, route_dropped "
              f"{mt['route_dropped']})")
    print(f"[mesh-parity] {m['ranks']} gloo ranks: float state (agg, feat, "
          f"sink) card vs CPU max err {worst:.3e} (tolerance {MESH_TOL} x "
          f"(1 + |cpu|)); {secs:.1f}s with the ranks' start")


def _mesh_full_rank(mesh, full, m):
    """One rank of [mesh-full]: the full-width stream, super-tick driver,
    kernel backend, capped exchange. Returns the rank's measurements."""
    import torch
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.kernels.route_pack import ops as rp
    from repro_torch.kernels.segment_reduce import ops as sr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    edges, feats = make_stream(full["n_nodes"], m["n_edges"],
                               full["dims"][0])
    cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                         delivery_backend="kernel",
                         route_cap=m["route_cap"],
                         route_defer_cap=m["route_defer_cap"],
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4))
    pipe = D3Pipeline(GraphSAGE(full["dims"], seed=SEED), cfg, mesh=mesh)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rp.reset_launches()
    sr.reset_launches()
    mesh.reset_calls()
    t0 = time.perf_counter()
    pipe.run_stream_super(edges, feats, tick_edges=full["tick_edges"],
                          super_ticks=full["super_ticks"])
    pipe.flush_super(max_ticks=256, T=full["super_ticks"])
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**rp.LAUNCHES, **sr.LAUNCHES}
    calls = {k: list(v) for k, v in mesh.calls.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    emb = pipe.embeddings()
    return {"secs": secs, "launches": launches, "calls": calls,
            "peak": peak, "host_seconds": pipe.metrics.host_seconds,
            "metrics": {k: v for k, v in vars(pipe.metrics).items()
                        if isinstance(v, int)},
            "emb": emb if mesh.rank == 0 else None,
            "agg_cnt": [ls.agg_cnt.cpu().numpy() for ls in pipe.states]}


def phase_mesh_full(device, full=FULL, m=MESH):
    """d3gnn-sage at full width on 4 gloo ranks sharing the card; against
    the float64 oracle and a single-rank LocalRouter run of the stream.
    Returns the route_pack launches summed over the ranks."""
    import torch
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.launch.mesh import spawn_stream_mesh
    free_cuda()
    t0 = time.perf_counter()
    ranks = spawn_stream_mesh(m["ranks"], _mesh_full_rank, backend="gloo",
                              device=device, args=(full, m),
                              timeout=m["timeout"])
    spawn_secs = time.perf_counter() - t0
    mt = ranks[0]["metrics"]
    T, L = full["super_ticks"], len(full["dims"]) - 1
    n_super = mt["ticks"] // T
    print(f"[mesh-full] {m['ranks']} gloo ranks on one card, dims "
          f"{full['dims']}, caps {full['caps']} ({full['caps']['n_parts'] // m['ranks']} "
          f"parts a rank), route_cap {m['route_cap']}, route_defer_cap "
          f"{m['route_defer_cap']}, window session(4), driver super(T={T}), "
          f"{m['n_edges']} edges; {spawn_secs:.1f}s with the ranks' start")
    print(f"[mesh-full] ticks {mt['ticks']}; RMIs {mt['reduce_msgs']}; "
          f"cross-part msgs {mt['cross_part_msgs']}; wire_rows "
          f"{mt['wire_rows']}; wire_bytes {mt['wire_bytes']}; route_deferred "
          f"{mt['route_deferred']}; route_dropped {mt['route_dropped']}")
    for r, res in enumerate(ranks):
        check(res["metrics"] == mt, f"rank {r}'s metrics differ from rank 0's")
        n_calls = sum(c[0] for c in res["calls"].values())
        a2a = res["calls"].get("all_to_all", [0, 0.0, 0])
        print(f"[mesh-full] rank {r}: {res['secs']:.3f}s = "
              f"{m['n_edges'] / res['secs']:.1f} edges/s; host staging "
              f"{res['host_seconds']:.3f}s; blocked in all_to_all "
              f"{a2a[1]:.3f}s ({a2a[1] / res['secs']:.3f} of wall) over "
              f"{a2a[0]} calls, {a2a[2]} bytes sent; collectives "
              f"{ {k: c[0] for k, c in res['calls'].items()} } = "
              f"{n_calls / max(n_super, 1):.1f} per super-tick, each a host "
              f"sync under gloo, plus 1 stats read a super-tick; launches "
              f"{res['launches']}; peak memory {res['peak']} bytes "
              f"({res['peak'] / 2**30:.2f} GiB)")
        if device.type == "cuda":
            check(res["launches"]["route_pack"] == 2 * L * mt["ticks"],
                  f"rank {r} launched route_pack {res['launches']} times, "
                  f"expected {2 * L} a tick x {mt['ticks']} ticks")
            check(all(v > 0 for v in res["launches"].values()),
                  f"rank {r}: a kernel never launched: {res['launches']}")
    check(mt["route_dropped"] == 0, f"{mt['route_dropped']} rows dropped: "
                                    "the defer rings are too small")
    emb = ranks[0]["emb"]
    check(len(emb) > 0 and all(
        np.isfinite(v).all() and v.shape == (full["dims"][-1],)
        for v in emb.values()), "non-finite, misshapen or no embeddings")

    # the same stream on one rank (LocalRouter), and the float64 oracle
    one = dict(full, n_edges=m["n_edges"])
    edges, feats = make_stream(full["n_nodes"], m["n_edges"],
                               full["dims"][0])
    single, s_secs, _ = stream_pipeline(one, "kernel", device, edges, feats)
    for li, ls in enumerate(single.states):
        check(np.array_equal(np.concatenate([r["agg_cnt"][li]
                                             for r in ranks]),
                             ls.agg_cnt.cpu().numpy()),
              f"layer {li}: aggregator counts differ from the single rank")
    emb1 = single.embeddings()
    check(set(emb1) == set(emb), "materialized sets differ from the single "
                                 "rank's")
    model64 = GraphSAGE(full["dims"], seed=SEED).to(device).double()
    g, _ = build_snapshot(edges, feats, full["dims"][0], full["n_nodes"],
                          device, dtype=torch.float64)
    ref = oracle_embeddings(model64, g).cpu()
    del model64, g, single
    errs = {"mesh vs oracle": sink_error(emb, lambda vids: ref[vids]),
            "single rank vs oracle": sink_error(emb1, lambda vids: ref[vids]),
            "mesh vs single rank": sink_error(emb, lambda vids: torch.as_tensor(
                np.stack([emb1[v] for v in vids]), dtype=torch.float64))}
    for what, (err, vid) in errs.items():
        print(f"[mesh-full] sink {what}: max |diff|/max(1,|ref|) {err:.3e} "
              f"at vid {vid}; tolerance {SINK_TOL}")
        check(err <= SINK_TOL, f"sink {what}: {err:.3e} > {SINK_TOL}")
    print(f"[mesh-full] the single-rank run of the same stream: {s_secs:.3f}s"
          f" = {m['n_edges'] / s_secs:.1f} edges/s; aggregator counts equal "
          f"to the mesh's; materialized {len(emb)}")
    free_cuda()
    return sum(r["launches"]["route_pack"] for r in ranks)


def phase_mesh_time(device, launches, max_err, full=FULL, m=MESH):
    """route_pack at [mesh-full]'s layer-0 RMI shape and at the dense shape
    (route_cap None: cap = C, every row live), beside its bound, its plain
    version and the library yardstick: index_copy_ of pre-gathered rows
    into a zeroed buffer (two calls, not one; the gather is not timed).
    max_err: [mesh-kernel]'s max |kernel - plain|; the checks at these two
    shapes fold into it."""
    import torch
    from repro_torch.kernels.route_pack import ops, ref
    c = full["caps"]
    D, W = m["ranks"], full["dims"][0] + 5
    C = c["edge_tick_cap"] + c["n_parts"] // D * c["edge_cap"]
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    shapes = {"capped": (m["route_defer_cap"] + C, m["route_cap"],
                         m["live"], True),
              "dense": (C, C, 1.0, False)}
    out = {}
    for name, (N, cap, live, hub) in shapes.items():
        rows, plan = mesh_inputs(gen, N, D, cap, W, live, hub)
        order, ship_s, slot_s, _, starts = plan
        n_ship, err = mesh_pack_check(rows, plan, D, cap)
        max_err = max(max_err, err)
        rows_s = rows[order]
        ms = time_ms(lambda: ops.route_pack(rows, order, slot_s, starts, D,
                                            cap))
        plain = time_ms(lambda: ref.route_pack_ref(rows[order], slot_s,
                                                   D * cap))
        lib = time_ms(lambda: torch.zeros(D * cap + 1, W, device=device)
                      .index_copy_(0, slot_s, rows_s))
        # shipped rows read once with their order entries, starts read,
        # the send buffer written once; no arithmetic
        n_bytes = n_ship * W * 4 + n_ship * 8 + (D + 1) * 8 + D * cap * W * 4
        bound = bound_ms(n_bytes, 0)
        out[name] = (ms, plain, bound, lib)
        print(f"[mesh-time] route_pack {name}: N={N} W={W} D={D} cap={cap} "
              f"shipped {n_ship}: {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} "
              f"GB/s); bound {bound:.4f} ms by bytes ({n_bytes} bytes); plain "
              f"{plain:.4f} ms; zeros + index_copy_ of pre-gathered rows "
              f"{lib:.4f} ms")
        del rows, plan, rows_s, order, ship_s, slot_s, starts
        free_cuda()
    ms, plain, bound, lib = out["capped"]
    return {"name": "route_pack", "route": "cuda",
            "source": "src/repro_torch/csrc/route_pack.cu",
            "replaces": "src/repro/kernels/route_pack/ops.py:70",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib}


# ------------------------------------------------------------- LM phases
def free_cuda():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def attention_f64(q, k, v, causal, rows=None, drop_keys=None, q_chunk=256):
    """Softmax attention in float64 throughout, by kernel.py's mask
    convention: [B,S,H,D] q, [B,T,Kh,D] k/v -> [B,S,H,D] float64. `rows`
    (a slice of S) computes those query rows only; keys in `drop_keys` (a
    slice of T) are masked out, to plant a fault."""
    import torch
    rows = rows or slice(0, q.shape[1])
    B, _, H, D = q.shape
    T, Kh = k.shape[1], k.shape[2]
    kd, vd = k.double(), v.double()
    k_pos = torch.arange(T, device=q.device)
    keep = torch.ones(T, dtype=torch.bool, device=q.device)
    if drop_keys is not None:
        keep[drop_keys] = False
    outs = []
    for s0 in range(rows.start, rows.stop, q_chunk):
        c = min(q_chunk, rows.stop - s0)
        qc = q[:, s0:s0 + c].double().reshape(B, c, Kh, H // Kh, D)
        s = torch.einsum("bqkgd,btkd->bkgqt", qc, kd) / D ** 0.5
        vis = keep[None, :].expand(c, T)
        if causal:
            q_pos = s0 + torch.arange(c, device=q.device)
            vis = vis & (k_pos[None, :] <= q_pos[:, None])
        p = torch.softmax(s.masked_fill(~vis, float("-inf")), dim=-1)
        outs.append(torch.einsum("bkgqt,btkd->bkgqd", p, vd).permute(
            0, 3, 1, 2, 4).reshape(B, c, H, D))
    return torch.cat(outs, dim=1)


def fa_excess(got, plain, hi):
    """Per (batch, block of FA_ROWS queries, head): ||got - hi|| over
    FA_RATIO ||plain - hi|| + FA_FLOOR ||hi||, norms over the block's rows
    and head dim. A right kernel reads <= 1 in every block."""
    import torch
    import torch.nn.functional as F
    name = "bf16" if got.dtype == torch.bfloat16 else "f32"
    B, S, H, D = hi.shape
    pad = (0, 0, 0, 0, 0, (-S) % FA_ROWS)
    norm = lambda t: F.pad(t, pad).reshape(B, -1, FA_ROWS, H, D).square() \
        .sum(dim=(2, 4)).sqrt()
    return norm(got.double() - hi) / (FA_RATIO[name] * norm(
        plain.double() - hi) + FA_FLOOR[name] * norm(hi))


def fa_check(fa, ref, q, k, v, causal):
    """The kernel against its plain version on one input. Returns the max
    abs err between the two, the per-block excess (fa_excess), and the
    kernel's, the plain version's and the float64 outputs."""
    got = fa.flash_attention(q, k, v, causal=causal)
    plain = ref.attention_ref(q, k, v, causal=causal)
    hi = attention_f64(q, k, v, causal)
    sync(got)
    excess = fa_excess(got, plain, hi)
    worst = tuple(int(i) for i in divmod(int(excess.argmax()),
                                         excess.shape[2]))
    check(bool((excess <= 1).all()),
          f"flash_attention disagrees ({got.dtype}, causal={causal}, q "
          f"{tuple(q.shape)}, k {tuple(k.shape)}): block (batch x query "
          f"block, head) {worst} reads {float(excess.max()):.3f} > 1")
    err = float((got.float() - plain.float()).abs().max())
    return err, float(excess.max()), (got, plain, hi)


def fa_planted_faults(q, k, v, got, plain, hi):
    """The check must reject two faults planted in the kernel's output at
    the prefill shape: every value scaled by 0.9, and head 0's last block
    of queries computed without kv tile 1 (keys 64-127, far below the
    diagonal). Returns the least excess each reads where it was planted."""
    S = q.shape[1]
    scaled = fa_excess((got.double() * 0.9).to(got.dtype), plain, hi)
    r0 = (S - 1) // FA_ROWS * FA_ROWS
    dropped = got.clone()
    dropped[:1, r0:, :1] = attention_f64(
        q[:1, :, :1], k[:1, :, :1], v[:1, :, :1], True, rows=slice(r0, S),
        drop_keys=slice(FA_ROWS, 2 * FA_ROWS)).to(got.dtype)
    tile = fa_excess(dropped, plain, hi)[0, -1, 0]
    reads = {"x0.9": float(scaled.min()), "tile 1 dropped": float(tile)}
    check(min(reads.values()) > 1, f"the flash check passes a planted "
                                   f"fault ({got.dtype}): {reads}")
    return reads


def make_qkv(gen, dtype, B, S, H, Kh, D, T=None):
    import torch
    T = S if T is None else T
    dev = gen.device
    return (torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype),
            torch.randn(B, T, Kh, D, generator=gen, device=dev).to(dtype),
            torch.randn(B, T, Kh, D, generator=gen, device=dev).to(dtype))


def profile_call(tag, what, fn, top=6):
    """Device time by kernel over one call of fn (torch.profiler), beside
    the call's wall time under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if "CUDA" in str(e.device_type) and dev_us(e) > 0
              and e.key != "Command Buffer Full"]
    busy = sum(dev_us(e) for e in events) / 1e3
    print(f"[{tag}] {what}: wall {wall:.3f} ms; device busy "
          f"{busy:.3f} ms ({busy / wall:.3f} of wall); "
          f"{sum(e.count for e in events)} device activities")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"[{tag}] {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}")


def phase_lm_kernel(device, lm=LM):
    """Returns the max abs error over every check."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa, ref
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = [  # B, S, H, Kh, D, T
        (2, 256, 8, 8, 64, 256),      # G = 1
        (2, 256, 8, 2, 64, 256),      # G = 4
        (1, 200, 8, 2, 128, 200),     # ragged S = T
        (1, 100, 4, 1, 32, 300),      # S < T, ragged
        (1, 300, 4, 4, 16, 100),      # S > T, ragged
    ] + [(1, 129, 4, 1, D, 129) for D in fa.HEAD_DIMS] + [
        (1, 127, 8, 2, 128, 127),     # ragged at the 128-row tile
        (1, 129, 8, 2, 128, 383),     # S < T
        (2, 383, 8, 8, 128, 129),     # S > T, B = 2
    ]
    errs = {"bf16": 0.0, "f32": 0.0}
    excess = {"bf16": 0.0, "f32": 0.0}
    planted = {}

    def run(name, q, k, v, causal):
        err, ex, outs = fa_check(fa, ref, q, k, v, causal)
        errs[name], excess[name] = max(errs[name], err), max(excess[name], ex)
        return outs

    fa.reset_launches()
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for B, S, H, Kh, D, T in cases:
            q, k, v = make_qkv(gen, dtype, B, S, H, Kh, D, T)
            for causal in (True, False):
                run(name, q, k, v, causal)
        # q, k, v as strided views of one fused [B, S, H + 2 Kh, D] tensor
        qkv = torch.randn(2, 190, 12, 64, generator=gen,
                          device=device).to(dtype)
        run(name, qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:], True)
        # one layer of the prefill, and the faults the check must reject
        q, k, v = make_qkv(gen, dtype, *lm["prefill_qkv"])
        planted[name] = fa_planted_faults(q, k, v, *run(name, q, k, v, True))
        del q, k, v, qkv
        free_cuda()
    # every bf16 case at D 64 or 128 (the strided one and the prefill
    # shape included) went to the wgmma kernel, every other one did not
    n_wgmma = 2 * sum(D in fa.WGMMA_HEAD_DIMS for *_, D, _ in cases) + 2
    if device.type == "cuda":
        check(fa.LAUNCHES["flash_attention_wgmma"] == n_wgmma,
              f"[lm-kernel] launches {fa.LAUNCHES}, expected {n_wgmma} of "
              f"the wgmma kernel")
    print(f"[lm-kernel] flash_attention vs plain passed (causal and not, "
          f"G in {{1, 4}}, ragged, D in {fa.HEAD_DIMS}, strided, q/k/v "
          f"{lm['prefill_qkv']}); launches {fa.LAUNCHES} (bf16 at D in "
          f"{fa.WGMMA_HEAD_DIMS}: the wgmma kernel); max abs err {errs}; "
          f"worst block "
          f"||kernel - f64|| / ({FA_RATIO} ||plain - f64|| + {FA_FLOOR} "
          f"||f64||) {excess} (limit 1); planted faults at the prefill "
          f"shape read {planted} (must be > 1)")
    return max(errs.values())


def phase_lm_parity(device, lm=LM):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    # f32 matmuls in full f32 on the card (TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = get_arch(lm["arch"])
    cpu = spec.build_reduced(device="cpu", seed=SEED)
    card = spec.build_reduced(device=device, seed=SEED + 1)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(SEED)

    def agree(got, want, what):
        err = (got.cpu() - want).abs()
        check(bool((err <= LM_PARITY_TOL * (1 + want.abs())).all()),
              f"reduced {what} logits, card vs CPU: max err "
              f"{float(err.max())}")
        return float(err.max())

    toks = torch.as_tensor(rng.integers(0, cpu.cfg.vocab, (2, 512)))
    fa.reset_launches()
    got = card.logits(toks.to(device))
    if device.type == "cuda":
        check(fa.LAUNCHES["flash_attention"] == cpu.cfg.n_layers,
              f"the reduced prefill launched {fa.LAUNCHES} kernels")
    want = cpu.logits(toks)
    err = agree(got, want, "prefill")
    B, n = 4, 8
    tok = torch.as_tensor(rng.integers(0, cpu.cfg.vocab, (B, 1)))
    c_cpu, c_card = cpu.init_cache(B, n + 8), card.init_cache(B, n + 8)
    t_cpu, t_card, derr = tok, tok.to(device), 0.0
    for _ in range(n):
        l_cpu, c_cpu = cpu.decode_step(c_cpu, t_cpu)
        l_card, c_card = card.decode_step(c_card, t_card)
        derr = max(derr, agree(l_card, l_cpu, "decode"))
        t_cpu = torch.argmax(l_cpu[:, -1:], dim=-1)
        t_card = torch.argmax(l_card[:, -1:], dim=-1)
        check(torch.equal(t_card.cpu(), t_cpu), "greedy tokens differ")
    print(f"[lm-parity] reduced f32 model, card vs CPU: prefill S=512 "
          f"logits max err {err:.3e} (max |logit| "
          f"{float(want.abs().max()):.3f}); {n} greedy decode steps x {B}: equal "
          f"tokens, logits max err {derr:.3e}; tolerance {LM_PARITY_TOL} x "
          f"(1 + |cpu|)")
    del card
    free_cuda()


def phase_lm_full(device, lm=LM):
    """Full width: kernel vs plain path, one prefill, the serve CLI.
    Returns the kernel launches counted over the prefill."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa, ref
    from repro_torch.launch import serve
    from repro_torch.nn import attention
    from repro_torch.nn.module import param_bytes, param_count
    cuda = device.type == "cuda"
    spec = get_arch(lm["arch"])
    S = spec.shapes[lm["shape"]].dims["seq"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = spec.build(device=device, seed=SEED)
    sync(model.lm_head)
    cfg = model.cfg
    print(f"[lm-full] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {param_count(model)} params, "
          f"{param_bytes(model)} bytes ({cfg.dtype}), drawn on the device in "
          f"{time.perf_counter() - t0:.2f}s")
    gen = torch.Generator(device=device).manual_seed(SEED)

    # the kernel path against the plain-attention path
    toks = torch.randint(0, cfg.vocab, (1, lm["check_s"]), generator=gen,
                         device=device)
    # and both against attention computed in f32 throughout (a yardstick
    # of bf16's own noise over the depth)
    f32_attention = lambda q, k, v, causal=True: ref.attention_ref(
        q.float(), k.float(), v.float(), causal).to(q.dtype)
    h_kernel = model.hidden_states(toks)
    with mock.patch.object(attention, "flash_attention", ref.attention_ref):
        h_plain = model.hidden_states(toks)
    with mock.patch.object(attention, "flash_attention", f32_attention):
        h_f32 = model.hidden_states(toks)
    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / b.float().norm())
    path_err = rel(h_kernel, h_plain)
    from_f32 = rel(h_kernel, h_f32), rel(h_plain, h_f32)
    same_next = bool(torch.equal((h_kernel[:, -1] @ model.lm_head).argmax(-1),
                                 (h_plain[:, -1] @ model.lm_head).argmax(-1)))
    print(f"[lm-full] S={lm['check_s']}: kernel path vs plain-attention "
          f"path: final hidden states ||diff||/||plain|| {path_err:.3e} "
          f"(tolerance {LM_PATH_TOL}); same next token: {same_next}; vs f32 "
          f"attention: kernel {from_f32[0]:.3e}, plain {from_f32[1]:.3e} "
          f"(kernel at most {LM_PATH_RATIO}x plain)")
    check(path_err <= LM_PATH_TOL, f"kernel path vs plain path: "
                                   f"{path_err:.3e}")
    check(from_f32[0] <= LM_PATH_RATIO * from_f32[1],
          f"kernel path {from_f32[0]:.3e} from f32 attention, plain path "
          f"{from_f32[1]:.3e}")
    del h_kernel, h_plain, h_f32

    # one prefill of the assigned shape at batch 1
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=device)
    prefill = spec.step(model, lm["shape"])
    sync(toks)
    fa.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(toks)
    sync(logits)
    secs = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    check(logits.shape == (1, cfg.vocab) and bool(logits.isfinite().all()),
          "prefill logits misshapen or not finite")
    if cuda:
        check(launches["flash_attention"] == cfg.n_layers
              and launches["flash_attention_wgmma"] == cfg.n_layers,
              f"the prefill launched the flash kernels {launches} times, "
              f"expected {cfg.n_layers}, all of the wgmma kernel")
    print(f"[lm-full] prefill S={S} batch 1: {secs:.3f}s = "
          f"{S / secs:.1f} tokens/s; launches {launches}; logits finite")
    if cuda:
        profile_call("lm-profile", f"one prefill S={S}",
                     lambda: prefill(toks))
    del model, prefill, logits, toks
    free_cuda()

    # the serve CLI: batch 4, greedy, from an empty cache
    n = lm["decode_tokens"]
    model, generated, secs = serve.main(
        ["--arch", lm["arch"], "--tokens", str(n), "--device", str(device)])
    check(generated.shape == (4, n) and int(generated.min()) >= 0
          and int(generated.max()) < cfg.vocab, "served tokens out of range")
    # the same decode again, warm
    cache = model.init_cache(4, n + 8)
    tok = generated[:, :1].to(device)
    sync(tok)
    t0 = time.perf_counter()
    for _ in range(n):
        lg, cache = model.decode_step(cache, tok)
        tok = torch.argmax(lg[:, -1:], dim=-1)
    sync(tok)
    warm = time.perf_counter() - t0
    if cuda:
        profile_call("lm-profile", "one warm decode step, batch 4",
                     lambda: model.decode_step(cache, tok))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"[lm-full] serve: {4 * n / secs:.1f} tokens/s over its {n} steps "
          f"(first step included); warm decode batch 4: {4 * n / warm:.1f} "
          f"tokens/s; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    del model, cache
    free_cuda()
    return launches


def phase_lm_time(device, launches, max_err, lm=LM):
    """The kernel at the prefill shape beside its bound, the mma.sync
    kernel it replaced, its plain version and the library's fused
    attention (the last two timed only, never on the path), in turns."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as fa, ref
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = make_qkv(gen, torch.bfloat16, *lm["prefill_qkv"])
    B, S, H, D = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    runs = {"wgmma": [], "mma.sync": [], "sdpa": []}
    for name in ("wgmma", "mma.sync", "sdpa", "sdpa", "mma.sync", "wgmma"):
        fn = {"wgmma": lambda: fa.flash_attention(q, k, v, causal=True),
              "mma.sync": lambda: fa._flash_attention_mma_sync(q, k, v, True),
              "sdpa": sdpa}[name]
        runs[name].append(time_ms(fn))
    ms, prev_ms, lib_ms = (sum(r) / len(r) for r in runs.values())
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=True))
    # causal: S (S + 1) / 2 visible (query, key) pairs per head, two
    # matmuls of 2 D FLOPs each; q, k, v read once, o written once
    flops = 4 * D * H * B * (S * (S + 1) // 2)
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_OPS_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes > t_ops else "operations"
    rate = lambda t: f"{flops / t / 1e9:.1f} TFLOP/s"
    print(f"[lm-time] flash_attention bf16 q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)} causal, in turns (wgmma, mma.sync, sdpa, sdpa, "
          f"mma.sync, wgmma): wgmma kernel {runs['wgmma']} ms, mean "
          f"{ms:.3f} ms ({rate(ms)}, {bound / ms:.3f} of the bound); "
          f"mma.sync kernel {runs['mma.sync']} ms, mean {prev_ms:.3f} ms "
          f"({rate(prev_ms)}); scaled_dot_product_attention (flash "
          f"backend) {runs['sdpa']} ms, mean {lib_ms:.3f} ms "
          f"({rate(lib_ms)}); plain {plain_ms:.3f} ms; bound {bound:.3f} "
          f"ms by {by} ({flops} FLOPs, {n_bytes} bytes)")
    check(ms < prev_ms, f"the wgmma kernel ({ms:.3f} ms) is no faster "
                        f"than the mma.sync kernel ({prev_ms:.3f} ms)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            "launches": launches["flash_attention_wgmma"],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "previous_ms": prev_ms}


# ------------------------------------------------------------- RS phases
def bags_f64(table, ids, mode):
    """(float64 bags, per element sum_i |w_i row_i|) with the plain
    version's semantics, from the gathered rows alone; bags holding an id
    past the table are left out (their rows count as 0)."""
    V = table.shape[0]
    rows = table[ids.clamp(0, V - 1)].double() \
        * ((ids >= 0) & (ids < V))[..., None]
    n = (ids >= 0).sum(dim=-1, keepdim=True).clamp(min=1).double() \
        if mode == "mean" else 1.0
    return rows.sum(dim=-2) / n, rows.abs().sum(dim=-2) / n


def eb_check(ops, ref, table, ids, mode):
    """The kernel against its plain version on one input: NaN in the same
    elements, elsewhere within EB_TOL. Returns (max abs err, kernel out)."""
    import torch
    got = ops.embedding_bag(table, ids, mode)
    want = ref.embedding_bag_ref(table, ids, mode)
    _, mag = bags_f64(table, ids, mode)
    sync(got)
    what = (f"mode {mode}, ids {tuple(ids.shape)} {ids.dtype}, d "
            f"{table.shape[1]}")
    nan = want.isnan()
    check(torch.equal(got.isnan(), nan), f"embedding_bag NaN elsewhere "
                                         f"than the plain version ({what})")
    err = (got - want).abs().masked_fill(nan, 0.0)
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= EB_TOL * (1 + mag)).all()),
          f"embedding_bag disagrees ({what}): max err {worst}")
    return worst, got


def phase_rs_kernel(device, rs=RS):
    """Returns the max abs error over every check."""
    import torch
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.launch.serve import random_bag_ids
    gen = torch.Generator(device=device).manual_seed(SEED)
    V, err, n_calls = 1000, 0.0, 0

    def run(table, ids, n_nan_bags):
        nonlocal err, n_calls
        for id_dtype in (torch.int32, torch.int64):
            for mode in ("sum", "mean"):
                e, got = eb_check(ops, ref, table, ids.to(id_dtype), mode)
                err, n_calls = max(err, e), n_calls + 1
                check(int(got.isnan().any(dim=1).sum()) == n_nan_bags
                      and bool(got[got.isnan().any(dim=1)].isnan().all()),
                      "embedding_bag: a NaN bag is not NaN throughout")

    for d in (16, 30, 32, 256):
        table = torch.randn(V, d, generator=gen, device=device)
        for W in (1, 2, 3, 8, 16):
            run(table, torch.zeros(0, W, dtype=torch.int64, device=device), 0)
            ids = torch.randint(-4, V, (100, W), generator=gen, device=device)
            ids[:5] = -1                      # all-padding bags
            ids[5] = -3
            ids[6, W - 1] = V                 # ids past the table: NaN bags
            ids[7, 0] = V + 12345
            run(table, ids, 2)
    # a table 4 bytes off 16-byte alignment: one float per lane
    flat = torch.randn(V * 32 + 1, generator=gen, device=device)
    run(flat[1:].view(V, 32), ids[:, :8].clamp(max=V - 1), 0)
    print(f"[rs-kernel] embedding_bag vs plain passed ({n_calls} calls: sum "
          f"and mean, W in (1, 2, 3, 8, 16), d in (16, 30, 32, 256), int32 "
          f"and int64 ids, B in (0, 100), all-padding bags, ids < -1, ids "
          f">= V as NaN bags, an unaligned table); max abs err {err:.3e}; "
          f"tolerance {EB_TOL} x (1 + sum |w row|)")
    del table, flat, ids

    # the full-width shape against float64 bags
    from repro_torch.configs.two_tower_retrieval import CONFIG
    d, W, V = CONFIG.embed_dim, CONFIG.max_ids_per_field, rs["time_rows"]
    table = torch.randn(V, d, generator=gen, device=device)
    ids = random_bag_ids(gen, (rs["check_bags"], W), V)
    e64 = 0.0
    for mode in ("sum", "mean"):
        e, got = eb_check(ops, ref, table, ids, mode)
        err = max(err, e)
        hi, mag = bags_f64(table, ids, mode)
        diff = (got.double() - hi).abs()
        check(bool((diff <= EB_TOL * (1 + mag)).all()),
              f"embedding_bag vs float64 bags ({mode}): max err "
              f"{float(diff.max())}")
        e64 = max(e64, float(diff.max()))
    print(f"[rs-kernel] full-width shape, {rs['check_bags']} bags of W={W} "
          f"over a [{V}, {d}] f32 table: vs float64 bags max err "
          f"{e64:.3e} (tolerance {EB_TOL} x (1 + sum |w row|))")
    del table, ids, got
    free_cuda()
    return err


def phase_rs_parity(device, rs=RS):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.launch.serve import random_bag_ids
    # f32 matmuls in full f32 on the card (TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = get_arch(rs["arch"])
    cpu = spec.build_reduced(device="cpu", seed=SEED)
    card = spec.build_reduced(device=device, seed=SEED + 1)
    card.load_state_dict(cpu.state_dict())
    c = cpu.cfg
    gen = torch.Generator().manual_seed(SEED)
    W = c.max_ids_per_field
    users = random_bag_ids(gen, (64, c.user_fields, W), c.user_vocab)
    items = random_bag_ids(gen, (64, c.item_fields, W), c.item_vocab)
    cands = random_bag_ids(gen, (2000, c.item_fields, W), c.item_vocab)
    cases = {"serve_p99": ({"user_ids": users}, 1),
             "serve_bulk": ({"user_ids": users, "item_ids": items}, 2),
             "retrieval_cand": ({"user_ids": users[:1], "cand_ids": cands},
                                2)}
    errs = {}
    for shape, (batch, towers) in cases.items():
        want = spec.step(cpu, shape)(batch)
        eb.reset_launches()
        got = spec.step(card, shape)({k: v.to(device)
                                      for k, v in batch.items()})
        sync(got)
        if device.type == "cuda":
            check(eb.LAUNCHES["embedding_bag"] == towers,
                  f"reduced {shape} launched {eb.LAUNCHES} kernels, "
                  f"expected {towers}")
        err = (got.cpu() - want).abs()
        check(bool((err <= RS_TOL * (1 + want.abs())).all()),
              f"reduced {shape}, card vs CPU: max err {float(err.max())}")
        errs[shape] = float(err.max())
    print(f"[rs-parity] reduced f32 two-tower, card vs CPU: max err "
          f"{errs}; one kernel launch per tower call; tolerance {RS_TOL} "
          f"x (1 + |cpu|)")
    del card
    free_cuda()


def phase_rs_full(device, rs=RS):
    """Full width: the serve CLI's serve_p99 requests, serve_bulk steps and
    retrieval_cand queries. Returns the kernel launches counted over the
    three (each checked exactly)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import ops as eb, ref as eb_ref
    from repro_torch.launch import serve
    from repro_torch.nn.module import param_bytes, param_count
    cuda = device.type == "cuda"
    spec = get_arch(rs["arch"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    eb.reset_launches()
    n = rs["requests"]
    model, ids0, u0, secs = serve.main(
        ["--arch", rs["arch"], "--requests", str(n), "--device",
         str(device)])
    launches = eb.LAUNCHES["embedding_bag"]
    c = model.cfg
    print(f"[rs-full] {c.name}: user table {tuple(model.user_emb.table.shape)}"
          f", item table {tuple(model.item_emb.table.shape)} "
          f"{model.user_emb.table.dtype}, embed_dim {c.embed_dim}, towers "
          f"{c.tower_mlp}, {c.user_fields}/{c.item_fields} fields of "
          f"{c.max_ids_per_field} ids; {param_count(model)} params, "
          f"{param_bytes(model)} bytes, drawn on the device")
    if cuda:
        check(launches == n, f"{n} serve_p99 requests launched the kernel "
                             f"{launches} times")
    B = ids0.shape[0]
    ms = np.asarray(secs) * 1e3
    print(f"[rs-full] serve_p99: {n} requests x {B} users: "
          f"{n * B / sum(secs):.1f} users/s; per request p50 "
          f"{np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} "
          f"ms, first {ms[0]:.3f} ms; launches {launches}")
    # the first request: unit norm (0 for a user with no id at all), and
    # equal to the same request through the plain lookup
    check(u0.shape == (B, c.tower_mlp[-1]) and bool(u0.isfinite().all()),
          "user vectors misshapen or not finite")
    empty = (ids0 < 0).all(dim=-1).all(dim=-1).cpu()
    norms = u0.norm(dim=-1)
    check(bool(((norms - 1).abs()[~empty] <= 1e-5).all())
          and bool((norms[empty] == 0).all()),
          f"user vectors not of unit norm: {float((norms - 1).abs().max())}")
    p99_step = spec.step(model, "serve_p99")
    with mock.patch.object(eb, "embedding_bag", eb_ref.embedding_bag_ref):
        plain = p99_step({"user_ids": ids0}).cpu()
    err = (u0 - plain).abs()
    check(bool((err <= RS_TOL * (1 + plain.abs())).all()),
          f"first request, kernel vs plain lookup: max err "
          f"{float(err.max())}")
    print(f"[rs-full] first request vs its plain-lookup path: max err "
          f"{float(err.max()):.3e} (tolerance {RS_TOL} x (1 + |plain|)); "
          f"unit norms within {float((norms - 1).abs()[~empty].max()):.3e} "
          f"({int(empty.sum())} users without ids)")
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    W = c.max_ids_per_field

    def mlp_flops(n_users, n_items):
        """f32 FLOPs of the towers' MLPs (2 per multiply-add)."""
        macs = lambda dims: sum(a * b for a, b in zip(dims, dims[1:]))
        d = c.embed_dim
        return 2 * (n_users * macs((d * c.user_fields, *c.tower_mlp))
                    + n_items * macs((d * c.item_fields, *c.tower_mlp)))

    def timed_steps(shape, n_steps, make_batch, towers, out_shape, what,
                    flops):
        """n_steps timed steps (launches counted), then one more under
        torch.profiler."""
        step = spec.step(model, shape)
        eb.reset_launches()
        times = []
        for _ in range(n_steps):
            batch = make_batch()
            sync(batch["user_ids"])
            t0 = time.perf_counter()
            out = step(batch)
            sync(out)
            times.append(time.perf_counter() - t0)
            check(out.shape == out_shape and bool(out.isfinite().all())
                  and float(out.abs().max()) <= (1 + 1e-5) / c.temperature,
                  f"{shape} scores misshapen, not finite or past "
                  f"1/temperature")
            del batch, out
        got = eb.LAUNCHES["embedding_bag"]
        if cuda:
            check(got == towers * n_steps, f"{n_steps} {shape} steps "
                                           f"launched the kernel {got} times")
        print(f"[rs-full] {shape}: {what(times)}; per step "
              + ", ".join(f"{t * 1e3:.3f} ms" for t in times)
              + f"; launches {got}; MLPs {flops} f32 FLOPs a step, "
              f"{flops / PEAK_F32_OPS_PER_S * 1e3:.3f} ms at the f32 peak")
        if cuda:
            batch = make_batch()
            profile_call("rs-profile", f"one {shape} step",
                         lambda: step(batch), top=8)
        return got

    bulk = rs["bulk"] or spec.input_specs(model, "serve_bulk")[
        "user_ids"][0][0]
    launches += timed_steps(
        "serve_bulk", rs["bulk_steps"], lambda: {
            "user_ids": serve.random_bag_ids(
                gen, (bulk, c.user_fields, W), c.user_vocab),
            "item_ids": serve.random_bag_ids(
                gen, (bulk, c.item_fields, W), c.item_vocab)},
        2, (bulk,), lambda ts: f"{bulk} pairs a step, "
                               f"{bulk * len(ts) / sum(ts):.1f} pairs/s",
        mlp_flops(bulk, bulk))
    cand = rs["cand"] or spec.input_specs(model, "retrieval_cand")[
        "cand_ids"][0][0]
    launches += timed_steps(
        "retrieval_cand", rs["queries"], lambda: {
            "user_ids": serve.random_bag_ids(
                gen, (1, c.user_fields, W), c.user_vocab),
            "cand_ids": serve.random_bag_ids(
                gen, (cand, c.item_fields, W), c.item_vocab)},
        2, (1, cand), lambda ts: f"1 query x {cand} candidates, "
                                 f"{sum(ts) / len(ts) * 1e3:.3f} ms per query",
        mlp_flops(1, cand))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"[rs-full] peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if cuda:
        profile_call("rs-profile", f"one serve_p99 request, {B} users",
                     lambda: p99_step({"user_ids": ids0}).cpu(), top=8)
    del model, ids0, u0, plain
    free_cuda()
    return {"embedding_bag": launches}


def phase_rs_time(device, launches, max_err, rs=RS):
    """The kernel at retrieval_cand's item side (2,000,896 bags of W = 8,
    d = 256, ~4 valid ids a bag, ids uniform over a fresh item-sized
    table) beside its bound, its plain version and F.embedding_bag (timed
    only, never on the path)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.two_tower_retrieval import CONFIG
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.launch.serve import random_bag_ids
    gen = torch.Generator(device=device).manual_seed(SEED)
    V, d = rs["time_rows"], CONFIG.embed_dim
    B, W = rs["time_bags"], CONFIG.max_ids_per_field
    table = torch.randn(V, d, generator=gen, device=device)
    ids = random_bag_ids(gen, (B, W), V)
    got = ops.embedding_bag(table, ids, "mean")
    want = ref.embedding_bag_ref(table, ids, "mean")
    mag = ref.embedding_bag_ref(table.abs(), ids, "mean")
    err = (got - want).abs()
    check(bool((err <= EB_TOL * (1 + mag)).all()),
          f"embedding_bag at the timing shape: max err {float(err.max())}")
    max_err = max(max_err, float(err.max()))
    del want, mag, err
    valid = ids >= 0
    n_valid = int(valid.sum())
    flat = ids[valid]
    offsets = torch.zeros(B, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)[:-1]
    lib = F.embedding_bag(flat, table, offsets, mode="mean")
    lib_err = float((lib - got).abs().max())
    del lib, got
    free_cuda()
    ms = time_ms(lambda: ops.embedding_bag(table, ids, "mean"))
    plain_ms = time_ms(lambda: ref.embedding_bag_ref(table, ids, "mean"))
    lib_ms = time_ms(lambda: F.embedding_bag(flat, table, offsets,
                                             mode="mean"))
    # each valid row read once, the ids once, the bags written once; an
    # add per element of a valid row and a division per output element
    n_bytes = n_valid * d * 4 + ids.numel() * ids.element_size() + B * d * 4
    n_ops = n_valid * d + B * d
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes > t_ops else "operations"
    print(f"[rs-time] embedding_bag mean, {B} bags of W={W} ({n_valid} "
          f"valid ids, {n_valid / B:.3f} a bag) over a [{V}, {d}] f32 "
          f"table: {ms:.3f} ms ({n_bytes / ms / 1e6:.1f} GB/s); bound "
          f"{bound:.3f} ms by {by} ({n_bytes} bytes); plain {plain_ms:.3f} "
          f"ms; F.embedding_bag {lib_ms:.3f} ms (its max diff from the "
          f"kernel {lib_err:.3e})")
    del table, ids, flat, offsets
    free_cuda()
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:43",
            "launches": launches["embedding_bag"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms}


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    card = card_line()
    print(f"[card] {card}")
    build_kernels()
    errs = phase_kernels_vs_plain(device)
    phase_parity_gate(device)
    pipe, launches = phase_full_width(FULL, device)
    result = phase_timing(pipe, launches, errs)
    del pipe
    phase_profile(FULL, device)
    free_cuda()
    mesh_err = phase_mesh_kernel(device)
    phase_mesh_parity(device)
    mesh_launches = phase_mesh_full(device)
    result["kernels"].append(phase_mesh_time(device, mesh_launches, mesh_err))
    free_cuda()
    fa_err = phase_lm_kernel(device)
    phase_lm_parity(device)
    lm_launches = phase_lm_full(device)
    result["kernels"].append(phase_lm_time(device, lm_launches, fa_err))
    free_cuda()
    eb_err = phase_rs_kernel(device)
    phase_rs_parity(device)
    rs_launches = phase_rs_full(device)
    result["kernels"].append(phase_rs_time(device, rs_launches, eb_err))
    print("[card] all times above on this card:")
    print(card)
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
