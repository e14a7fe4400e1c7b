#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and nvcc.
Phases (any failure exits non-zero; no phase is caught):

  1. the card's name and power limit (nvidia-smi); build of every kernel
     in src/repro_torch/csrc/ with nvcc for sm_90a (seconds, ptxas report);
  2. each kernel against its plain PyTorch version on the card: edge cases
     (last-writer-wins, all-padding, sentinel rows, hub runs over many
     shares, one and no output rows, cnt <= 0) and the main path's shapes;
     kernel A in every form (add and set, with and without the base,
     gathered and contiguous, and the contiguous form on the packed
     payload), and the "kernel" delivery backend against the "scatter"
     one;
  3. parity gate: the port's serve CLI at --edges 1500, dims (16,64,64),
     must print the JAX package's pinned counts (tick 3032/2491, super
     3049/2507) with equal materialized counts;
  4. full width: GraphSAGE (602, 64, 64), the paper model's published
     widths, streams ~400K power-law edges through the super-tick driver
     on the "kernel" backend; both kernels must have launched during the
     run; the sink is checked against the float64 static oracle and
     against the same stream through the "scatter" backend;
  5. each kernel timed at main-path shapes beside its plain version, the
     library call computing the same function and its memory bound (kernel
     A: the fused add delivery at the layer-0 RMI lane, its set form, and
     the contiguous form on the packed payload, the yardstick of PRs
     11-15; the delivery plane's add call, sort included, on both
     backends and on the packed path; kernel B at both layers' picks, d =
     602 and d = 64); for the small kernels, whether the timing window
     holds device time only (the wrapper's host time against the flush
     write before it, the kernel's duration under torch.profiler beside
     the window's); one JSON `kernels` line;
  6. device time by operator over one steady-state full-width super-tick
     (torch.profiler), beside its wall and host staging time, and the
     same device time by the call site that launched it.

Between phases 5 and 6, [gate-full]: phase 4's stream at delta_eps = eps
(eps the median layer-0 ||dx|| of the first wave) beside phase 4's own
pipeline (delta_eps = 0), then the same 3 waves of feature updates on
8,192 ingested vertices through both: suppressed > 0, the waves' gated
RMIs + suppressed <= the exact run's, the eps = 0 run suppresses
nothing, the gated sink within the Lipschitz chain bound (spectral norms
in float64) of the float64 oracle, the coalescer launching kernel A; each
wave's wall time, the messages saved.

Then the query plane (serve/query.py, ServeSession):

  [query-parity] tests/test_query_plane.py's golden query mix at its sizes
     (32 nodes, dims (8, 12, 12), 4 parts), both drivers x the "kernel"
     and "scatter" backends, card against CPU: qid, kind, ok, tick and
     issue exactly equal, vec and score within QUERY_TOL x (1 + |cpu|);
  [query-full] phase 4's configuration with query_cap 32 and 256
     admissions a tick through ServeSession(driver="super") over the same
     400,000-edge stream: 2,048 stale_ok queries a launch (7/8 EMBED, 1/8
     LINK over ingested vids), 256 consistent ones (128 EMBED, 128 LINK)
     submitted with the last stream launch, then the flush. Nothing
     dropped or left outstanding; each launch's last-tick stale_ok EMBED
     answers bit-equal read_nodes after it; consistent answers within
     SINK_TOL of the float64 oracle; the same synchronizing call sites and
     counts a super-tick as phase 4; answered/s, enqueue->answer ms and
     staleness by mode, edges/s beside phase 4's, peak memory, and the
     query stages' device ms by call site over one profiled launch.

Then delta gating and the training plane:

  [gate-parity] tests/test_delta_gating.py's update-wave stream at
     delta_eps 1e-3, both drivers x both backends, card against CPU:
     every integer stat of every call equal, the sink within PARITY_TOL;
  [train-parity] tests/test_train_plane.py's online-learning stream
     through TrainSession, both drivers x both backends (and the int8
     compressed path), card against CPU: steps and fire ticks equal,
     losses and last_grad within PARITY_TOL (TRAIN_LOSS_TOL compressed);
     kernel A launched by the backward's edge fold, replica fold and
     zeroing;
  [train-full] (a) FULL with a 41-class head, lr 0: stream, flush, one
     tick of 4,096 labels fires exactly once; last_grad and the loss
     within TRAIN_TOL relative L2 of float64 torch.autograd through the
     static model, the live parameters bit-unchanged; (b) online learning
     through TrainSession(driver="super"), Adam, int8 top-k compression,
     labels streaming with the edges: the loss falls, the scatter backend
     fires at the same ticks with losses within TRAIN_LOSS_TOL, the same
     synchronizing calls a super-tick as phase 4; edges/s beside phase
     4's, peak memory, kernel A's launches by call site, and the train
     stage's device ms by call site over one profiled launch;
  [train-time] kernel A at its new call sites on (a)'s final topology:
     the backward's edge fold (d = 602 and 64), its replica fold and the
     coalescer's layer-0 RMI lane, beside the plain version, zeros (or
     the base) + index_add_ and the bound (rows 1b and 1c of PERF.md).

Then the telemetry plane and consistent-cut checkpoints:

  [telemetry-parity] the golden small stream (32 nodes, dims (8, 12, 12),
     query mix aboard) with telemetry on, both drivers, card against CPU:
     every stat of every call and every integer trace column exactly
     equal; on the card every stat but the four gauges, the sink and the
     state bit-equal to the run without telemetry; the advisor's caps
     card = CPU, and their replay on the card drops nothing and gives the
     same sink;
  [telemetry-full] phase 4's stream with telemetry on: edges/s beside
     phase 4's, the synchronizing calls a super-tick (must be phase 4's:
     the occupancy rows ride the one stats read), the trace's rows, the
     advisor's caps against FULL's, the cost model's fit (hit_frac,
     mae_frac), the saved .npz's bytes, and one profiled super-tick's
     device busy with and without telemetry;
  [ckpt-parity] the golden small stream on the card cut mid-stream
     (pending windows, held consistent queries), saved with both
     async_write settings, restored into fresh pipelines: the continuation
     bit-equal to the uninterrupted run on every stat, answer and float of
     the sink and the state; the card's checkpoint continued on the CPU;
     the torn-checkpoint drill (ft/chaos.py) on the card;
  [ckpt-full] phase 4's configuration with the query plane on, cut after
     48 ticks with 64 consistent queries held: state and blob bytes, save
     seconds (synchronous; asynchronous: the stall for the snapshot and the
     write's end), restore seconds, peak host and device memory; the
     restored pipeline finishes the stream bit-equal to the uninterrupted
     run.

Then the sharded 1-D mesh path, four gloo ranks that share the card (one
process each, started after the parent frees its memory; every kernel is
built before any rank starts):

  [mesh-kernel] the route_pack kernel's two entries against their plain
     versions, bit for bit (int32 views). The placement alone: N = 0,
     every row dropped, every bucket overflowing, cap = 1, D in {2, 4} x
     W in {1, 5, 69, 607}, NaN / Inf / -0.0 rows, hub-skewed
     destinations, integer columns through the packed wire, and the
     full-width layer-0 RMI lane (W = 607, 299,008 rows: a 32,768-row
     ring and 266,240 fresh). The fused lane step (route_lane: ring rows,
     then the lane's fields read in place; send buffer and new ring)
     against route_lane_ref: ring only, no ring, every bucket overflowing
     past the ring, cap = 1, dense, W in {1, 5, 69, 607} and a FeatBatch
     x D in {2, 4}, the same full-width lane as a MsgBatch, and the query
     plane's QueryBatch wire lane (11 fields, W = 74, a full-width rank's
     16 x 32 = 512 rows; ring, capped and dense);
  [mesh-parity] the serve CLI's --edges 1500 stream (dims 16,64,64) at
     route_cap 2176 (C // D) and 16, each on the card and on the CPU over
     the same gloo group: integer TickStats of every super-tick, busy and
     metrics (wire counters included) exactly equal, float state within
     MESH_TOL; then the same stream with the query plane on (query_cap 16,
     route_cap 16: the wire lane defers) and the golden query mix plus a
     burst of links onto the hub: answers and every counter card = CPU,
     route_lane launched 2 L + 1 times a tick, collectives a super-tick;
     a gated case (route_cap 16, two update waves) card = CPU with the
     coalescer on kernel A; an lr 0 training case whose quiescent grads
     equal the CPU ranks' and a one-rank run's within MESH_TOL, with
     route_lane launched 4 L times a tick (hops A and B a layer); a
     telemetry case (the golden small stream at route_cap 2): every stat
     and trace column card = CPU on every rank, the straggler feed fed
     once a launch, telemetry changing no other stat nor the sink;
  [mesh-full] GraphSAGE (602, 64, 64) with FULL's caps (16 parts a rank),
     route_cap 4096, route_defer_cap 32,768, 100,000 power-law edges,
     super-tick driver: no row dropped, route_lane launched 4 times a tick
     on every rank (and the placement alone never), the sink within
     SINK_TOL of the float64 oracle and of a single-rank run whose
     aggregator counts it equals; edges/s, wire counters, collectives
     (host syncs) per super-tick, time blocked in all_to_all and peak
     memory per rank; the exchange rate (rank 0's all_to_all bytes over
     the seconds blocked in it); then rank 0's device time inside
     route_lanes by
     call site over one steady super-tick of a second run
     (torch.profiler);
  [mesh-time] route_pack at [mesh-full]'s layer-0 RMI shape and at the
     dense shape beside its bound, its plain version and zeros +
     index_copy_ of pre-gathered rows (timed only, as a yardstick); the
     fused lane step at the full-width layer-0 RMI lane beside its bound,
     its plain chain and the parent's card chain (pack_lane + cat + the
     route_pack kernel + the ring gather), with the bytes of each; and
     the fused lane step at the QueryBatch wire lane (512 rows, W = 74).

Then the 2-D ("stage", "data") pipeline and the live reshard, on four
gloo ranks that share the card:

  [stage-parity] tests/test_pipeline_stage.py's golden small stream (32
     nodes, dims (8, 8, 8), 4 parts) on a stage 2 x data 1 grid (ranks 0
     and 1) and a 2 x 2 grid, both drivers, plus the query plane and an
     lr 0 training case at 2 x 2, each on the card and on the CPU over
     the same groups: every integer stat of every call, the stage_idle
     counters, the rows in flight after the stream (and none after the
     flush) and the answers exactly equal; the sink within SINK_TOL of
     the float64 oracle; the training case's grads card = CPU = a
     one-rank run within MESH_TOL; kernels 1-3 launched on every rank;
  [stage-full] GraphSAGE (602, 602, 602) (the staged program needs
     in_dim == out_dim, so the published input width is kept at every
     layer) at FULL's caps, route_cap 4096, 100,000 power-law edges, at
     stage 2 x data 2 and stage 1 x data 4: edges/s a rank, the bubble
     fraction, host seconds blocked in each collective kind, collectives
     a super-tick, peak memory a rank, and both sinks within SINK_TOL of
     the float64 oracle;
  [reshard-full] [mesh-full]'s configuration and stream: a live 4 -> 2
     reshard mid-stream (its seconds, the bytes each rank sent into the
     relay, edges/s on the 2 survivors after it), and a fail-stop drill
     (a consistent-cut checkpoint with 16 held consistent queries, data
     shards 1 and 3 lost, restore, reshard onto ranks 0 and 2, replay):
     nothing dropped, both sinks within SINK_TOL of [mesh-full]'s
     uninterrupted run, the held queries answered; then
     tests/test_chaos.py's small reshard goldens (4 -> 2, 2 -> 4, to a
     local pipeline, onto survivors, capped, 2 x 2 -> 2 x 1) card = CPU,
     the uncapped 1-D ones bit-equal to the local run;
  [decode-partial] mistral-nemo-12b's decode head layout (32 query heads
     over 8 KV heads, D 128, bf16) over a 32,768-token cache in 4
     shards: the log-sum-exp-combined partials within DECODE_TOL of the
     whole-cache decode, both against float64.

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

Then the zoo's train steps, after the serve phases free their memory:

  [train-zoo-kernel] kernel 4 at the two-tower's training forward and
     kernel 1 at its backward (the dense table gradient: the flat ids
     sorted by row, each record reading its bag's output gradient), at
     both towers' train_batch call sites (262,144 user bags into
     5,000,192 rows, 131,072 item bags into 500,224, W 8, d 256), mean
     and sum, against their plain versions; through autograd one launch
     of each, the gradient the direct call's bit for bit; both timed at
     the user call site beside their bounds, plain versions, and
     F.embedding_bag / zeros + index_add_ of pre-expanded rows;
  [train-zoo-parity] the reduced LM's lm_step("train_4k") and the reduced
     two-tower's train_batch, card vs CPU (TF32 off), 2 steps each: loss,
     parameters and Adam's moments; no flash launch on the LM's path,
     kernels 4 and 1 twice a two-tower step;
  [lm-train] mistral-nemo-12b's published widths and train_4k shape
     (256 x 4096 tokens a step, bf16 compute over f32 parameters and
     Adam), 2 of its 40 layers, grad_accum 128: the first microbatch's
     loss falls along its gradient; 1 step on token_batches: finite
     losses, step 0's at the init's (JAX's constant 3e-4 raises the loss
     at this width), no flash launch, then the updated parameters' loss
     on the first microbatch finite, moved from the init's and not blown
     up; seconds a step, tokens/s, the
     step's FLOPs and their bf16 bound, peak memory, one microbatch's
     forward and backward under torch.profiler;
  [rs-train] two-tower-retrieval's published widths and train_batch
     (65,536, temperature 0.05, f32), the tables cut to 5,000,192 and
     500,224 rows: the first batch's loss and gradient through the
     kernels vs the plain lookup's autograd; 3 steps, each launching
     kernels 4 and 1 twice; ms a step, examples/s, losses, peak memory,
     one step under torch.profiler;
  [train-cli] python -m repro_torch.launch.train --reduced --steps 3
     for both archs, as subprocesses on the card.

Then the graph zoo (GNN's note above phase_gnn_kernel: the global graph,
the sampler's batch and its cuts):

  [gnn-kernel] kernel 1 through gather_segment_sum (a stable sort by
     masked receiver, each record gathering its source row) and kernels
     1 + 2 through rmi_apply_read (the records added onto the synopsis,
     then the mean read at the picked rows) against their plain versions:
     no edges, every edge masked, one hub receiving every edge, receivers
     out of order, no records, every record on one row, and a planted
     fault each comparison must catch; rows 1e (the sampler's
     minibatch_lg batch, x [169,984, 602] and PNA's d 75) and 2e (the
     d3gnn layer-0 lane, 8,192 reads) timed beside their bounds, plain
     versions and (1e) zeros + index_add_ of pre-gathered rows; no zoo
     model calls either entry, as in the reference: their launches are
     the counts [gnn-train] reads over its runs, which must be 0;
  [gnn-parity] the six reduced models (pna, gatedgcn, dimenet, nequip,
     GAT, GCN), card vs CPU on one numpy-drawn graph: the forward, the
     gradients and two train steps (loss, every parameter and Adam leaf);
  [gnn-train] pna, gatedgcn, dimenet and nequip at minibatch_lg's
     published widths on the sampler's batch, then dimenet and nequip at
     molecule: the loss falls along -g, finite losses and gradients, 3
     steps (seconds each, the median of steps 1-2, seeds or graphs a
     second, peak memory), one step's top device ops;
  [gnn-cli] python -m repro_torch.launch.train --arch gatedgcn --shape
     full_graph_sm --steps 2, a subprocess on the card.

Then Mixture-of-Experts, the other LM configs and the locality step (MOE
and LOC's notes: the configurations, their cuts and tolerances):

  [moe-parity] moonshot-v1-16b-a3b, llama4-maverick-400b-a17b,
     internlm2-20b and mistral-large-123b at their REDUCED sizes (f32,
     TF32 off), card vs CPU: logits, 8 greedy decode steps from an empty
     cache, the loss with its aux and its gradients, one
     lm_step("train_4k") Adam step; on the two MoE configs the dispatch
     against dense_oracle where nothing drops and a planted fault (two
     experts' wd swapped) the logits comparison must catch;
  [moe-full] moonshot-v1-16b-a3b at its published widths and 48 layers,
     bf16, weights drawn on the card: the kernel path against the
     plain-attention path at S = 2048, both against f32 attention; one
     layer's dispatch and dense oracle at T = 256 (dropless) against the
     experts run in f32; one prefill_32k prefill at batch 1 (48 wgmma
     flash launches, the dispatch's dropped share); the serve CLI (batch
     4, 32 tokens) and a warm decode; tokens/s, peak memory, a profile
     of one prefill and one decode step;
  [moe-time] the flash kernel at moonshot's prefill layer (q, k, v [1,
     32768, 16, 128], G = 1) against its plain version per block
     against float64, then beside its bound, its plain version and
     scaled_dot_product_attention (row 5m);
  [moe-ep] one moonshot MoE layer on 4 gloo ranks sharing the card (16
     experts, 2,048 tokens a rank, f32): at capacity factor 8 the
     gathered outputs against dense_oracle, at 1.25 (pairs dropping)
     against the same ranks' CPU run; all_to_all calls, bytes, seconds
     blocked;
  [gnn-locality] PNA at ogb_products' widths on a powerlaw_edges graph
     (LOC), build_plan over 4 gloo ranks sharing the card: the global
     single-rank step three times (its gradients' gap against itself),
     then each rank's loss and gradients with local_update False and
     True against the global step's, a dropped halo row the comparison
     must catch; s a step, halo rows, bytes and seconds blocked, the
     plan's host seconds, peak memory.

Then the tooling (`launch/dryrun.py`, `roofline/`, `perf/`):

  [dryrun-meta] `run_cell` on the `meta` device over every cell at the
     single production mesh (the 40 assigned and d3gnn-sage) and the five
     LMs' train_4k at the multi-pod mesh: published models, per-device
     bytes under the family rules, the step traced under the analyzer
     (the LMs at 1 and 2 layer groups and microbatches, extrapolated);
     every cell must pass; its JAX-style [ok] line, the cells' count,
     seconds and failures;
  [dryrun-card] the one-card cells on the card (mistral-nemo-12b
     prefill_32k at batch 1, two-tower serve_p99 on the cut user table,
     d3gnn-sage's tick at 512 parts on live records, which must emit):
     first call, step s, peak memory, op GFLOP, the terms and the share
     of the roofline the step reached at the cell's peak rate (989
     TFLOP/s bf16; 67 f32), with the card's power limit; kernels 5, 4, 1
     and 2 launched over the cells (counts reset before, read after);
     mistral-nemo's prefill at S = 2,048: kernel 5 charged the causal
     pairs' products (the closed form), the plain attention's masked
     pairs charged apart (the closed form), the totals equal, kernel 5's
     bytes fewer; the two-tower cell's FLOPs through kernel 4 equal to
     its plain version's;
  [perf-variants] the nine variants of perf/variants.py on `meta` at the
     single mesh: each one's per-rank GFLOP and collective GB by kind.

Then the JAX package's four examples as the port's entry points
(`src/repro_torch/examples/`), at their default sizes on the card:

  [examples] `python -m repro_torch.examples.streaming_serve --ranks 4`
     (four gloo ranks sharing the card, the live 4 -> 2 reshard) as a
     subprocess, beside quickstart, train_streaming_gnn in both modes,
     streaming_serve and arch_zoo --arch all, each through its main(argv)
     in this process: each one's OK line, its wall, and its lines holding
     the JAX example's integers (ticks, emitted, messages, materialized,
     votes, steps, flush ticks, the query counts, the restored step, the
     reshard's moved share, the output shapes), which must equal
     EXAMPLE_PINS; kernels 1, 2, 4 and 5 launched by the in-process
     examples (counts reset before, read after).

After [mesh-full], [what-if]: the cost model fitted on [mesh-parity]'s
telemetry trace prices other route_caps' wire at [mesh-full]'s measured
gloo all_to_all rate (bytes over the seconds blocked in it).

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the repository around it, the script exits non-zero and prints no
result.
"""
import bisect
import copy
from dataclasses import dataclass
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
# over the run (f32 sums in another order: shares, carries); counts,
# dirty/touched flags and set-mode rows (copies) exact.
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
# the query plane. [query-full]: FULL with query_cap 32 pending slots a
# part and 256 admissions a tick (8 launches of T = 8 ticks carry 2,048
# queries each); per launch 2,048 stale_ok queries, one in `link_every`
# a LINK, the rest EMBED; the consistent queries (128 EMBED, 128 LINK)
# go in with the last stream launch. [mesh-parity]'s query run: the
# serve stream at query_cap 16 (a rank's wire lane 32 rows) and
# route_cap 16, so the wire lane defers; `burst` stale_ok links onto the
# hub in its second tick. [query-parity]: test_query_plane.py's sizes.
QUERY = dict(query_cap=32, query_tick_cap=256, per_launch=2048,
             link_every=8, consistent=128, mesh_query_cap=16, burst=48,
             golden=dict(n_nodes=32, n_edges=100, dims=(8, 12, 12),
                         tick_edges=24))
# [query-parity] card vs CPU, vec and score: |diff| <= QUERY_TOL *
# (1 + |cpu|) (the golden matrix's f32 bound). [query-full] consistent
# answers vs the float64 oracle: EMBED |diff| <= SINK_TOL * max(1, |ref|)
# per element; LINK |score - <ref_u, ref_v>| <= SINK_TOL * max(1,
# sum_i |ref_u,i ref_v,i|) (a sum of 64 products, each factor within
# SINK_TOL of its reference)
QUERY_TOL = 1e-5

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
def packed_layout(idx, vec, cnt, n_rows, mode="add"):
    """The PR 11-15 layout of a delivery, kept as kernel A's yardstick
    input: stable sort by destination and the packed [vec | cnt | touch]
    payload [C, d + 2] of the live records (zeros elsewhere). Returns
    (payload, seg [C] sorted ids, row_ptr [n_rows + 1]), the contiguous
    form's inputs."""
    import torch
    from repro_torch.kernels.segment_reduce import ops
    C, d = vec.shape
    valid = (idx >= 0) & (idx < n_rows)
    seg = torch.where(valid, idx, torch.full_like(idx, n_rows))
    seg_s, order = torch.sort(seg, stable=True)
    live = valid[order]
    if mode == "set":
        is_last = torch.ones_like(live)
        is_last[:-1] = seg_s[1:] != seg_s[:-1]
        live = live & is_last
    payload = torch.empty((C, d + 2), dtype=torch.float32, device=vec.device)
    payload[:, :d] = vec[order]
    payload[:, d] = cnt[order]
    payload[:, d + 1] = 1.0
    payload.masked_fill_(~live[:, None], 0.0)
    return payload, seg_s, ops.run_offsets(seg_s, n_rows)


def kernel_a_sum_check(got, want, absum, what):
    """An add-form output against its plain version: per element
    |diff| <= KA_TOL * (1 + the run's sum of magnitudes)."""
    err = (got - want).abs()
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= KA_TOL * (1 + absum)).all()),
          f"{what} disagrees: max err {worst}")
    return worst


def kernel_a_yardstick_check(ops, ref, payload, seg, row_ptr):
    """Kernel A's contiguous form on a packed payload vs its plain
    version; returns max abs err."""
    import torch
    got = ops.segment_sum_rows(payload, seg, row_ptr)
    want = ref.segment_sum_rows_ref(payload, seg, row_ptr)
    absum = ref.segment_sum_rows_ref(payload.abs(), seg, row_ptr)
    sync(got)
    d = payload.shape[1] - 2
    err = kernel_a_sum_check(got[:, :d], want[:, :d], absum[:, :d],
                             "segment_sum_rows (contiguous)")
    check(torch.equal(got[:, d:], want[:, d:]),
          "segment_sum_rows count/touch columns differ")
    return err


def kernel_a_check(ops, ref, vec, cnt, order, row_ptr, base, base_cnt):
    """Kernel A's fused forms vs the plain version on one layout: add and
    set, with and without the base, gathered through order and contiguous
    (the sorted rows); sums within KA_TOL, counts, flags and set rows
    exact. Returns max abs err."""
    import torch
    worst = 0.0
    contiguous = (vec[order], cnt[order], None)
    for v, c, o in ((vec, cnt, order), contiguous):
        for b, bc in ((base, base_cnt), (None, None)):
            for mode in ("add", "set"):
                what = (f"segment_deliver {mode} (order "
                        f"{'yes' if o is not None else 'no'}, base "
                        f"{'yes' if b is not None else 'no'})")
                got = ops.deliver_rows(v, row_ptr, o, c, b, bc, mode)
                want = ref.deliver_rows_ref(v, row_ptr, o, c, b, bc, mode)
                sync(got[0])
                check(torch.equal(got[1], want[1])
                      and torch.equal(got[2], want[2]),
                      f"{what}: counts or flags differ")
                if mode == "set":
                    check(torch.equal(got[0], want[0]),
                          f"{what}: rows differ")
                    continue
                absum = ref.deliver_rows_ref(
                    v.abs(), row_ptr, o, None,
                    None if b is None else b.abs(), None, mode)[0]
                worst = max(worst, kernel_a_sum_check(got[0], want[0],
                                                      absum, what))
                del got, want, absum
    return worst


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
        dst = torch.randn(n_rows, vec.shape[1], generator=gen,
                          device=device)
        base_cnt = torch.randint(0, 4, (n_rows,), generator=gen,
                                 device=device).float()
        order, row_ptr = ops.sort_runs(idx, n_rows)
        e = kernel_a_check(ops, ref, vec, cnt, order, row_ptr, dst, base_cnt)
        errs["segment_sum_rows"] = max(errs["segment_sum_rows"], e)
        for mode in ("add", "set"):
            e = kernel_a_yardstick_check(ops, ref, *packed_layout(
                idx, vec, cnt, n_rows, mode))
            errs["segment_sum_rows"] = max(errs["segment_sum_rows"], e)
        del order, row_ptr
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
        kernel_a_sum_check(ga, wa, absum, f"kernel deliver_add vs scatter "
                                          f"(C={idx.shape[0]}, "
                                          f"rows={n_rows})")

    # last-writer-wins with duplicates, sentinel and negative rows
    deliver_case(torch.tensor([3, 5, 3, 3, 5, 8, 9, -1, 7]),
                 torch.arange(18, dtype=torch.float32).reshape(9, 2),
                 torch.arange(9, dtype=torch.float32), 8)
    # all padding
    deliver_case(torch.full((300,), 99), torch.ones(300, 5),
                 torch.ones(300), 16)
    # one hub run spanning many kernel shares, and one over ~1.6e3 shares
    deliver_case(torch.full((5000,), 11),
                 torch.randn(5000, 70, generator=gen, device=device),
                 torch.ones(5000), 40)
    deliver_case(torch.full((105_000,), 3),
                 torch.randn(105_000, 602, generator=gen, device=device),
                 torch.ones(105_000), 9)
    # one output row; no output rows
    deliver_case(torch.tensor([0, 0, 1, -1, 0]), torch.randn(
        5, 3, generator=gen, device=device), torch.ones(5), 1)
    deliver_case(torch.tensor([0, 2]), torch.ones(2, 4), torch.ones(2), 0)
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


def stream_pipeline(full, backend, device, edges, feats, **cfg_kw):
    """Stream + flush with the super-tick driver (cfg_kw: more
    PipelineConfig fields). Returns (pipeline, wall seconds, synchronizing
    CUDA calls by call site during the stream)."""
    import torch
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                         delivery_backend=backend,
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4), **cfg_kw)
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
    baseline = dict(edges_per_s=full["n_edges"] / secs, n_super=n_super,
                    sync_sites=dict(sync_sites))
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
    return pipe, launches, baseline


# ------------------------------------------------------------- phase 5
def time_ms(fn, iters=10, flush_bytes=256 << 20):
    """Mean device time of fn with CUDA events, one launch per event pair,
    L2 flushed (by a write larger than the 50 MB L2) before each. The
    events are made before the flush, so the host work left between the
    flush's launch and fn's is the start event's record and fn itself;
    it must end before the flush does (event_window_check), or the
    window holds host time too."""
    import torch
    scratch = torch.empty(flush_bytes // 4, dtype=torch.float32,
                          device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        scratch.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def event_window_check(tag, what, kernel, fn, ms, iters=10,
                       flush_bytes=256 << 20):
    """Does time_ms's window hold device time only? Its start event is
    recorded behind the flush write, so the window holds host work too
    unless what time_ms does on the host from the flush's launch to fn's
    kernel launch (the start event's record, then fn) ends before the
    flush does: that host time (no sync) against the flush's device time,
    each averaged over `iters`. And the kernel's own device duration
    under torch.profiler (the same flushes around it), averaged over its
    launches, beside `ms`. Prints both; returns {profiler_ms, host_ms,
    flush_ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    scratch = torch.empty(flush_bytes // 4, dtype=torch.float32,
                          device="cuda")
    fn()
    torch.cuda.synchronize()
    host = flush = 0.0
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        scratch.zero_()
        t0 = time.perf_counter()
        b.record()          # ends the flush; time_ms's start event
        fn()
        host += time.perf_counter() - t0
        torch.cuda.synchronize()
        flush += a.elapsed_time(b)
    host_ms, flush_ms = host * 1e3 / iters, flush / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            scratch.zero_()
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    hits = [e for e in prof.key_averages()
            if kernel in e.key and dev_us(e) > 0]
    n = sum(e.count for e in hits)
    prof_ms = sum(dev_us(e) for e in hits) / 1e3 / n if n else None
    print(f"[{tag}] {what}: event window {ms:.4f} ms; the kernel's own "
          f"device time under torch.profiler "
          + (f"{prof_ms:.4f} ms a launch ({n} launches of {kernel})"
             if n else f"not measured (no {kernel} events)")
          + f"; host time from the flush's launch to fn's return "
          f"{host_ms:.4f} ms, "
          f"{'inside' if host_ms < flush_ms else 'NOT inside'} the "
          f"{flush_ms:.4f} ms flush write")
    return {"profiler_ms": prof_ms, "host_ms": host_ms, "flush_ms": flush_ms}


def bound_ms(n_bytes, n_ops):
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S) * 1e3


def phase_timing(pipe, launches, errs):
    """Time both kernels on inputs of the main path at full width: the
    forward stage's per-part picks read from the final layer-0 aggregator
    table (first, before kernel A's timings churn the allocator), and the
    final topology's layer-0 RMI lane with every edge live (the heaviest
    round-B delivery)."""
    import torch
    from repro_torch.core.delivery import KernelDelivery, ScatterDelivery
    from repro_torch.core.state import local_index
    from repro_torch.kernels.segment_reduce import ops, ref
    cfg, topo, ls, dev = pipe.cfg, pipe.topo, pipe.states[0], pipe.device
    P, N, d = ls.agg.shape
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # kernel B: the first outbox_per_part evicting masters of every part,
    # read from layer 0's table (d = 602) and layer 1's (d = 64)
    k = cfg.capacities().outbox_per_part
    order = torch.where(topo.is_master, torch.arange(N, device=dev), N)
    picked = torch.clamp(torch.topk(order, k, dim=1, largest=False).values,
                         max=N - 1)
    rows = (torch.arange(P, device=dev)[:, None] * N + picked).reshape(-1)
    K = rows.shape[0]
    b_times = {}
    for layer in (0, 1):
        st = pipe.states[layer]
        db = st.agg.shape[2]
        agg, cnt = st.agg.reshape(P * N, db), st.agg_cnt.reshape(P * N)
        errs["mean_rows_gather"] = max(errs["mean_rows_gather"],
                                       kernel_b_check(ops, ref, agg, cnt,
                                                      rows))
        fn = lambda: ops.mean_rows_gather(agg, cnt, rows)
        b_ms = time_ms(fn)
        b_plain = time_ms(lambda: ref.mean_rows_gather_ref(agg, cnt, rows))
        # indices and counts read, the rows with cnt > 0 read, out written
        live = int((cnt[rows] > 0).sum())
        b_bytes = K * 8 + K * 4 + live * db * 4 + K * db * 4
        b_bound = bound_ms(b_bytes, live * db)
        all_rows = bound_ms(K * 8 + K * 4 + 2 * K * db * 4, K * db)
        print(f"[time] mean_rows_gather, layer {layer}: K={K} d={db} table "
              f"rows={P * N} ({live} picks with cnt > 0): {b_ms:.4f} ms; "
              f"bound {b_bound:.4f} ms (bytes: {b_bytes}; "
              f"{b_bound / b_ms:.3f} of it reached; {all_rows:.4f} ms with "
              f"every picked row read, cnt <= 0 or not); plain "
              f"{b_plain:.4f} ms")
        win = event_window_check("time", f"mean_rows_gather, layer {layer}",
                                 "mean_rows_gather_kernel", fn, b_ms)
        b_times[layer] = dict(d=db, ms=b_ms, plain_ms=b_plain,
                              bound_ms=b_bound, **win)
        del agg, cnt
    del rows, order, picked

    # kernel A: the RMI lane (edge_tick_cap fresh + P * edge_cap records)
    idx, _ = local_index(topo.e_dst_mpart.reshape(-1),
                         topo.e_dst_mslot.reshape(-1), 0, P, N,
                         topo.e_valid.reshape(-1))
    n = P * N
    idx = torch.cat([torch.full((cfg.edge_tick_cap,), n, device=dev), idx])
    C = idx.shape[0]
    vec = torch.randn(C, d, device=dev, generator=gen)
    cnt = torch.ones(C, device=dev)

    # the PR 11-15 yardstick: the contiguous form on the packed payload
    payload, seg, row_ptr = packed_layout(idx, vec, cnt, n, "add")
    errs["segment_sum_rows"] = max(
        errs["segment_sum_rows"],
        kernel_a_yardstick_check(ops, ref, payload, seg, row_ptr))
    live = int(row_ptr[-1])
    W = payload.shape[1]
    y_ms = time_ms(lambda: ops.segment_sum_rows(payload, seg, row_ptr))
    y_plain = time_ms(lambda: ref.segment_sum_rows_ref(payload, seg,
                                                       row_ptr))
    seg_l, rows_l = seg[:live], payload[:live]
    y_lib = time_ms(lambda: torch.zeros(n, W, device=dev).index_add_(
        0, seg_l, rows_l))
    y_bound = bound_ms(live * W * 4 + live * 8 + (n + 1) * 8 + n * W * 4,
                       live * W)
    print(f"[time] segment_sum_rows, contiguous form on the packed payload "
          f"(yardstick): E={C} live={live} W={W} rows={n}: {y_ms:.4f} ms; "
          f"bound {y_bound:.4f} ms (bytes; {y_bound / y_ms:.3f} of it "
          f"reached); plain {y_plain:.4f} ms; zeros + index_add_ "
          f"{y_lib:.4f} ms")
    del payload, seg, row_ptr, seg_l, rows_l

    # the fused delivery at the same lane: the main path's add form (base
    # read and the new table written in the same call)
    order, row_ptr = ops.sort_runs(idx, n)
    base = torch.randn(n, d, device=dev, generator=gen)
    base_cnt = torch.randint(0, 4, (n,), device=dev, generator=gen).float()
    args = (vec, row_ptr, order, cnt, base, base_cnt, "add")
    got, want = ops.deliver_rows(*args), ref.deliver_rows_ref(*args)
    sync(got[0])
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          "segment_deliver add at the RMI lane: counts or flags differ")
    absum = ref.deliver_rows_ref(vec.abs(), row_ptr, order, None,
                                 base.abs(), None, "add")[0]
    errs["segment_sum_rows"] = max(
        errs["segment_sum_rows"], kernel_a_sum_check(
            got[0], want[0], absum, "segment_deliver add at the RMI lane"))
    del got, want, absum
    f_ms = time_ms(lambda: ops.deliver_rows(*args))
    f_plain = time_ms(lambda: ref.deliver_rows_ref(*args))
    seg_s = torch.where((idx >= 0) & (idx < n), idx,
                        torch.full_like(idx, n))[order]
    seg_l, rows_l = seg_s[:live], vec[order[:live]]
    pad = torch.cat([base, base.new_zeros(1, d)])
    f_lib = time_ms(lambda: pad.index_add_(0, seg_l, rows_l))
    del pad, rows_l
    # gathered live rows, their order entries and counts, row_ptr, base
    # and base_cnt read; out, cnt_out and flag written
    f_bytes = (live * (d * 4 + 8 + 4) + (n + 1) * 8 + 2 * n * (d * 4 + 4)
               + n)
    f_bound = bound_ms(f_bytes, live * d + n * d)
    print(f"[time] segment_deliver add (fused delivery) at the same lane: "
          f"{f_ms:.4f} ms; bound {f_bound:.4f} ms (bytes: {f_bytes}; "
          f"{f_bound / f_ms:.3f} of it reached); plain {f_plain:.4f} ms; "
          f"index_add_ of the live rows into a padded copy of the base "
          f"{f_lib:.4f} ms")
    # the set form on the same runs: each touched row's last record, the
    # base row elsewhere
    touched = int((row_ptr[1:] > row_ptr[:-1]).sum())
    s_args = (vec, row_ptr, order, None, base, None, "set")
    s_ms = time_ms(lambda: ops.deliver_rows(*s_args))
    s_bytes = (touched * (d * 4 + 8) + (n + 1) * 8
               + (n - touched) * d * 4 + n * d * 4 + n)
    s_bound = bound_ms(s_bytes, 0)
    print(f"[time] segment_deliver set at the same lane ({touched} touched "
          f"rows): {s_ms:.4f} ms; bound {s_bound:.4f} ms "
          f"({s_bound / s_ms:.3f})")
    # the delivery plane's add call, sort included: the kernel backend,
    # the PR 11-15 path (packed payload, contiguous form, epilogue) and
    # the scatter backend
    kd, sd = KernelDelivery(), ScatterDelivery()

    def packed_add():
        out = ops.segment_sum_rows(*packed_layout(idx, vec, cnt, n, "add"))
        return base + out[:, :d], base_cnt + out[:, d], out[:, d + 1] > 0

    p_new = time_ms(lambda: kd.deliver_add(base, base_cnt, idx, vec, cnt))
    p_old = time_ms(packed_add)
    p_sc = time_ms(lambda: sd.deliver_add(base, base_cnt, idx, vec, cnt))
    print(f"[time] delivery plane, deliver_add at the same lane (sort "
          f"included): kernel backend {p_new:.4f} ms; the PR 11-15 packed "
          f"path {p_old:.4f} ms; scatter backend {p_sc:.4f} ms")
    del vec, cnt, order, row_ptr, base, base_cnt, seg_s, seg_l, idx

    src = "src/repro_torch/csrc/segment_reduce.cu"
    tpu = "src/repro/kernels/segment_reduce/kernel.py"
    return {"kernels": [
        {"name": "segment_sum_rows", "route": "cuda", "source": src,
         "replaces": f"{tpu}:59",
         "launches": launches["segment_sum_rows"],
         "max_abs_err": errs["segment_sum_rows"], "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": "bytes",
         "library_ms": f_lib,
         "yardstick": {"form": "contiguous, packed payload", "ms": y_ms,
                       "plain_ms": y_plain, "bound_ms": y_bound,
                       "library_ms": y_lib},
         "set": {"ms": s_ms, "bound_ms": s_bound},
         "delivery_plane_ms": {"kernel": p_new, "packed": p_old,
                               "scatter": p_sc}},
        {"name": "mean_rows_gather", "route": "cuda", "source": src,
         "replaces": f"{tpu}:95",
         "launches": launches["mean_rows_gather"],
         "max_abs_err": errs["mean_rows_gather"], "ms": b_times[0]["ms"],
         "plain_ms": b_times[0]["plain_ms"],
         "bound_ms": b_times[0]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "layer0": b_times[0], "layer1": b_times[1]}]}


# ------------------------------------------------------------- phase 6
def call_site(event):
    """Where a profiler event was launched from: its innermost repro_torch
    frame and, below that, the tick stage (core/tick.py) it ran in, as
    'kernels/segment_reduce/ops.py(86): sort_runs < core/tick.py(241):
    apply_rmis'. Walks up from the event (a kernel's launch) through its
    enclosing events: the first one with a recorded stack gives the
    frames; where stacks are recorded as Python-function events instead
    (with_stack=True in newer PyTorch), those events' names do."""
    frames, node = [], event
    while node is not None:
        stack = [f.split("repro_torch/", 1)[1]
                 for f in (getattr(node, "stack", None) or [])
                 if "repro_torch/" in f]
        if stack:
            frames += stack
            break
        if "repro_torch/" in node.name:
            frames.append(node.name.split("repro_torch/", 1)[1])
        node = node.cpu_parent
    if not frames:
        return None
    stage = next((f for f in frames[1:] if f.startswith("core/tick.py")),
                 frames[1] if len(frames) > 1 else None)
    return frames[0] + (f" < {stage}" if stage else "")


def device_ms_by_site(prof):
    """(device ms by call site, launches by call site, launches linked to
    an event) of a torch.profiler run with stacks: each kernel's time goes
    to the call site (`call_site`) of the event that launched it or, where
    its own chain names none (ctypes launches), of the innermost event
    with a stack that encloses it in time on the same thread."""
    by_site, n_site, n_kernels = Counter(), Counter(), 0
    all_events = list(prof.events())
    # events with a repro_torch stack, by thread and start
    stacked = {}
    for x in all_events:
        if call_site(x) is not None:
            stacked.setdefault(x.thread, []).append(x)
    for xs in stacked.values():
        xs.sort(key=lambda x: x.time_range.start)

    def enclosing_site(e):
        xs = stacked.get(e.thread, [])
        starts = [x.time_range.start for x in xs]
        i = bisect.bisect_right(starts, e.time_range.start)
        for x in reversed(xs[max(0, i - 64):i]):
            if x.time_range.end >= e.time_range.end:
                return call_site(x)
        return None

    for e in all_events:
        kernels = [k for k in getattr(e, "kernels", [])
                   if k.name != "Command Buffer Full"]
        n_kernels += len(kernels)
        site = (call_site(e) or enclosing_site(e)) if kernels else None
        if site:
            by_site[site] += sum(k.duration for k in kernels) / 1e3
            n_site[site] += len(kernels)
    return by_site, n_site, n_kernels


def phase_profile(full, device, warm_super_ticks=6, top=24, sites=20):
    """Device time by operator over ONE steady-state full-width
    super-tick (torch.profiler), after `warm_super_ticks` unprofiled ones
    of the same stream: the per-operator breakdown of the tick program,
    then the same device time by the call site of the op that launched
    it (profiler stacks; the hand-written kernels launch through ctypes,
    outside any op, and are listed by name above)."""
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
    # verbose: the Python stacks land on the events (not every PyTorch
    # version records them otherwise)
    verbose = torch._C._profiler._ExperimentalConfig(verbose=True)
    with profile(activities=acts, with_stack=True,
                 experimental_config=verbose) as prof:
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
    by_site, n_site, n_kernels = device_ms_by_site(prof)
    print(f"[profile] by call site: {sum(by_site.values()):.3f} ms of the "
          f"device busy time attributed ({n_kernels} launches linked to "
          f"an event)")
    for site, ms in by_site.most_common(sites):
        print(f"[profile] {ms:9.3f} ms  {n_site[site]:6d} x  {site[:110]}")


# ------------------------------------------------------------- query phases
def golden_query_stream(g):
    """tests/test_query_plane.py:make_stream (seed 0)."""
    rng = np.random.default_rng(SEED)
    n = g["n_nodes"]
    edges = np.stack([rng.integers(0, n, g["n_edges"]),
                      rng.integers(0, n, g["n_edges"])], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=g["dims"][0]).astype(np.float32)
             for v in range(n)}
    return edges, feats


def golden_query_mix(edges):
    """tests/test_query_plane.py:query_mix: stale_ok and consistent
    embeds, a consistent and a stale_ok link."""
    from repro_torch.serve.query import KIND_EMBED, KIND_LINK
    u, v = int(edges[0, 0]), int(edges[0, 1])
    return [(1, KIND_EMBED, 0, False), (2, KIND_LINK, u, v, True),
            (3, KIND_EMBED, 5, True), (4, KIND_LINK, u, 5, False)]


def sorted_answers(pipe):
    ans = pipe.drain_answers()
    order = np.argsort(ans["qid"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in ans.items()}


def golden_query_run(device, driver, backend, g):
    """tests/test_query_plane.py:run_config through the port: three update
    ticks, the golden mix with the fourth, then the flush."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    edges, feats = golden_query_stream(g)
    cfg = PipelineConfig(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                         feat_cap=128, edge_tick_cap=32,
                         max_nodes=g["n_nodes"], query_cap=8,
                         delivery_backend=backend,
                         window=win.WindowConfig(kind=win.STREAMING))
    pipe = D3Pipeline(GraphSAGE(g["dims"], seed=SEED), cfg, device=device)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, g["tick_edges"])
    q = golden_query_mix(edges)
    if driver == "tick":
        for i, (ch, fe) in enumerate(zip(e_chunks, f_chunks)):
            pipe.tick(ch, fe, queries=q if i == len(e_chunks) - 1 else None)
        pipe.flush(max_ticks=96)
    else:
        pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks),
                            query_chunks=[None] * (len(e_chunks) - 1) + [q])
        pipe.flush_super(max_ticks=96, T=4)
    return sorted_answers(pipe), pipe.metrics


def answers_check(tag, got, want, tol):
    """Card answers against CPU answers: ints exact, vec and score within
    tol x (1 + |cpu|). Returns the max |card - cpu| of vec and score."""
    for k in ("qid", "kind", "ok", "tick", "issue"):
        check(np.array_equal(got[k], want[k]),
              f"[{tag}] answer {k} differs, card vs CPU: {got[k][:8]} vs "
              f"{want[k][:8]}")
    err = 0.0
    for k in ("vec", "score"):
        d = np.abs(got[k] - want[k])
        check(bool((d <= tol * (1 + np.abs(want[k]))).all()),
              f"[{tag}] answer {k}: max |card - cpu| {float(d.max())}")
        err = max(err, float(d.max()) if d.size else 0.0)
    return err


def phase_query_parity(device, q=QUERY):
    import torch
    from repro_torch.kernels.segment_reduce import ops
    g = q["golden"]
    worst = 0.0
    for driver in ("tick", "super"):
        for backend in ("kernel", "scatter"):
            ops.reset_launches()
            got, mg = golden_query_run(device, driver, backend, g)
            launches = dict(ops.LAUNCHES)
            want, mw = golden_query_run(torch.device("cpu"), driver,
                                        backend, g)
            worst = max(worst, answers_check("query-parity", got, want,
                                             QUERY_TOL))
            check(got["qid"].tolist() == [1, 2, 3, 4] and got["ok"].all(),
                  f"[query-parity] {driver}/{backend}: answers {got['qid']}"
                  f" ok {got['ok']}")
            for k in ("queries_admitted", "queries_answered",
                      "queries_dropped", "query_hold_ticks", "ticks",
                      "reduce_msgs"):
                check(getattr(mg, k) == getattr(mw, k),
                      f"[query-parity] {driver}/{backend}: {k} differs")
            if backend == "kernel" and device.type == "cuda":
                check(all(v > 0 for v in launches.values()),
                      f"[query-parity] a kernel never launched: {launches}")
            print(f"[query-parity] {driver} driver, {backend} backend: card "
                  f"= CPU on qid/kind/ok/tick/issue (answer ticks "
                  f"{got['tick'].tolist()}, issue {got['issue'].tolist()}); "
                  f"launches {launches}")
    print(f"[query-parity] vec/score max |card - cpu| {worst:.3e} "
          f"(tolerance {QUERY_TOL} x (1 + |cpu|))")


def counted_syncs(fn, cuda):
    """Run fn with synchronizing CUDA calls reported; returns (fn's
    result, Counter of their call sites outside this file)."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    return out, Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                        if "synchronizing CUDA operation" in str(w.message)
                        and Path(w.filename).name != Path(__file__).name)


def phase_query_full(device, baseline, full=FULL, q=QUERY):
    """phase 4's configuration and stream with the query plane on, through
    ServeSession(driver="super"); see the module docstring. baseline:
    phase 4's edges/s and synchronizing call sites (phase_full_width)."""
    import torch
    from repro_torch.core import windowing as win
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.serve.query import KIND_EMBED, KIND_LINK
    from repro_torch.serve.session import ServeSession
    edges, feats = make_stream(full["n_nodes"], full["n_edges"],
                               full["dims"][0])
    cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                         delivery_backend="kernel",
                         query_cap=q["query_cap"],
                         query_tick_cap=q["query_tick_cap"],
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    pipe = D3Pipeline(GraphSAGE(full["dims"], seed=SEED), cfg, device=device)
    T, te = full["super_ticks"], full["tick_edges"]
    sess = ServeSession(pipe, driver="super", super_ticks=T)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, te)
    gen = np.random.default_rng(SEED + 2)
    per_tick = q["per_launch"] // T
    n_link = per_tick // q["link_every"]
    rec, consistent = {}, set()         # qid -> (kind, u, v)
    wall, syncs, n_launch = 0.0, Counter(), 0
    stale_checked = stale_ok = 0
    ops.reset_launches()

    def submit(pool, n_embed, n_links, cons=False):
        vids = gen.choice(pool, n_embed)
        pairs = gen.choice(pool, (n_links, 2))
        qe = sess.submit_embed(vids, consistent=cons)
        ql = sess.submit_link(pairs, consistent=cons)
        rec.update(zip(qe, ((KIND_EMBED, int(v), 0) for v in vids)))
        rec.update(zip(ql, ((KIND_LINK, int(u), int(v)) for u, v in pairs)))
        if cons:
            consistent.update(qe + ql)

    def timed(fn):
        nonlocal wall
        t0 = time.perf_counter()
        _, sites = counted_syncs(fn, cuda)
        if cuda:
            torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        syncs.update(sites)

    starts = list(range(0, len(e_chunks), T))
    for lo in starts:
        # vids ingested by this launch's first tick (queries resolve after
        # their tick's edges)
        pool = np.unique(edges[:(lo + 1) * te])
        for _ in range(T):      # the session admits them tick by tick
            submit(pool, per_tick - n_link, n_link)
        if lo == starts[-1]:
            submit(pool, q["consistent"], q["consistent"], cons=True)
        timed(lambda: sess.advance_super(e_chunks[lo:lo + T],
                                         f_chunks[lo:lo + T], T=T))
        n_launch += 1
        # this launch's last tick: its stale_ok EMBED answers are the rows
        # read_nodes reads now (not counted among the launch's syncs)
        last = pipe.now - 1
        mine = [a for qid, a in sess.answers.items()
                if a.answer_tick == last and rec[qid][0] == KIND_EMBED
                and qid not in consistent]
        got = pipe.read_nodes([rec[a.qid][1] for a in mine])
        for a in mine:
            v = rec[a.qid][1]
            stale_checked += 1
            if a.ok:
                check(v in got and np.array_equal(
                    a.vec.view(np.int32), got[v].view(np.int32)),
                    f"[query-full] stale_ok answer {a.qid} (vid {v}) at "
                    f"tick {last} is not read_nodes' row")
                stale_ok += 1
            else:
                check(v not in got, f"[query-full] vid {v} answered "
                                    "ok=False but read_nodes has its row")
    # consistent queries queued past the last launch's 2,048-query budget
    # admit in one more launch; the flush drains the pipeline
    timed(lambda: sess.advance_super(T=T))
    n_launch += 1
    timed(lambda: sess.flush(max_ticks=256))
    m = pipe.metrics
    n_super = m.ticks // T
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = dict(ops.LAUNCHES)
    n_ans = len(sess.answers)
    check(sess.outstanding == 0, f"[query-full] {sess.outstanding} queries "
                                 "left outstanding")
    check(m.queries_dropped == 0, f"[query-full] {m.queries_dropped} "
                                  "admissions dropped")
    check(n_ans == len(rec), f"[query-full] {n_ans} answers for {len(rec)} "
                             "queries")
    if cuda:
        check(all(v > 0 for v in launches.values()),
              f"[query-full] a kernel never launched: {launches}")
    check(stale_ok > 0, f"[query-full] no ok stale_ok EMBED answer at a "
                        f"launch's last tick ({stale_checked} checked)")

    # consistent answers against the float64 static oracle
    model64 = copy.deepcopy(pipe.model).double()
    g, _ = build_snapshot(edges, feats, full["dims"][0], full["n_nodes"],
                          device, dtype=torch.float64)
    ref = oracle_embeddings(model64, g).cpu().numpy()
    del model64, g
    worst_e = worst_l = 0.0
    n_cok = 0
    for qid in consistent:
        a = sess.answers[qid]
        if not a.ok:
            continue
        n_cok += 1
        kind, u, v = rec[qid]
        if kind == KIND_EMBED:
            r = ref[u]
            worst_e = max(worst_e, float(
                (np.abs(a.vec - r) / np.maximum(1.0, np.abs(r))).max()))
        else:
            dot = float(ref[u] @ ref[v])
            scale = max(1.0, float(np.abs(ref[u] * ref[v]).sum()))
            worst_l = max(worst_l, abs(a.score - dot) / scale)
    check(n_cok > 0, "[query-full] no consistent answer was ok")
    check(worst_e <= SINK_TOL and worst_l <= SINK_TOL,
          f"[query-full] consistent answers vs the float64 oracle: EMBED "
          f"{worst_e:.3e}, LINK {worst_l:.3e} > {SINK_TOL}")

    # the same synchronizing call sites and counts a super-tick as phase 4
    per = {k: v / n_super for k, v in syncs.items()}
    if cuda:
        per4 = {k: v / baseline["n_super"]
                for k, v in baseline["sync_sites"].items()}
        check(per == per4, f"[query-full] synchronizing calls a super-tick "
                           f"{per}, phase 4 {per4}")
    print(f"[query-full] caps {full['caps']} dims {full['dims']} query_cap "
          f"{q['query_cap']} query_tick_cap {q['query_tick_cap']}; "
          f"ServeSession(driver=super, T={T}); {len(starts)} stream launches"
          f" of {q['per_launch']} stale_ok queries (1 in "
          f"{q['link_every']} LINK), {2 * q['consistent']} consistent "
          f"queries with the last, one more launch, then the flush")
    print(f"[query-full] {full['n_edges']} edges and {len(rec)} queries in "
          f"{wall:.3f}s: {full['n_edges'] / wall:.1f} edges/s (phase 4 "
          f"without queries, this call: "
          f"{baseline['edges_per_s']:.1f}); "
          f"{n_ans / wall:.1f} answered/s ({m.queries_answered} answered "
          f"on the device, {n_ans - m.queries_answered} rejected on the "
          f"host); admitted {m.queries_admitted}, dropped "
          f"{m.queries_dropped}, held query-ticks {m.query_hold_ticks}; "
          f"ticks {m.ticks}; RMIs {m.reduce_msgs}; host staging "
          f"{m.host_seconds:.3f}s; peak memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB)")
    for mode in ("stale_ok", "consistent"):
        xs = [a for qid, a in sess.answers.items()
              if (qid in consistent) == (mode == "consistent")
              and a.latency_s is not None and a.answer_tick >= 0]
        lat = np.asarray([a.latency_s for a in xs]) * 1e3
        st = np.asarray([a.staleness_ticks for a in xs])
        print(f"[query-full] {mode}: {len(xs)} answers ("
              f"{sum(a.ok for a in xs)} ok); enqueue->answer p50 "
              f"{np.percentile(lat, 50):.3f} ms, p99 "
              f"{np.percentile(lat, 99):.3f} ms; staleness p50 "
              f"{np.percentile(st, 50):.1f} ticks, p99 "
              f"{np.percentile(st, 99):.1f} ticks")
    print(f"[query-full] stale_ok EMBED answers of each launch's last tick: "
          f"{stale_ok} ok of {stale_checked}, each bit-equal to read_nodes "
          f"(the others ok=False and absent from it); consistent answers "
          f"vs the float64 oracle ({n_cok} ok): EMBED {worst_e:.3e}, LINK "
          f"{worst_l:.3e} (tolerance {SINK_TOL}); synchronizing calls a "
          f"super-tick {per} over {n_super} super-ticks (phase 4: "
          f"{baseline['sync_sites']} over {baseline['n_super']}); "
          f"launches {launches}")
    if cuda:
        # one more launch of the same traffic (no edges) under
        # torch.profiler with stacks
        for _ in range(T):
            submit(np.unique(edges), per_tick - n_link, n_link)
        query_stage_profile(sess, q, T)
    del pipe, sess
    free_cuda()


def query_stage_profile(sess, q, T):
    """Advance the session one launch under torch.profiler with stacks:
    the device ms of the query plane's stages by call site (innermost
    frame in serve/query.py) beside the launch's device busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    verbose = torch._C._profiler._ExperimentalConfig(verbose=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, experimental_config=verbose) as prof:
        t0 = time.perf_counter()
        sess.advance_super(T=T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_site, n_site, _ = device_ms_by_site(prof)
    busy = sum(k.duration for e in prof.events()
               for k in getattr(e, "kernels", [])
               if k.name != "Command Buffer Full") / 1e3
    sites = {s: ms for s, ms in by_site.items()
             if s.startswith("serve/query.py")}
    print(f"[query-full] one more launch of {q['per_launch']} stale_ok "
          f"queries and no edges under torch.profiler: wall "
          f"{wall * 1e3:.3f} ms, device busy {busy:.3f} ms, the query "
          f"stages (serve/query.py) {sum(sites.values()):.3f} ms in "
          f"{sum(n_site[s] for s in sites)} launches"
          + ("" if busy else " (not measured: no device events)"))
    for site, ms in sorted(sites.items(), key=lambda kv: -kv[1])[:16]:
        print(f"[query-full] {ms:9.3f} ms  {n_site[site]:6d} x  "
              f"{site[:110]}")


# ------------------------------------------ delta gating and training
# [gate-full]: waves of feature updates on `wave_vids` ingested vertices,
# each delta's L2 norm drawn log-uniform in [norm_lo, norm_hi]; eps is the
# median norm of the first wave, so the layer-0 deltas straddle it.
GATE = dict(waves=3, wave_vids=8192, norm_lo=1e-3, norm_hi=1e-1,
            golden_eps=1e-3)
# [train-full]: Reddit's 41 classes (Hamilton et al. 2017, whose 602-d
# features set D_IN); labels are the argmax of a seeded projection of
# each vertex's features. (a) lr 0, one label tick of `labels` labels;
# (b) Adam, int8 top-k compression, `train_cap` labels a tick, a 16-tick
# window, a fire at `batch_threshold` active masters. lr 1e-3: Adam moves
# every weight by ~lr a step, and at 1e-2 a hundred steps outgrow the
# layer-0 weights (lecun std 0.04 at fan-in 602) and the loss diverged.
TRAIN = dict(n_classes=41, labels=4096, train_cap=1024, window=16,
             batch_threshold=256, lr=1e-3, topk_frac=0.25)
# (a): every leaf of last_grad and the loss within TRAIN_TOL relative L2
# of float64 torch.autograd of the static model (f32 sums in the stream's
# order vs a float64 static sum; the sink itself is within 3e-6)
TRAIN_TOL = 1e-4
# (b): kernel vs scatter backend, the loss at each fire within
# TRAIN_LOSS_TOL relative (f32 sums in another order, then int8 rounding
# and top-k thresholds that can flip on them, over every step)
TRAIN_LOSS_TOL = 1e-2
# [gate-parity] / [train-parity] card vs CPU, floats: |diff| <= PARITY_TOL
# x (1 + |cpu|) (f32 sums of the same records in another order)
PARITY_TOL = 1e-4


class SiteLaunches:
    """Kernel A launches by delivery call and calling function while the
    context is open ('add_rows < coalesce_msg_batch'): the kernel
    backend's three delivery methods are wrapped to read
    ops.LAUNCHES["segment_sum_rows"] around each call."""

    def __init__(self):
        self.counts = Counter()

    def __enter__(self):
        from repro_torch.core.delivery import KernelDelivery
        from repro_torch.kernels.segment_reduce import ops
        self._saved = {}
        for name in ("add_rows", "deliver_add", "deliver_set"):
            orig = getattr(KernelDelivery, name)
            self._saved[name] = orig

            def wrapped(dself, *a, _orig=orig, _name=name, **k):
                before = ops.LAUNCHES["segment_sum_rows"]
                out = _orig(dself, *a, **k)
                caller = sys._getframe(1).f_code.co_name
                self.counts[f"{_name} < {caller}"] += (
                    ops.LAUNCHES["segment_sum_rows"] - before)
                return out
            setattr(KernelDelivery, name, wrapped)
        return self

    def __exit__(self, *exc):
        from repro_torch.core.delivery import KernelDelivery
        for name, orig in self._saved.items():
            setattr(KernelDelivery, name, orig)


def train_recorder(log):
    """Patch the pipeline's train stage to append each tick's (steps,
    loss) to `log` as a device tensor (no host read)."""
    import torch
    from repro_torch.core import pipeline as pl
    orig = pl.train_stage

    def rec(*a, **k):
        ts = orig(*a, **k)
        log.append(torch.stack([ts.steps.double(), ts.loss.double()]))
        return ts
    return mock.patch.object(pl, "train_stage", rec)


def fires(log):
    """(fire ticks, loss at each fire) of a train_recorder log."""
    import torch
    if not log:
        return [], []
    a = torch.stack(log).cpu().numpy()
    steps = a[:, 0]
    hit = np.flatnonzero(np.diff(np.concatenate([[0.0], steps])) > 0)
    return hit.tolist(), a[hit, 1].tolist()


def close_rows(tag, got, want, tol):
    """Float arrays card vs CPU: |diff| <= tol x (1 + |cpu|); returns the
    max |diff|."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want)
    check(got.shape == want.shape and bool((d <= tol * (1 + np.abs(want)))
                                           .all()),
          f"[{tag}] max |card - cpu| {float(d.max()) if d.size else 0}")
    return float(d.max()) if d.size else 0.0


def golden_small_stream(seed=0, n_nodes=32, n_edges=100, d_in=8):
    """tests/test_delta_gating.py's and test_train_plane.py's stream."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n_nodes, n_edges),
                      rng.integers(0, n_nodes, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=d_in).astype(np.float32)
             for v in range(n_nodes)}
    return edges, feats


def tiny_waves(feats, n_waves=6, scale=2e-4, seed=7):
    """test_delta_gating._tiny_update_waves."""
    rng = np.random.default_rng(seed)
    cur = {v: np.asarray(f, np.float32).copy() for v, f in feats.items()}
    waves = []
    for _ in range(n_waves):
        events = []
        for v in sorted(cur):
            delta = rng.normal(size=len(cur[v])).astype(np.float32)
            delta *= scale / max(float(np.linalg.norm(delta)), 1e-12)
            cur[v] = cur[v] + delta
            events.append((v, cur[v].copy()))
        waves.append(events)
    return waves


def stats_row(stats):
    from repro_torch.core.tick import SCALAR_FIELDS
    return [[int(getattr(s, f)) for f in SCALAR_FIELDS] + s.busy.tolist()
            for s in stats]


def gate_golden_run(device, driver, backend):
    """The update-wave stream at golden_eps: per-call integer stats,
    metrics, sink, flags."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    edges, feats = golden_small_stream()
    pipe = D3Pipeline(GraphSAGE((8, 12, 12), seed=SEED), PipelineConfig(
        n_parts=4, node_cap=32, edge_cap=128, repl_cap=128, feat_cap=128,
        edge_tick_cap=32, max_nodes=32, delivery_backend=backend,
        delta_eps=GATE["golden_eps"],
        window=win.WindowConfig(kind=win.STREAMING)), device=device)
    rec = []
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    if driver == "tick":
        for e, f in zip(e_chunks, f_chunks):
            rec.append(stats_row(pipe.tick(e, f)))
        pipe.flush(max_ticks=96)
        for w in tiny_waves(feats):
            rec.append(stats_row(pipe.tick(feats=w)))
        pipe.flush(max_ticks=96)
    else:
        rec.append(stats_row(pipe.run_super_tick(
            e_chunks, f_chunks, T=len(e_chunks))[0]))
        pipe.flush_super(max_ticks=96, T=4)
        for w in tiny_waves(feats):
            rec.append(stats_row(pipe.run_super_tick(feat_chunks=[w],
                                                     T=1)[0]))
        pipe.flush_super(max_ticks=96, T=4)
    m = {k: v for k, v in vars(pipe.metrics).items() if isinstance(v, int)}
    return rec, m, pipe.sink.cpu().numpy(), pipe.sink_seen.cpu().numpy()


def phase_gate_parity(device):
    """[gate-parity]: the gated update-wave stream, card against CPU, both
    drivers x both backends; the coalescer launches kernel A."""
    import torch
    t0 = time.perf_counter()
    worst = 0.0
    for driver in ("tick", "super"):
        for backend in ("kernel", "scatter"):
            with SiteLaunches() as sites:
                got = gate_golden_run(device, driver, backend)
            want = gate_golden_run(torch.device("cpu"), driver, backend)
            check(got[0] == want[0] and got[1] == want[1],
                  f"[gate-parity] {driver}/{backend}: integer stats differ, "
                  f"card {got[1]} vs CPU {want[1]}")
            check(np.array_equal(got[3], want[3]),
                  f"[gate-parity] {driver}/{backend}: sink flags differ")
            check(got[1]["suppressed"] > 0,
                  f"[gate-parity] {driver}/{backend}: nothing suppressed")
            worst = max(worst, close_rows("gate-parity", got[2], want[2],
                                          PARITY_TOL))
            coal = sites.counts["add_rows < coalesce_msg_batch"]
            if backend == "kernel" and device.type == "cuda":
                check(coal > 0, "[gate-parity] the coalescer never "
                      f"launched kernel A: {dict(sites.counts)}")
            print(f"[gate-parity] {driver} driver, {backend} backend: card "
                  f"= CPU on {len(got[0])} calls of integer stats (RMIs "
                  f"{got[1]['reduce_msgs']}, suppressed "
                  f"{got[1]['suppressed']}, ticks {got[1]['ticks']}); "
                  f"kernel A in the coalescer {coal} launches")
    print(f"[gate-parity] sink max |card - cpu| {worst:.3e} (tolerance "
          f"{PARITY_TOL} x (1 + |cpu|)); {time.perf_counter() - t0:.1f}s")


def train_golden_run(device, driver, backend, compression=False):
    """tests/test_train_plane.py's online-learning run (sgd, lr 0.1, a
    fire at 4, five label passes) through a TrainSession. Returns (fire
    ticks, losses at them, train_stats, last_grad leaves)."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.serve.train_session import TrainSession
    edges, feats = golden_small_stream()
    labels = {v: (v * 7 + 3) % 4 for v in range(32)}
    pipe = D3Pipeline(
        GraphSAGE((8, 16, 16), seed=SEED, n_classes=4), PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=32, train_cap=64,
            delivery_backend=backend,
            window=win.WindowConfig(kind=win.STREAMING)),
        train=TrainConfig(optimizer=sgd(), lr=0.1, batch_threshold=4,
                          compression=compression, topk_frac=0.5),
        device=device)
    sess = TrainSession(pipe, driver=driver, super_ticks=4)
    log = []
    with train_recorder(log):
        e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
        sess.observe_labels(labels)
        if driver == "tick":
            for e, f in zip(e_chunks, f_chunks):
                sess.advance(e, f)
        else:
            sess.advance_super(e_chunks, f_chunks)
        sess.flush()
        for _ in range(5):
            sess.observe_labels(labels)
            sess.flush()
    ticks, losses = fires(log)
    grads = [g.cpu().numpy() for g in tree_leaves(
        pipe.train_state.last_grad)]
    return ticks, losses, sess.train_stats(), grads


def phase_train_parity(device):
    """[train-parity]: the online-learning stream, card against CPU, both
    drivers x both backends (and the compressed path once): steps and
    fire ticks exact, losses and last_grad within PARITY_TOL."""
    import torch
    t0 = time.perf_counter()
    worst = 0.0
    for driver, backend, comp in (("tick", "kernel", False),
                                  ("tick", "scatter", False),
                                  ("super", "kernel", False),
                                  ("super", "scatter", False),
                                  ("super", "kernel", True)):
        with SiteLaunches() as sites:
            got = train_golden_run(device, driver, backend, comp)
        want = train_golden_run(torch.device("cpu"), driver, backend, comp)
        tag = f"{driver}/{backend}{'/int8' if comp else ''}"
        check(got[0] == want[0] and got[2]["steps"] == want[2]["steps"],
              f"[train-parity] {tag}: fire ticks differ, card {got[0]} vs "
              f"CPU {want[0]}")
        check(got[2]["steps"] > 0 and got[1][-1] < got[1][0],
              f"[train-parity] {tag}: the loss did not fall: {got[1]}")
        # compressed: a top-k threshold or an int8 rounding can flip on
        # f32 sums in another order, so losses and grads are held to
        # TRAIN_LOSS_TOL there
        tol = TRAIN_LOSS_TOL if comp else PARITY_TOL
        err = close_rows("train-parity", got[1], want[1], tol)
        for a, b in zip(got[3], want[3]):
            err = max(err, close_rows("train-parity", a, b, tol))
        if not comp:
            worst = max(worst, err)
        fold = {k: v for k, v in sites.counts.items()
                if k.endswith(("edge_fold", "backward_layer_routed"))}
        if backend == "kernel" and device.type == "cuda":
            check(fold.get("add_rows < edge_fold", 0) > 0
                  and fold.get("deliver_add < backward_layer_routed", 0) > 0
                  and fold.get("deliver_set < backward_layer_routed", 0) > 0,
                  f"[train-parity] {tag}: the backward's folds never "
                  f"launched kernel A: {dict(sites.counts)}")
        print(f"[train-parity] {tag}: card = CPU on {got[2]['steps']} steps "
              f"at ticks {got[0]}; loss {got[1][0]:.6f} -> {got[1][-1]:.6f};"
              f" max |card - cpu| {err:.3e} (tolerance {tol} x (1 + |cpu|))"
              f"; kernel A in the backward {fold}")
    print(f"[train-parity] uncompressed runs: losses and last_grad max "
          f"|card - cpu| {worst:.3e} (tolerance {PARITY_TOL} x (1 + |cpu|)); "
          f"{time.perf_counter() - t0:.1f}s")


def gate_waves(gen, feats, vids, g=GATE):
    """[gate-full]'s update waves over `vids` (ingested vertices). Returns
    (waves as event lists, final features, the first wave's delta norms)."""
    cur = dict(feats)
    waves, first = [], None
    lo, hi = np.log(g["norm_lo"]), np.log(g["norm_hi"])
    for _ in range(g["waves"]):
        pick = gen.choice(vids, g["wave_vids"], replace=False)
        norms = np.exp(gen.uniform(lo, hi, len(pick)))
        d = gen.normal(size=(len(pick), len(cur[pick[0]])))
        d *= (norms / np.linalg.norm(d, axis=1))[:, None]
        events = []
        for v, dv in zip(pick, d.astype(np.float32)):
            cur[int(v)] = (cur[int(v)] + dv).astype(np.float32)
            events.append((int(v), cur[int(v)]))
        waves.append(events)
        first = norms if first is None else first
    return waves, cur, first


def sage_bound(model, eps):
    """The Lipschitz chain bound of a 2-layer SAGE stack
    (tests/test_delta_gating.py:269-275), spectral norms in float64."""
    import torch
    sn = lambda w: float(torch.linalg.matrix_norm(w.detach().double(),
                                                   ord=2))
    l0, l1 = model.layers
    e1 = sn(l0.w_neigh.w) * eps
    return sn(l1.w_self.w) * e1 + sn(l1.w_neigh.w) * (e1 + eps)


def l2_error(emb, ref):
    """max over vids of ||emb[v] - ref[v]||_2 (ref float64 rows)."""
    vids = sorted(emb)
    got = np.stack([emb[v] for v in vids]).astype(np.float64)
    return float(np.linalg.norm(got - ref[vids], axis=1).max())


def phase_gate_full(device, exact, edges, feats, full=FULL, g=GATE):
    """[gate-full]: phase 4's pipeline (delta_eps = 0) and the same stream
    at delta_eps = eps, then the same update waves through both."""
    import torch
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    t0 = time.perf_counter()
    gen = np.random.default_rng(SEED + 7)
    ingested = np.unique(edges)
    waves, final, norms = gate_waves(gen, feats, ingested, g)
    eps = float(np.median(norms))
    gated, secs, _ = stream_pipeline(full, "kernel", device, edges, feats,
                                     delta_eps=eps)
    before = {id(p): (p.metrics.reduce_msgs, p.metrics.suppressed)
              for p in (gated, exact)}
    ticks0 = gated.metrics.ticks
    wall = {"gated": [], "exact": []}
    cuda = device.type == "cuda"
    with SiteLaunches() as sites:
        for w in waves:
            for name, p in (("gated", gated), ("exact", exact)):
                if cuda:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                p.run_super_tick(feat_chunks=[w], T=1)
                p.flush_super(max_ticks=64, T=full["super_ticks"])
                if cuda:
                    torch.cuda.synchronize()
                wall[name].append(time.perf_counter() - t1)
    d = {name: (p.metrics.reduce_msgs - before[id(p)][0],
                p.metrics.suppressed - before[id(p)][1])
         for name, p in (("gated", gated), ("exact", exact))}
    check(d["gated"][1] > 0, f"[gate-full] nothing suppressed: {d}")
    check(d["exact"][1] == 0 and exact.metrics.suppressed == 0,
          f"[gate-full] the eps = 0 run suppressed: {d}")
    check(d["gated"][0] + d["gated"][1] <= d["exact"][0],
          f"[gate-full] gated RMIs + suppressed > the exact run's: {d}")
    coal = sites.counts["add_rows < coalesce_msg_batch"]
    n_ticks = gated.metrics.ticks - ticks0
    if cuda:
        check(coal > 0, f"[gate-full] the coalescer never launched kernel "
              f"A: {dict(sites.counts)}")
    # the float64 oracle on the final snapshot; the Lipschitz bound
    model64 = copy.deepcopy(exact.model).double()
    g64, _ = build_snapshot(edges, final, full["dims"][0], full["n_nodes"],
                            device, dtype=torch.float64)
    ref = oracle_embeddings(model64, g64).cpu().numpy()
    del model64, g64
    bound = sage_bound(exact.model, eps)
    e_gated = l2_error(gated.embeddings(), ref)
    e_exact = l2_error(exact.embeddings(), ref)
    check(e_gated <= bound * 1.01 + e_exact,
          f"[gate-full] gated sink error {e_gated:.3e} > bound {bound:.3e} "
          f"x 1.01 + the exact run's {e_exact:.3e}")
    wave_supp = float(np.mean(norms <= eps))
    print(f"[gate-full] FULL streamed at delta_eps = {eps:.6e} (the median "
          f"layer-0 ||dx|| of wave 1; {wave_supp:.3f} of its deltas at or "
          f"below it) in {secs:.3f}s = {full['n_edges'] / secs:.1f} "
          f"edges/s; the eps = 0 run is phase 4's pipeline")
    print(f"[gate-full] {g['waves']} waves of {g['wave_vids']} feature "
          f"updates (||dx|| log-uniform in [{g['norm_lo']}, {g['norm_hi']}])"
          f", each one tick + flush: gated RMIs {d['gated'][0]}, suppressed"
          f" {d['gated'][1]}; exact RMIs {d['exact'][0]}; messages saved "
          f"{d['exact'][0] - d['gated'][0]} "
          f"({(d['exact'][0] - d['gated'][0]) / max(d['exact'][0], 1):.3f})"
          f"; whole runs: gated RMIs {gated.metrics.reduce_msgs} + "
          f"suppressed {gated.metrics.suppressed}, exact "
          f"{exact.metrics.reduce_msgs}")
    print(f"[gate-full] wave wall s (tick + flush): gated "
          f"{[round(x, 4) for x in wall['gated']]}, exact "
          f"{[round(x, 4) for x in wall['exact']]}; sink vs float64 oracle, "
          f"max L2 error: gated {e_gated:.6e}, exact {e_exact:.6e}, "
          f"Lipschitz bound {bound:.6e}; kernel A launches by call site "
          f"over the waves (both runs; the gated one {n_ticks} ticks) "
          f"{dict(sites.counts)}; "
          f"{time.perf_counter() - t0:.1f}s")
    del gated
    free_cuda()
    return {"eps": eps, "coalescer_launches": coal,
            "wave_ticks": n_ticks}


def class_labels(feats, n_classes, d_in):
    """The argmax of a seeded projection of each vertex's features."""
    proj = np.random.default_rng(SEED + 11).normal(size=(d_in, n_classes))
    vids = sorted(feats)
    x = np.stack([feats[v] for v in vids])
    return dict(zip(vids, (x @ proj).argmax(1).tolist()))


def train_pipeline(full, device, backend, train, train_cap):
    """FULL's configuration with TRAIN's head and the training plane."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                         delivery_backend=backend, train_cap=train_cap,
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4))
    model = GraphSAGE(full["dims"], seed=SEED, n_classes=TRAIN["n_classes"])
    return D3Pipeline(model, cfg, train=train, device=device)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_train_exact(device, edges, feats, full=FULL, t=TRAIN):
    """[train-full] (a): lr 0, a fire at 1 active master; stream, flush,
    one label tick of t["labels"] labels on materialized masters. Returns
    the pipeline (its topology feeds the call-site timings)."""
    import torch
    from repro_torch.core.oracle import build_snapshot
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.optim import sgd
    t0 = time.perf_counter()
    pipe = train_pipeline(full, device, "kernel", TrainConfig(
        optimizer=sgd(), lr=0.0, batch_threshold=1), t["labels"])
    init = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    log = []
    with train_recorder(log):
        pipe.run_stream_super(edges, feats, tick_edges=full["tick_edges"],
                              super_ticks=full["super_ticks"])
        pipe.flush_super(max_ticks=256, T=full["super_ticks"])
        seen = np.asarray(sorted(pipe.embeddings()))
        gen = np.random.default_rng(SEED + 12)
        vids = np.sort(gen.choice(seen, t["labels"], replace=False))
        gold = class_labels(feats, t["n_classes"], full["dims"][0])
        pipe.run_super_tick(T=1, label_chunks=[[(int(v), gold[int(v)])
                                                for v in vids]])
    ticks, losses = fires(log)
    st = pipe.train_stats()
    check(st["steps"] == 1 and len(ticks) == 1,
          f"[train-full] (a) fired {st['steps']} times at ticks {ticks}")
    # float64 torch.autograd of the static model over the same snapshot
    model64 = copy.deepcopy(pipe.model).double()
    for p in model64.parameters():
        p.requires_grad_(True)
    g64, _ = build_snapshot(edges, feats, full["dims"][0], full["n_nodes"],
                            device, dtype=torch.float64)
    y = torch.zeros(full["n_nodes"], dtype=torch.int64, device=device)
    mask = torch.zeros(full["n_nodes"], dtype=torch.bool, device=device)
    idx = torch.as_tensor(vids, device=device)
    y[idx] = torch.as_tensor([gold[int(v)] for v in vids], device=device)
    mask[idx] = True
    with torch.enable_grad():
        loss64 = model64.loss(g64, y, mask)
        names = [n for n, _ in model64.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(
            loss64, list(model64.parameters()))))
    del g64
    ts = pipe.train_state
    errs = {"loss": rel_l2(np.float64(st["loss"]), float(loss64.detach()))}
    for i in range(len(pipe.layers)):
        for key, mod in (("self", "w_self"), ("neigh", "w_neigh")):
            for leaf, val in ts.last_grad[f"l{i}"][key].items():
                errs[f"layers.{i}.{mod}.{leaf}"] = rel_l2(
                    val.double().cpu().numpy(),
                    grads[f"layers.{i}.{mod}.{leaf}"].cpu().numpy())
    for leaf, val in ts.last_grad["head"].items():
        errs[f"head.{leaf}"] = rel_l2(val.double().cpu().numpy(),
                                      grads[f"head.{leaf}"].cpu().numpy())
    worst = max(errs.values())
    check(worst <= TRAIN_TOL, f"[train-full] (a) relative L2 vs float64 "
          f"autograd {errs} > {TRAIN_TOL}")
    now = pipe.model.state_dict()
    check(all(torch.equal(now[k], init[k]) for k in init),
          "[train-full] (a) lr 0 moved the live parameters")
    print(f"[train-full] (a) {t['n_classes']} classes, lr 0: stream + flush "
          f"+ one tick of {t['labels']} labels; fired once (tick "
          f"{ticks[0]}), loss {st['loss']:.6f} vs float64 autograd "
          f"{float(loss64):.6f}; last_grad relative L2 vs float64 autograd "
          f"by leaf {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} "
          f"(tolerance {TRAIN_TOL}); live params bit-unchanged; "
          f"{time.perf_counter() - t0:.1f}s")
    del model64, grads
    return pipe


def online_run(full, device, backend, edges, feats, gold, t=TRAIN,
               profile=False):
    """[train-full] (b): TrainSession(driver="super") over the stream,
    each launch's new vertices labeled for the next launch. Returns a
    dict of measurements."""
    import torch
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.optim import adam
    from repro_torch.serve.train_session import TrainSession
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    pipe = train_pipeline(full, device, backend, TrainConfig(
        optimizer=adam(), lr=t["lr"], batch_threshold=t["batch_threshold"],
        window=t["window"], compression=True, int8=True,
        topk_frac=t["topk_frac"]), t["train_cap"])
    T, te = full["super_ticks"], full["tick_edges"]
    sess = TrainSession(pipe, driver="super", super_ticks=T)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, te)
    log, syncs, wall = [], Counter(), 0.0
    with train_recorder(log), SiteLaunches() as sites:
        for lo in range(0, len(e_chunks), T):
            t1 = time.perf_counter()
            _, s = counted_syncs(lambda: sess.advance_super(
                e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T), cuda)
            if cuda:
                torch.cuda.synchronize()
            wall += time.perf_counter() - t1
            syncs.update(s)
            new = [v for f in f_chunks[lo:lo + T] for v, _ in f]
            sess.observe_labels([(v, gold[v]) for v in new])
        t1 = time.perf_counter()
        _, s = counted_syncs(lambda: sess.flush(max_ticks=512), cuda)
        if cuda:
            torch.cuda.synchronize()
        wall += time.perf_counter() - t1
        syncs.update(s)
    ticks, losses = fires(log)
    out = dict(ticks=ticks, losses=losses, wall=wall, syncs=syncs,
               n_super=pipe.metrics.ticks // T, stats=sess.train_stats(),
               sites=dict(sites.counts), n_ticks=pipe.metrics.ticks,
               peak=torch.cuda.max_memory_allocated() if cuda else 0,
               host=pipe.metrics.host_seconds)
    if profile and cuda:
        sess.observe_labels(list(gold.items())[:T * t["train_cap"]])
        out["profile"] = stage_profile(lambda: sess.advance_super(T=T),
                                       "core/train_plane.py")
    del pipe, sess
    free_cuda()
    return out


def stage_profile(fn, prefix):
    """fn once under torch.profiler with stacks: (wall ms, device busy ms,
    {call site: (device ms, launches)} for sites under `prefix`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    verbose = torch._C._profiler._ExperimentalConfig(verbose=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, experimental_config=verbose) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_site, n_site, _ = device_ms_by_site(prof)
    busy = sum(k.duration for e in prof.events()
               for k in getattr(e, "kernels", [])
               if k.name != "Command Buffer Full") / 1e3
    return wall * 1e3, busy, {s: (ms, n_site[s]) for s, ms in
                              by_site.items() if s.startswith(prefix)}


def phase_train_online(device, edges, feats, baseline, full=FULL, t=TRAIN):
    """[train-full] (b): the online learning run on the kernel backend
    (profiled once more after), then the same stream on the scatter
    backend."""
    t0 = time.perf_counter()
    gold = class_labels(feats, t["n_classes"], full["dims"][0])
    k = online_run(full, device, "kernel", edges, feats, gold, t,
                   profile=True)
    s = online_run(full, device, "scatter", edges, feats, gold, t)
    check(k["stats"]["steps"] > 0 and len(k["losses"]) > 1,
          f"[train-full] (b) fired {k['stats']['steps']} times")
    check(k["losses"][-1] < k["losses"][0],
          f"[train-full] (b) the loss did not fall: {k['losses'][0]} -> "
          f"{k['losses'][-1]}")
    check(k["ticks"] == s["ticks"],
          f"[train-full] (b) fire ticks differ, kernel vs scatter: "
          f"{k['ticks'][:12]} vs {s['ticks'][:12]}")
    lk, ls = np.asarray(k["losses"]), np.asarray(s["losses"])
    loss_err = float((np.abs(lk - ls) / np.abs(ls)).max())
    check(loss_err <= TRAIN_LOSS_TOL, f"[train-full] (b) losses kernel vs "
          f"scatter: max relative {loss_err:.3e} > {TRAIN_LOSS_TOL}")
    per = {key: v / k["n_super"] for key, v in k["syncs"].items()}
    if device.type == "cuda":
        per4 = {key: v / baseline["n_super"]
                for key, v in baseline["sync_sites"].items()}
        check(per == per4, f"[train-full] (b) synchronizing calls a "
              f"super-tick {per}, phase 4 {per4}")
        check(k["sites"].get("add_rows < edge_fold", 0) > 0
              and k["sites"].get("deliver_add < backward_layer_routed", 0)
              > 0 and k["sites"].get("deliver_set < backward_layer_routed",
                                     0) > 0,
              f"[train-full] (b) kernel A never launched in the backward: "
              f"{k['sites']}")
    n = k["n_ticks"]
    print(f"[train-full] (b) TrainSession(driver=super, T="
          f"{full['super_ticks']}), Adam lr {t['lr']}, int8 top-k "
          f"{t['topk_frac']} compression, train_cap {t['train_cap']}, window "
          f"{t['window']}, fire at {t['batch_threshold']}: {k['stats']['steps']}"
          f" steps over {n} ticks, loss {k['losses'][0]:.6f} (first fire, "
          f"tick {k['ticks'][0]}) -> {k['losses'][-1]:.6f} (last, tick "
          f"{k['ticks'][-1]}); scatter backend: the same {len(s['ticks'])} "
          f"fire ticks, losses within {loss_err:.3e} relative (tolerance "
          f"{TRAIN_LOSS_TOL})")
    print(f"[train-full] (b) {full['n_edges']} edges in {k['wall']:.3f}s = "
          f"{full['n_edges'] / k['wall']:.1f} edges/s with training (phase "
          f"4 without, this call: {baseline['edges_per_s']:.1f}); host "
          f"staging {k['host']:.3f}s; peak memory {k['peak']} bytes "
          f"({k['peak'] / 2**30:.2f} GiB); scatter backend "
          f"{full['n_edges'] / s['wall']:.1f} edges/s; synchronizing calls "
          f"a super-tick {per} (phase 4: {baseline['sync_sites']} over "
          f"{baseline['n_super']})")
    print(f"[train-full] (b) kernel A launches by call site over the run "
          f"({n} ticks): {k['sites']}")
    if "profile" in k:
        wall, busy, sites = k["profile"]
        tot = sum(ms for ms, _ in sites.values())
        print(f"[train-full] (b) one more launch of {full['super_ticks']} "
              f"ticks (labels only) under torch.profiler: wall {wall:.3f} "
              f"ms, device busy {busy:.3f} ms, the train stage "
              f"(core/train_plane.py) {tot:.3f} ms in "
              f"{sum(c for _, c in sites.values())} launches"
              + ("" if busy else " (not measured: no device events)"))
        for site, (ms, c) in sorted(sites.items(),
                                    key=lambda kv: -kv[1][0])[:16]:
            print(f"[train-full] {ms:9.3f} ms  {c:6d} x  {site[:110]}")
    print(f"[train-full] (b) {time.perf_counter() - t0:.1f}s")
    return {"launches_per_tick": {key: v / n for key, v in
                                  k["sites"].items()}}


def coalesce_layout(keys, valid, C):
    """The coalescer's record -> run mapping (events.coalesce_msg_batch):
    idx [C] run index of each record, C for invalid ones."""
    import torch
    past = torch.iinfo(torch.int64).max
    key = torch.where(valid, keys, torch.full_like(keys, past))
    key_s, order = torch.sort(key, stable=True)
    head = torch.ones_like(valid)
    head[1:] = key_s[1:] != key_s[:-1]
    run = torch.cumsum(head, 0) - 1
    idx = torch.empty_like(run)
    idx[order] = torch.where(valid[order], run, torch.full_like(run, C))
    return idx


def time_call_site(name, idx, n, d, gen, errs, base=False, cnt=False):
    """Kernel A at one call site's layout: `idx` [C] the rows (n = drop),
    random f32 rows of width d; beside its plain version, zeros (or the
    base) + index_add_ of the live rows, and its bound from bytes."""
    import torch
    from repro_torch.kernels.segment_reduce import ops, ref
    dev = idx.device
    C = idx.shape[0]
    vec = torch.randn(C, d, device=dev, generator=gen)
    cv = torch.ones(C, device=dev) if cnt else None
    b = torch.randn(n, d, device=dev, generator=gen) if base else None
    order, row_ptr = ops.sort_runs(idx, n)
    args = (vec, row_ptr, order, cv, b, None, "add")
    got, want = ops.deliver_rows(*args), ref.deliver_rows_ref(*args)
    sync(got[0])
    check(torch.equal(got[2], want[2]) and (not cnt or torch.equal(
        got[1], want[1])), f"{name}: counts or flags differ")
    absum = ref.deliver_rows_ref(vec.abs(), row_ptr, order, None,
                                 None if b is None else b.abs(), None,
                                 "add")[0]
    errs["segment_sum_rows"] = max(errs["segment_sum_rows"],
                                   kernel_a_sum_check(got[0], want[0], absum,
                                                      name))
    del got, want, absum
    ms = time_ms(lambda: ops.deliver_rows(*args))
    plain = time_ms(lambda: ref.deliver_rows_ref(*args))
    live_m = (idx >= 0) & (idx < n)
    live = int(live_m.sum())
    li, lv = idx[live_m], vec[live_m]
    dst = b if base else torch.zeros(n, d, device=dev)
    lib = time_ms(lambda: dst.clone().index_add_(0, li, lv) if base else
                  torch.zeros(n, d, device=dev).index_add_(0, li, lv))
    n_bytes = (live * (d * 4 + 8) + (n + 1) * 8 + n * d * 4 + n
               + (n * d * 4 if base else 0) + (live * 4 + n * 4 if cnt
                                              else 0))
    bound = bound_ms(n_bytes, live * d + (n * d if base else 0))
    print(f"[time] {name}: records {C} (live {live}) rows {n} d {d}: "
          f"{ms:.4f} ms; bound {bound:.4f} ms (bytes: {n_bytes}; "
          f"{bound / ms:.3f} of it reached); plain {plain:.4f} ms; "
          f"{'the base copy' if base else 'zeros'} + index_add_ of the live "
          f"rows {lib:.4f} ms")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib, "records": C,
            "live": live, "rows": n, "d": d}


def phase_train_time(pipe, errs, launches_per_tick, gate_info):
    """Rows 1b and 1c: kernel A at the backward's edge fold (d = 602 and
    64), its replica fold (d = 602) and the gated tick's coalescer (the
    layer-0 RMI lane), on [train-full] (a)'s final topology."""
    import torch
    t0 = time.perf_counter()
    topo, dev = pipe.topo, pipe.device
    P, E = topo.e_src_slot.shape
    N = topo.is_master.shape[1]
    PN = P * N
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pp = torch.arange(P, device=dev)[:, None]
    src = (pp * N + topo.e_src_slot).reshape(-1)
    e_live = topo.e_valid.reshape(-1)
    fold_idx = torch.where(e_live, src, PN)
    r_midx = (pp * N + topo.r_master_slot).reshape(-1)
    r_idx = torch.where(topo.r_valid.reshape(-1), r_midx, PN)
    keys = torch.cat([torch.zeros(pipe.cfg.edge_tick_cap, dtype=torch.int64,
                                  device=dev),
                      (topo.e_dst_mpart * N + topo.e_dst_mslot).reshape(-1)])
    kvalid = torch.cat([torch.zeros(pipe.cfg.edge_tick_cap, dtype=torch.bool,
                                    device=dev), e_live])
    C = keys.shape[0]
    coal_idx = coalesce_layout(keys, kvalid, C)
    rows = {
        "1b_backward_edge_fold_d602": time_call_site(
            "segment_deliver add, backward edge fold (d = 602, layer 0)",
            fold_idx, PN, 602, gen, errs),
        "1b_backward_edge_fold_d64": time_call_site(
            "segment_deliver add, backward edge fold (d = 64, layer 1)",
            fold_idx, PN, 64, gen, errs),
        "1b_backward_replica_fold_d602": time_call_site(
            "segment_deliver add, backward replica fold (d = 602, base)",
            r_idx, PN, 602, gen, errs, base=True),
        "1c_coalescer_d602": time_call_site(
            "segment_deliver add, coalescer of the layer-0 RMI lane "
            "(d = 602, counts)", coal_idx, C, 602, gen, errs, cnt=True)}
    per = launches_per_tick
    rows["1b_backward_edge_fold_d602"]["launches_per_tick"] = \
        per.get("add_rows < edge_fold", 0.0)
    rows["1b_backward_edge_fold_d64"]["launches_per_tick"] = \
        per.get("add_rows < edge_fold", 0.0)
    rows["1b_backward_replica_fold_d602"]["launches_per_tick"] = \
        per.get("deliver_add < backward_layer_routed", 0.0)
    rows["1c_coalescer_d602"]["launches_per_tick"] = (
        gate_info["coalescer_launches"] / max(gate_info["wave_ticks"], 1))
    print(f"[time] call-site timings {time.perf_counter() - t0:.1f}s "
          "(launches a tick: the edge fold's count covers both layers)")
    free_cuda()
    return rows


# ------------------------------------------------------------- mesh phases
# ------------------------------------------ telemetry and checkpoint phases
# [ckpt-full]: phase 4's configuration with the query plane on (QUERY's
# caps), cut after `cut_launches` super-ticks of the stream with
# `consistent` consistent EMBED queries submitted in the launch before
# the cut (held on the device at the cut)
CKPT = dict(cut_launches=6, consistent=64)
TEL_GAUGES = ("occ_bc_defer", "occ_rmi_defer", "route_peak",
              "outbox_part_peak")


def gauge_free(rows):
    """stats_row rows without the four telemetry gauges."""
    from repro_torch.core.tick import SCALAR_FIELDS
    keep = [i for i, f in enumerate(SCALAR_FIELDS) if f not in TEL_GAUGES]
    n = len(SCALAR_FIELDS)
    return [[[r[i] for i in keep] + r[n:] for r in call] for call in rows]


def state_leaves(pipe):
    """Every tensor of the pipeline's checkpoint cut, in the checkpoint's
    order (ft/checkpoint.py)."""
    from repro_torch.ft import checkpoint as ck
    return [l for _, l in ck.tree_flatten(ck.pipeline_tree(pipe))]


def states_equal(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and bool(torch_equal(x.cpu(), y.cpu()))
        for x, y in zip(la, lb))


def torch_equal(x, y):
    import torch
    return torch.equal(x, y)


def trace_ints(pipe):
    """The trace's device columns and integer host columns."""
    from repro_torch.telemetry.trace import TRACE_DEVICE_COLS
    cols = pipe.trace.columns()
    return {c: cols[c] for c in TRACE_DEVICE_COLS + [
        "tick", "ticks", "amortized", "wire_bytes", "edges_in", "feats_in",
        "queries_in", "labels_in"]}


def tel_golden_run(device, driver, telemetry=True, **cfg_kw):
    """The golden small stream (32 nodes, dims (8, 12, 12), 4 parts,
    session(3), query_cap 8) with the golden query mix in its second
    tick, then 8 empty ticks. Returns (pipeline, per-call stats rows)."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    edges, feats = golden_small_stream()
    kw = dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
              feat_cap=128, edge_tick_cap=32, max_nodes=32, query_cap=8,
              window=win.WindowConfig(kind=win.SESSION, interval=3))
    kw.update(cfg_kw)
    pipe = D3Pipeline(GraphSAGE((8, 12, 12), seed=SEED),
                      PipelineConfig(**kw, telemetry=telemetry),
                      device=device)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    q = golden_query_mix(edges)
    if driver == "tick":
        rows = [stats_row(pipe.tick(e, f, queries=q if i == 1 else None))
                for i, (e, f) in enumerate(zip(e_chunks, f_chunks))]
        rows += [stats_row(pipe.tick()) for _ in range(8)]
    else:
        rows = [stats_row(pipe.run_super_tick(
                    e_chunks, f_chunks, T=len(e_chunks),
                    query_chunks=[None, q])[0]),
                stats_row(pipe.run_super_tick(T=8)[0])]
    return pipe, rows


def phase_telemetry_parity(device):
    """The golden small stream with telemetry on, card (kernel backend)
    against the CPU, both drivers: every stat of every call and every
    integer trace column exactly equal; on the card, every stat other
    than the gauges, the sink and the state bit-equal to the run without
    telemetry; the advisor's recommendation equal, and its replay on the
    card drops nothing and gives the same sink."""
    import torch
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.telemetry.advisor import recommend, replay_ok
    from repro_torch.telemetry.trace import Trace
    cpu = torch.device("cpu")
    for driver in ("tick", "super"):
        ops.reset_launches()
        card, card_rows = tel_golden_run(device, driver)
        launches = dict(ops.LAUNCHES)
        host, host_rows = tel_golden_run(cpu, driver)
        check(card_rows == host_rows, f"[telemetry-parity] {driver}: "
                                      "TickStats differ, card vs CPU")
        a, b = trace_ints(card), trace_ints(host)
        for c in a:
            check(np.array_equal(a[c], b[c]), f"[telemetry-parity] "
                  f"{driver}: trace column {c} differs, card vs CPU: "
                  f"{a[c].tolist()} vs {b[c].tolist()}")
        off, off_rows = tel_golden_run(device, driver, telemetry=False)
        check(gauge_free(off_rows) == gauge_free(card_rows),
              f"[telemetry-parity] {driver}: telemetry changed a stat")
        check(all(v == 0 for call in off_rows for r in call
                  for v in r[9:13]), "[telemetry-parity] gauges not zero "
                                     "with telemetry off")
        check(states_equal(card, off), f"[telemetry-parity] {driver}: "
              "telemetry changed the state or the sink")
        recs = recommend(Trace(card.trace.meta, card.trace.columns()))
        check(recs == recommend(Trace(host.trace.meta,
                                      host.trace.columns())),
              f"[telemetry-parity] {driver}: advisor differs, card vs CPU")
        caps = {k: v for k, v in recs["caps"].items()
                if v is not None or k in ("route_cap", "route_defer_cap")}
        replay, _ = tel_golden_run(device, driver, telemetry=False, **caps)
        got = replay_ok(replay)
        check(torch.equal(replay.sink, card.sink), f"[telemetry-parity] "
              f"{driver}: the replay's sink differs from the recorded run")
        if device.type == "cuda":
            check(all(v > 0 for v in launches.values()),
                  f"[telemetry-parity] a kernel never launched: {launches}")
        print(f"[telemetry-parity] driver {driver}: card = CPU on "
              f"{len(card.trace)} trace rows x {len(a)} integer columns and "
              f"{len(card_rows)} calls' stats (route_peak max "
              f"{int(a['route_peak'].max())}, outbox_part_peak max "
              f"{int(a['outbox_part_peak'].max())}, query_pending max "
              f"{int(a['query_pending'].max())}); telemetry off: every other "
              f"stat, the sink and the state bit-equal; advisor caps "
              f"{recs['caps']} (card = CPU), replay {got}, sink bit-equal; "
              f"launches {launches}")


def profiled_busy(full, device, edges, feats, telemetry, warm=3):
    """(device busy ms, wall ms) of one steady super-tick under
    torch.profiler after `warm` unprofiled ones of the stream."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                         telemetry=telemetry,
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4))
    pipe = D3Pipeline(GraphSAGE(full["dims"], seed=SEED), cfg, device=device)
    T = full["super_ticks"]
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, full["tick_edges"])
    for lo in range(0, warm * T, T):
        pipe.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T)
    lo = warm * T
    sync(torch.zeros((), device=device))
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T)
        sync(torch.zeros((), device=device))
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in prof.key_averages()
               if "CUDA" in str(e.device_type) and dev_us(e) > 0
               and e.key != "Command Buffer Full") / 1e3
    return busy, wall * 1e3


def phase_telemetry_full(device, baseline, full=FULL):
    """Phase 4's full-width stream with telemetry on (super-tick driver):
    edges/s beside phase 4's, the synchronizing calls a super-tick (must
    be phase 4's), one profiled super-tick's device busy with and without
    telemetry, the trace, the advisor's caps against FULL's, the cost
    model's fit on the trace and the saved .npz's size."""
    import shutil
    import tempfile
    import torch
    from repro_torch.telemetry.advisor import recommend
    from repro_torch.telemetry.cost_model import fit_cost_model
    from repro_torch.telemetry.trace import Trace, load_trace
    edges, feats = make_stream(full["n_nodes"], full["n_edges"],
                               full["dims"][0])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pipe, secs, sites = stream_pipeline(full, "kernel", device, edges, feats,
                                        telemetry=True)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    m = pipe.metrics
    T = full["super_ticks"]
    n_super = m.ticks // T
    n_syncs = sum(sites.values())
    base_syncs = sum(baseline["sync_sites"].values())
    eps = full["n_edges"] / secs
    print(f"[telemetry-full] caps {full['caps']} dims {full['dims']} "
          f"telemetry on, driver super(T={T}): {full['n_edges']} edges in "
          f"{secs:.3f}s = {eps:.1f} edges/s, {eps / baseline['edges_per_s']:.3f}"
          f" of phase 4's {baseline['edges_per_s']:.1f} in this run; ticks "
          f"{m.ticks}; peak memory {peak / 2**30:.2f} GiB")
    print(f"[telemetry-full] synchronizing CUDA calls {n_syncs} over "
          f"{n_super} super-ticks = {n_syncs / max(n_super, 1):.2f} a "
          f"super-tick at {dict(sites)} (phase 4: {base_syncs} over "
          f"{baseline['n_super']} = {base_syncs / max(baseline['n_super'], 1):.2f}"
          f" at {baseline['sync_sites']})")
    if cuda:
        check(n_syncs == n_super and n_syncs * baseline["n_super"]
              == base_syncs * n_super,
              "[telemetry-full] telemetry changed the syncs a super-tick: "
              f"{n_syncs} over {n_super} (phase 4: {base_syncs} over "
              f"{baseline['n_super']})")
    check(len(pipe.trace) == m.ticks, f"[telemetry-full] {len(pipe.trace)} "
          f"trace rows for {m.ticks} ticks")
    trace = Trace(pipe.trace.meta, pipe.trace.columns())
    cols = trace.columns
    check(int(cols["emitted_final"].sum()) == m.emitted_total
          and int(cols["dropped"].sum()) == m.dropped,
          "[telemetry-full] trace columns disagree with the metrics")
    recs = recommend(trace)
    print(f"[telemetry-full] trace {len(trace)} rows; outbox_part_peak max "
          f"{int(cols['outbox_part_peak'].max())}, outbox_demand max "
          f"{int(cols['outbox_demand'].max())}, dropped {int(cols['dropped'].sum())}, "
          f"edges_in max {int(cols['edges_in'].max())}, feats_in max "
          f"{int(cols['feats_in'].max())}; advisor caps {recs['caps']} "
          f"against FULL's outbox_cap (feat_cap) {full['caps']['feat_cap']}, "
          f"feat_cap {full['caps']['feat_cap']}, edge_tick_cap "
          f"{full['caps']['edge_tick_cap']}")
    cm = fit_cost_model(trace)
    rep = cm.report(trace)
    print(f"[telemetry-full] cost model on the trace (amortized rows, "
          f"super-tick wall / T): report {rep}; intercept "
          f"{cm.intercept:.6f} s; s/row {cm.coef}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace-")
    try:
        path = Path(tmp) / "trace.npz"
        pipe.save_trace(path)
        size = path.stat().st_size
        back = load_trace(path)
        check(len(back) == len(trace), "[telemetry-full] trace round trip")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[telemetry-full] saved trace {size} bytes "
          f"({size / max(len(trace), 1):.1f} bytes a row)")
    del pipe
    free_cuda()
    busy = {t: profiled_busy(full, device, edges, feats, t)
            for t in (False, True)}
    if cuda and not all(b for b, _ in busy.values()):
        print("[telemetry-full] profiled device busy: not measured (no "
              "device events in the profile)")
    else:
        print(f"[telemetry-full] one profiled super-tick (stream ticks "
              f"{3 * T}..{4 * T - 1}): device busy {busy[True][0]:.3f} ms "
              f"with telemetry, {busy[False][0]:.3f} ms without "
              f"({busy[True][0] - busy[False][0]:+.3f} ms); wall "
              f"{busy[True][1]:.3f} / {busy[False][1]:.3f} ms")


def ckpt_pipeline(device, full, q, telemetry=False):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                         query_cap=q["query_cap"],
                         query_tick_cap=q["query_tick_cap"],
                         telemetry=telemetry,
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4))
    return D3Pipeline(GraphSAGE(full["dims"], seed=SEED), cfg, device=device)


def finish_rows(pipe, e_chunks, f_chunks, lo, T):
    """Stream the chunks from `lo` on, T ticks a launch, then flush_super:
    every call's stats rows."""
    rows = []
    run = pipe.run_super_tick

    def recorded(*a, **k):
        stats, quiet = run(*a, **k)
        rows.append(stats_row(stats))
        return stats, quiet

    pipe.run_super_tick = recorded
    try:
        for i in range(lo, len(e_chunks), T):
            pipe.run_super_tick(e_chunks[i:i + T], f_chunks[i:i + T], T=T)
        pipe.flush_super(max_ticks=256, T=T)
    finally:
        del pipe.run_super_tick
    return rows


def phase_ckpt_parity(device):
    """On the card at the golden small size: cut mid-stream (windows
    pending, consistent queries held), save with both write modes,
    restore into fresh pipelines and continue: bit-equal to the
    uninterrupted run on every stat, answer, float of the sink and of the
    state. The card's checkpoint also restores on the CPU. Then the torn
    checkpoint drill on the card."""
    import shutil
    import tempfile
    import torch
    from repro_torch.ft import chaos
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.kernels.segment_reduce import ops
    small = dict(n_nodes=32, dims=(8, 12, 12), caps=dict(
        n_parts=4, node_cap=32, edge_cap=128, repl_cap=128, feat_cap=128,
        edge_tick_cap=32))
    q = dict(query_cap=8, query_tick_cap=None)
    edges, feats = golden_small_stream()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt-"))
    try:
        ref = ckpt_pipeline(device, small, q)
        e_chunks, f_chunks = ref.chunk_stream(edges, feats, 12)
        T, cut = 2, 4
        for lo in range(0, cut, T):
            ref.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T,
                               query_chunks=[golden_query_mix(edges)]
                               if lo == cut - T else None)
        ref.drain_answers()         # answered before the cut
        held = int(ref.queries.pending.sum())
        pend = sum(int((ls.red_pending | ls.fwd_pending).sum())
                   for ls in ref.states)
        check(held > 0 and pend > 0, f"[ckpt-parity] the cut holds {held} "
              f"queries and {pend} pending windows: nothing in flight")
        mgrs = {a: CheckpointManager(tmp / f"async{int(a)}", async_write=a)
                for a in (False, True)}
        for mgr in mgrs.values():
            mgr.save_pipeline(1, ref)
        mgrs[True].wait()
        restored = {}
        for a, mgr in mgrs.items():
            p = ckpt_pipeline(device, small, q)
            check(mgr.restore_pipeline(p) == 1 and states_equal(p, ref),
                  f"[ckpt-parity] async_write={a}: the restored cut differs")
            restored[a] = p
        host = ckpt_pipeline(torch.device("cpu"), small, q)
        mgrs[False].restore_pipeline(host)
        ops.reset_launches()
        want = finish_rows(ref, e_chunks, f_chunks, cut, T)
        launches = dict(ops.LAUNCHES)
        want_ans = sorted_answers(ref)
        for a, p in restored.items():
            got = finish_rows(p, e_chunks, f_chunks, cut, T)
            check(got == want, f"[ckpt-parity] async_write={a}: the "
                               "continuation's stats differ")
            ans = sorted_answers(p)
            check(all(np.array_equal(ans[k], want_ans[k]) for k in want_ans),
                  f"[ckpt-parity] async_write={a}: answers differ")
            check(states_equal(p, ref), f"[ckpt-parity] async_write={a}: "
                  "the continuation's state differs from the uninterrupted "
                  "run's")
        h_rows = finish_rows(host, e_chunks, f_chunks, cut, T)
        check(h_rows == want, "[ckpt-parity] the card's checkpoint "
                              "continued on the CPU: stats differ")
        h_err = answers_check("ckpt-parity", sorted_answers(host), want_ans,
                              QUERY_TOL)
        if device.type == "cuda":
            check(all(v > 0 for v in launches.values()),
                  f"[ckpt-parity] a kernel never launched: {launches}")
        blob = (tmp / "async0" / "0000000001.ckpt").read_bytes()
        print(f"[ckpt-parity] cut at tick {cut} ({held} held queries, "
              f"{pend} pending windows): restored with async_write False "
              f"and True, the continuation ({len(want)} calls, "
              f"{len(want_ans['qid'])} answers) bit-equal to the "
              f"uninterrupted run on every stat, answer and float of the "
              f"sink and the state; restored on the CPU: stats equal, "
              f"answers within {h_err:.3e}; blob {len(blob)} bytes, codec "
              f"tag {blob[:1]!r}; launches {launches}")
        rep = chaos.scenario_truncated_checkpoint(chaos.ChaosConfig(),
                                                  tmp / "torn",
                                                  device=device)
        check(rep["explicit_error"] is not None
              and f"step {rep['torn_step']}" in rep["explicit_error"]
              and rep["restored_step"] == rep["torn_step"] - 1
              and rep["fallback_warned"],
              f"[ckpt-parity] torn-checkpoint drill: {rep}")
        print(f"[ckpt-parity] torn checkpoint: step {rep['torn_step']} "
              f"raises CheckpointCorruptError, step=None warns and falls "
              f"back to step {rep['restored_step']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_ckpt_full(device, full=FULL, q=QUERY, c=CKPT):
    """Phase 4's full-width pipeline (query plane on) cut mid-stream with
    pending windows and held consistent queries; saved sync and async,
    restored into a fresh pipeline that finishes the stream: bit-equal to
    the uninterrupted run. State and blob bytes, save / stall / restore
    seconds, peak host and device memory."""
    import resource
    import shutil
    import tempfile
    import torch
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.serve.query import KIND_EMBED
    edges, feats = make_stream(full["n_nodes"], full["n_edges"],
                               full["dims"][0])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ref = ckpt_pipeline(device, full, q)
    T = full["super_ticks"]
    e_chunks, f_chunks = ref.chunk_stream(edges, feats, full["tick_edges"])
    cut = c["cut_launches"] * T
    gen = np.random.default_rng(SEED + 3)
    seen = np.unique(np.concatenate(e_chunks[:cut - T]))
    vids = gen.choice(seen, c["consistent"], replace=False)
    qs = [(i, KIND_EMBED, int(v), True) for i, v in enumerate(vids)]
    t0 = time.perf_counter()
    for lo in range(0, cut, T):
        ref.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T,
                           query_chunks=[qs] if lo == cut - T else None)
    pre_secs = time.perf_counter() - t0
    ref.drain_answers()
    held = int(ref.queries.pending.sum())
    pend = sum(int((ls.red_pending | ls.fwd_pending).sum())
               for ls in ref.states)
    check(held > 0 and pend > 0, f"[ckpt-full] the cut holds {held} queries "
          f"and {pend} pending windows")
    leaves = state_leaves(ref)
    state_bytes = sum(l.numel() * l.element_size() for l in leaves)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt-"))
    try:
        sync(leaves[0])
        t0 = time.perf_counter()
        CheckpointManager(tmp / "sync").save_pipeline(1, ref)
        save_s = time.perf_counter() - t0
        amgr = CheckpointManager(tmp / "async", async_write=True)
        t0 = time.perf_counter()
        amgr.save_pipeline(1, ref)
        stall_s = time.perf_counter() - t0
        amgr.wait()
        async_s = time.perf_counter() - t0
        blob = sum(p.stat().st_size for p in (tmp / "sync").iterdir())
        tag = (tmp / "sync" / "0000000001.ckpt").read_bytes()[:1]
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        got = ckpt_pipeline(device, full, q)
        sync(leaves[0])
        t0 = time.perf_counter()
        check(CheckpointManager(tmp / "async").restore_pipeline(got) == 1,
              "[ckpt-full] restored the wrong step")
        sync(got.sink)
        restore_s = time.perf_counter() - t0
        check(states_equal(got, ref), "[ckpt-full] the restored cut differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    want = finish_rows(ref, e_chunks, f_chunks, cut, T)
    ref_secs = time.perf_counter() - t0
    want_ans = sorted_answers(ref)
    rows = finish_rows(got, e_chunks, f_chunks, cut, T)
    ans = sorted_answers(got)
    check(rows == want, "[ckpt-full] the continuation's stats differ from "
                        "the uninterrupted run's")
    check(len(want_ans["qid"]) == c["consistent"] and all(
        np.array_equal(ans[k], want_ans[k]) for k in want_ans),
          "[ckpt-full] the held queries' answers differ")
    check(states_equal(got, ref), "[ckpt-full] the continuation's sink or "
                                  "state differs from the uninterrupted run's")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    emitted = sum(r[-1][3] for r in want)
    print(f"[ckpt-full] caps {full['caps']} + query_cap {q['query_cap']}, "
          f"cut after {cut} ticks ({pre_secs:.3f}s of streaming), "
          f"{held} consistent queries held, {pend} pending windows; state "
          f"{state_bytes} bytes ({state_bytes / 2**30:.3f} GiB) in "
          f"{len(leaves)} tensors; blob {blob} bytes (codec tag {tag!r}, "
          f"{state_bytes / max(blob, 1):.1f}x)")
    print(f"[ckpt-full] save {save_s:.3f}s synchronous; asynchronous: the "
          f"stream stalls {stall_s:.3f}s for the snapshot, the write ends "
          f"{async_s:.3f}s after the call; restore {restore_s:.3f}s; peak "
          f"host memory (max RSS) {rss} bytes ({rss / 2**30:.2f} GiB), "
          f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"[ckpt-full] the restored pipeline finished the stream "
          f"({len(want)} super-ticks, the uninterrupted run's in "
          f"{ref_secs:.3f}s, {emitted} final-layer emissions) bit-equal to the uninterrupted run on every stat, every "
          f"answer ({len(ans['qid'])}) and every float of the sink and "
          f"the state")
    del ref, got
    free_cuda()


def phase_what_if(trace, rate, card):
    """The cost model fitted on [mesh-parity]'s telemetry trace (4 ranks,
    route_cap 2) asked what other route_caps would cost on the wire,
    priced at [mesh-full]'s measured exchange rate (no TPU constant)."""
    from repro_torch.telemetry.cost_model import fit_cost_model
    cm = fit_cost_model(trace)
    for rc in (None, 8, 2, 1):
        wi = cm.what_if(trace, route_cap=rc, link_bw=rate)
        print(f"[what-if] route_cap {rc}: wire {wi['wire_bytes_per_tick']} "
              f"bytes a tick ({wi['wire_bytes_delta']:+d} against the "
              f"recorded route_cap {trace.meta['route_cap']}), "
              f"{wi['wire_delta_s'] * 1e3:+.4f} ms a tick at {rate:.1f} "
              f"bytes/s, predicted tick {wi['pred_tick_s'] * 1e3:.4f} ms")
    print(f"[what-if] cost model fitted on the trace's {len(trace)} rows: "
          f"report {cm.report(trace)}; the rate is [mesh-full]'s, on {card}")


def _mesh_tel_run(mesh, dev):
    """[mesh-parity]'s telemetry case: the golden small stream (32 nodes,
    dims (8, 12, 12), 4 parts, one a rank) at route_cap 2, super-tick
    driver, with telemetry and without."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    edges, feats = golden_small_stream()
    out = {}
    for tel in (True, False):
        view = mesh.on(dev)
        pipe = D3Pipeline(GraphSAGE((8, 12, 12), seed=SEED), PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=32, route_cap=2,
            telemetry=tel, window=win.WindowConfig(kind=win.STREAMING)),
            mesh=view)
        e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
        rows = [stats_row(pipe.run_super_tick(e_chunks, f_chunks,
                                              T=len(e_chunks))[0]),
                stats_row(pipe.run_super_tick(T=16)[0])]
        out["on" if tel else "off"] = {
            "rows": rows, "sink": pipe.sink.cpu().numpy(),
            "calls": {k: c[0] for k, c in view.calls.items()}}
        if tel:
            out["trace"] = trace_ints(pipe)
            out["meta"] = pipe.trace.meta
            out["cols"] = pipe.trace.columns()
            out["fed"] = pipe.straggler.ticks_observed
    return out


def plant_specials(gen, x):
    """Plant NaN payloads, +-Inf and -0.0 at 12 random words of f32 x."""
    import torch
    if x.numel():
        bits = x.view(torch.int32).reshape(-1)
        spots = torch.randint(0, x.numel(), (12,), generator=gen,
                              device=x.device)
        specials = torch.tensor([0x7FC00000, 0x7F800001, -4194304 + 0x1234,
                                 0x7F800000, -8388608, -2 ** 31],
                                dtype=torch.int32, device=x.device)
        bits[spots] = specials.repeat(2)
    return x


def mesh_inputs(gen, N, D, cap, W, live, hub):
    """Packed rows [N, W] f32 with NaN payloads, +-Inf and -0.0 planted,
    destinations over D ranks (hub: power-law, rank 0 the hub's owner),
    a live mask with `live` of the rows set; and route_plan's plan."""
    import torch
    from repro_torch.kernels.route_pack import ops
    dev = gen.device
    rows = plant_specials(gen, torch.randn(N, W, generator=gen, device=dev))
    dst = (powerlaw_rows(gen, D, N) if hub else
           torch.randint(0, D, (N,), generator=gen, device=dev))
    ok = torch.rand(N, generator=gen, device=dev) < live
    return rows, ops.route_plan(dst, ok, D, cap)


@dataclass(frozen=True)
class PartLane:
    """A one-column lane (W = 1) for route_lane's edge cases."""
    part: object


def mesh_lane(gen, kind, C, d, K, D, cap, live, hub, n_parts=64):
    """A lane as the router hands it to route_lane: a batch of C records
    ("msg": MsgBatch of width d + 5, "feat": FeatBatch of width d + 3,
    "query": the query plane's QueryBatch wire of width d + 10, 11 fields
    in int64, bool and f32, "part": PartLane) with NaN / Inf / -0.0
    planted in its float columns,
    slots up to 2**40 (they round on the wire), parts over n_parts (hub:
    60% on part 0) and 2% out of range, `live` of the records valid; a
    K-row ring of packed rows with `live` of them occupied; the plan over
    ring then lane, as MeshRouter.route_lanes makes it."""
    import torch
    from repro_torch.core.events import FeatBatch, MsgBatch
    from repro_torch.dist import wire
    from repro_torch.kernels.route_pack import ops
    from repro_torch.serve.query import QueryBatch
    dev = gen.device
    rand = lambda n: torch.rand(n, generator=gen, device=dev)
    part = torch.randint(0, n_parts, (C,), generator=gen, device=dev)
    if hub:
        part = torch.where(rand(C) < 0.6, 0, part)
    part = torch.where(rand(C) < 0.02, n_parts, part)
    valid = rand(C) < live
    slot = torch.randint(0, 2 ** 40, (C,), generator=gen, device=dev)
    f32 = lambda *shape: plant_specials(gen, torch.randn(
        *shape, generator=gen, device=dev))
    if kind == "part":
        lane, valid = PartLane(part=part), torch.ones_like(valid)
    elif kind == "feat":
        lane = FeatBatch(part=part, slot=slot, feat=f32(C, d), valid=valid)
    elif kind == "query":
        ints = lambda hi: torch.randint(0, hi, (C,), generator=gen,
                                        device=dev)
        lane = QueryBatch(qid=ints(2 ** 24), kind=ints(3), part=part,
                          slot=slot, part2=ints(n_parts), slot2=ints(2 ** 30),
                          consistent=rand(C) < 0.5, ok=rand(C) < 0.7,
                          issue=ints(2 ** 24), vec=f32(C, d), valid=valid)
    else:
        lane = MsgBatch(part=part, slot=slot, vec=f32(C, d), cnt=f32(C),
                        src_part=torch.randint(0, n_parts, (C,),
                                               generator=gen, device=dev),
                        valid=valid)
    ring = f32(K, wire.lane_width(lane))
    ring[:, wire.field_col(lane, "part")] = torch.randint(
        0, n_parts, (K,), generator=gen, device=dev).float()
    occ = rand(K) < live
    ok = torch.cat([occ, valid & (part >= 0) & (part < n_parts)])
    parts = torch.cat([ring[:, wire.field_col(lane, "part")].long(), part])
    dst = torch.where(ok, torch.div(parts, n_parts // D,
                                    rounding_mode="floor"), D)
    return ring, lane, ops.route_plan(dst, ok, D, cap)


def parent_lane_chain(ring, lane, plan, D, cap):
    """The router's lane step on the card before the fused kernel:
    pack_lane, cat, the route_pack kernel, then the ring's cumsum /
    searchsorted gather and masked_fill_."""
    import torch
    from repro_torch.dist import wire
    from repro_torch.kernels.route_pack import ops
    order, _, slot_s, left_s, starts = plan
    K = ring.shape[0]
    packed = wire.pack_lane(lane)
    allp = torch.cat([ring, packed]) if K else packed
    send = ops.route_pack(allp, order, slot_s, starts, D, cap)
    if not K:
        return send, ring
    cum = torch.cumsum(left_s, 0)
    j = torch.arange(K, device=ring.device)
    pos = torch.clamp(torch.searchsorted(cum, j + 1), max=cum.shape[0] - 1)
    return send, allp[order[pos]].masked_fill_((j >= cum[-1])[:, None], 0.0)


def mesh_lane_check(ring, lane, plan, D, cap):
    """route_lane's kernel against route_lane_ref on one lane, bit for bit
    (int32 views), send buffer and new ring. Returns (rows shipped, rows
    kept in the ring, max |kernel - plain| over entries finite in
    both)."""
    import torch
    from repro_torch.kernels.route_pack import ops, ref
    got = ops.route_lane(ring, lane, plan, D, cap)
    want = ref.route_lane_ref(ring, lane, plan, D, cap)
    sync(got[0])
    err = 0.0
    for what, g, w in zip(("send buffer", "new ring"), got, want):
        check(g.shape == w.shape, f"route_lane {what}: {tuple(g.shape)}, "
                                  f"its plain version {tuple(w.shape)}")
        n_diff = int((g.view(torch.int32) != w.view(torch.int32)).sum())
        fin = torch.isfinite(g) & torch.isfinite(w)
        if bool(fin.any()):
            err = max(err, float((g - w).abs()[fin].max()))
        check(n_diff == 0,
              f"route_lane's {what} differs from its plain version in "
              f"{n_diff} 32-bit words (C={lane.part.shape[0]}, K="
              f"{ring.shape[0]}, W={ring.shape[1]}, D={D}, cap={cap})")
    n_left = int(plan[3].sum())
    return int(plan[1].sum()), min(n_left, ring.shape[0]), err


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
    # the fused lane step against its plain chain: ring then lane fields
    lane_cases = [  # kind, d, C, K, D, cap, live, hub
        ("msg", 3, 0, 12, 2, 3, 0.9, True),     # ring rows only
        ("msg", 3, 300, 0, 4, 5, 0.8, True),    # no ring
        ("msg", 64, 400, 8, 4, 2, 1.0, False),  # every bucket overflows
        ("msg", 0, 77, 5, 2, 1, 0.9, True),     # cap = 1
        ("msg", 64, 120, 30, 4, 150, 0.9, True)]  # dense
    lane_cases += [(kind, d, 1000, 64, D, 64, 0.7, True)
                   for kind, d in (("part", 0), ("msg", 0), ("msg", 64),
                                   ("msg", 602), ("feat", 5))
                   for D in (2, 4)]
    n_lane = 0
    for kind, d, Cc, K, D, cap, live, hub in lane_cases:
        worst = max(worst, mesh_lane_check(*mesh_lane(
            gen, kind, Cc, d, K, D, cap, live, hub), D, cap)[2])
        n_lane += 1
    D, d = m["ranks"], full["dims"][0]
    ring, lane, plan = mesh_lane(gen, "msg", C, d, m["route_defer_cap"], D,
                                 m["route_cap"], m["live"], True)
    n_ship, n_keep, err = mesh_lane_check(ring, lane, plan, D,
                                          m["route_cap"])
    worst = max(worst, err)
    n_lane += 1
    print(f"[mesh-kernel] route_lane (fused lane step) vs route_lane_ref: "
          f"bit-exact (int32 views), send buffer and new ring, in {n_lane} "
          f"checks: ring rows only, no ring, every bucket overflowing past "
          f"the ring, cap = 1, dense, W in (1, 5, 69, 607) and a FeatBatch "
          f"(W = 8) x D in (2, 4), NaN/Inf/-0.0 planted, slots up to 2**40, "
          f"parts out of range, and the layer-0 RMI lane at full width "
          f"(C={C}, K={m['route_defer_cap']}, W={W}, D={D}, "
          f"cap={m['route_cap']}: {n_ship} rows shipped, {n_keep} kept in "
          f"the ring); max |kernel - plain| over finite entries {worst}")
    del ring, lane, plan
    # the query plane's wire lane at a full-width rank: 16 parts x 32
    # pending slots = 512 rows of W = d_out + 10 = 74, 11 fields
    Cq = c["n_parts"] // D * QUERY["query_cap"]
    dq = full["dims"][-1]
    q_cases = [  # K, cap, live
        (Cq, 32, 0.9),          # the ring (lane capacity) and a capped wire
        (64, 8, 1.0),           # every bucket overflowing past the ring
        (0, Cq, 0.9)]           # dense: route_cap None, no ring
    for K, cap, live in q_cases:
        ring, lane, plan = mesh_lane(gen, "query", Cq, dq, K, D, cap, live,
                                     True)
        n_ship, n_keep, err = mesh_lane_check(ring, lane, plan, D, cap)
        worst = max(worst, err)
        print(f"[mesh-kernel] route_lane on the QueryBatch wire lane (C={Cq}"
              f", W={ring.shape[1]}, K={K}, D={D}, cap={cap}): bit-exact, "
              f"{n_ship} rows shipped, {n_keep} kept in the ring")
    del ring, lane, plan
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
    import torch
    from repro_torch.core.pipeline import D3Pipeline
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for cap in m["parity_caps"]:
        for dev in (mesh.device, torch.device("cpu")):
            view = mesh.on(dev)
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
                "seen": pipe.sink_seen.cpu().numpy(),
                "calls": {k: c[0] for k, c in view.calls.items()}}
    for dev in (mesh.device, torch.device("cpu")):
        out["query", dev.type] = _mesh_query_run(mesh, dev, m)
        out["gate", dev.type] = _mesh_gate_run(mesh, dev, m)
        out["train", dev.type] = _mesh_train_run(mesh, dev, m)
        out["tel", dev.type] = _mesh_tel_run(mesh, dev)
    return out


def _serve_stream_setup(m, **cfg_kw):
    """The serve CLI's stream and configuration (dims 16,64,64, 8 parts,
    400 ids) with more PipelineConfig fields."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.graph.graphs import powerlaw_edges
    rng = np.random.default_rng(0)
    dims, n_nodes = (16, 64, 64), 400
    edges = powerlaw_edges(rng, n_nodes, m["parity_edges"])
    feats = {v: rng.normal(size=dims[0]).astype(np.float32)
             for v in range(n_nodes)}
    cfg = PipelineConfig(n_parts=8, node_cap=256, edge_tick_cap=512,
                         edge_cap=4096, repl_cap=1024, feat_cap=2048,
                         max_nodes=n_nodes, route_cap=m["parity_caps"][-1],
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=4), **cfg_kw)
    return dims, edges, feats, cfg


def _mesh_gate_run(mesh, dev, m):
    """[mesh-parity]'s gated case: the serve stream at route_cap 16, then
    two waves of feature updates on 64 vertices, eps their median
    layer-0 norm; super-tick driver."""
    from repro_torch.core.pipeline import D3Pipeline
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.kernels.segment_reduce import ops as sr
    view = mesh.on(dev)
    _, edges, feats, _ = _serve_stream_setup(m)
    waves, _, norms = gate_waves(np.random.default_rng(SEED + 8), feats,
                                 np.unique(edges),
                                 dict(GATE, waves=2, wave_vids=64))
    dims, _, _, cfg = _serve_stream_setup(m, delta_eps=float(np.median(
        norms)))
    pipe = D3Pipeline(GraphSAGE(dims, seed=SEED), cfg, mesh=view)
    record = []
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 256)
    sr.reset_launches()
    with mock.patch.object(D3Pipeline, "run_super_tick",
                           _tick_recorder(record)), \
            SiteLaunches() as sites:
        pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks))
        pipe.flush_super(max_ticks=256, T=4)
        for w in waves:
            pipe.run_super_tick(feat_chunks=[w], T=1)
        pipe.flush_super(max_ticks=256, T=4)
    return {"stats": record, "sink": pipe.sink.cpu().numpy(),
            "metrics": {k: v for k, v in vars(pipe.metrics).items()
                        if isinstance(v, int)},
            "coalescer": sites.counts["add_rows < coalesce_msg_batch"]}


def _mesh_train_run(mesh, dev, m):
    """[mesh-parity]'s training case: the serve stream at route_cap 2176
    (C // D; the gradient lanes are dense whatever the cap) with a
    4-class head, lr 0, a fire at 1; stream, flush, one label tick of
    every vertex. mesh None: the one-rank run on `dev`."""
    import dataclasses
    from repro_torch.core.pipeline import D3Pipeline
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.kernels.route_pack import ops as rp
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import tree_leaves
    dims, edges, feats, cfg = _serve_stream_setup(m, train_cap=512)
    cfg = dataclasses.replace(cfg, route_cap=m["parity_caps"][0])
    kw = (dict(device=dev) if mesh is None else
          dict(mesh=mesh.on(dev)))
    pipe = D3Pipeline(GraphSAGE(dims, seed=SEED, n_classes=4), cfg,
                      train=TrainConfig(optimizer=sgd(), lr=0.0,
                                        batch_threshold=1), **kw)
    gold = class_labels(feats, 4, dims[0])
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 256)
    rp.reset_launches()
    pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks))
    pipe.flush_super(max_ticks=256, T=4)
    pipe.run_super_tick(T=1, label_chunks=[list(gold.items())])
    return {"stats": pipe.train_stats(), "ticks": pipe.metrics.ticks,
            "grads": [g.cpu().numpy() for g in tree_leaves(
                pipe.train_state.last_grad)],
            "launches": dict(rp.LAUNCHES)}


def mesh_query_plan(edges, q=QUERY):
    """[mesh-parity]'s queries by tick: a burst of stale_ok links onto the
    busiest in-degree hub in the second tick, consistent links onto it in
    the third, the golden mix in the fourth."""
    from repro_torch.serve.query import KIND_LINK
    hub = int(np.bincount(edges[:, 1]).argmax())
    src = [int(w) for w in np.unique(edges[:, 0]) if w != hub]
    return {1: [(100 + i, KIND_LINK, w, hub, False)
                for i, w in enumerate(src[:q["burst"]])],
            2: [(1000 + i, KIND_LINK, w, hub, True)
                for i, w in enumerate(src[:q["burst"] // 4])],
            3: golden_query_mix(edges)}


def _mesh_query_run(mesh, dev, m, q=QUERY):
    """The serve CLI's stream (serve_stream's configuration) with the
    query plane on, through the super-tick driver, on `dev` over the
    mesh's gloo group."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.graphs import powerlaw_edges
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.kernels.route_pack import ops as rp
    view = mesh.on(dev)
    rng = np.random.default_rng(0)
    dims, n_nodes = (16, 64, 64), 400
    edges = powerlaw_edges(rng, n_nodes, m["parity_edges"])
    feats = {v: rng.normal(size=dims[0]).astype(np.float32)
             for v in range(n_nodes)}
    cfg = PipelineConfig(n_parts=8, node_cap=256, edge_cap=4096,
                         repl_cap=1024, feat_cap=2048, edge_tick_cap=512,
                         max_nodes=n_nodes, route_cap=m["parity_caps"][-1],
                         query_cap=q["mesh_query_cap"],
                         window=win.WindowConfig(kind=win.SESSION, interval=4))
    pipe = D3Pipeline(GraphSAGE(dims, seed=SEED), cfg, mesh=view)
    record = []
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 256)
    plan = mesh_query_plan(edges)
    rp.reset_launches()
    with mock.patch.object(D3Pipeline, "run_super_tick",
                           _tick_recorder(record)):
        pipe.run_super_tick(e_chunks, f_chunks, T=16,
                            query_chunks=[plan.get(i) for i in range(16)])
        pipe.flush_super(max_ticks=256, T=4)
    return {"stats": record, "answers": sorted_answers(pipe), "plan": plan,
            "metrics": {k: v for k, v in vars(pipe.metrics).items()
                        if isinstance(v, int)},
            "launches": dict(rp.LAUNCHES),
            "calls": {k: c[0] for k, c in view.calls.items()},
            "ring_rows": pipe.queries.wire_defer.shape[0]}


def phase_mesh_parity(device, m=MESH):
    """4 gloo ranks sharing the card, the serve CLI's --edges 1500 stream
    (dims 16,64,64) at two route_caps: the card run equals the CPU run
    exactly on every integer stat and within MESH_TOL on float state; then
    the query, gated, training and telemetry cases. Returns rank 0's
    telemetry trace (for [what-if])."""
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
    # the query plane on the mesh: card = CPU, and route_lane 2 L + 1
    # times a tick (layer 0's round-B call carries the wire lane)
    L, q_err = 2, 0.0
    for r, res in enumerate(ranks):
        a, b = res["query", device.type], res["query", "cpu"]
        for key in ("stats", "metrics"):
            check(a[key] == b[key], f"[mesh-parity] query run rank {r}: "
                                    f"{key} differ, card vs CPU")
        q_err = max(q_err, answers_check("mesh-parity", a["answers"],
                                         b["answers"], MESH_TOL))
        mt = a["metrics"]
        check(mt["queries_answered"] > 0 and mt["route_dropped"] == 0
              and a["ring_rows"] > 0 and len(set(a["answers"]["qid"]))
              == len(a["answers"]["qid"]) == sum(len(x) for x in
                                                 a["plan"].values()),
              f"[mesh-parity] query run rank {r}: {mt}, ring rows "
              f"{a['ring_rows']}")
        if device.type == "cuda":
            check(a["launches"]["route_lane"] == (2 * L + 1) * mt["ticks"],
                  f"[mesh-parity] query run rank {r}: launches "
                  f"{a['launches']}, expected route_lane {2 * L + 1} a tick "
                  f"x {mt['ticks']} ticks")
    # the gated case (route_cap 16: the coalesced RMI lane defers) and the
    # lr 0 training case (dense gradient lanes), card = CPU
    g_err = t_err = 0.0
    one = _mesh_train_run(None, device, m)
    for r, res in enumerate(ranks):
        a, b = res["gate", device.type], res["gate", "cpu"]
        for key in ("stats", "metrics"):
            check(a[key] == b[key], f"[mesh-parity] gated run rank {r}: "
                                    f"{key} differ, card vs CPU")
        check(a["metrics"]["suppressed"] > 0
              and a["metrics"]["route_dropped"] == 0,
              f"[mesh-parity] gated run rank {r}: {a['metrics']}")
        g_err = max(g_err, close_rows("mesh-parity", a["sink"], b["sink"],
                                      MESH_TOL))
        a, b = res["train", device.type], res["train", "cpu"]
        check(a["stats"]["steps"] == b["stats"]["steps"]
              == one["stats"]["steps"] == 1,
              f"[mesh-parity] training run rank {r}: steps {a['stats']}, "
              f"CPU {b['stats']}, one rank {one['stats']}")
        for x, y, z in zip(a["grads"] + [a["stats"]["loss"]],
                           b["grads"] + [b["stats"]["loss"]],
                           one["grads"] + [one["stats"]["loss"]]):
            t_err = max(t_err, close_rows("mesh-parity", x, y, MESH_TOL),
                        close_rows("mesh-parity", x, z, MESH_TOL))
        if device.type == "cuda":
            check(res["gate", device.type]["coalescer"] > 0,
                  f"[mesh-parity] gated run rank {r}: the coalescer never "
                  "launched kernel A")
            check(a["launches"]["route_lane"] == 4 * L * a["ticks"],
                  f"[mesh-parity] training run rank {r}: route_lane "
                  f"{a['launches']}, expected {4 * L} a tick (2 L data "
                  f"lanes, hops A and B a layer) x {a['ticks']} ticks")
    ga, ta = ranks[0]["gate", device.type], ranks[0]["train", device.type]
    print(f"[mesh-parity] gated run (route_cap {m['parity_caps'][-1]}): "
          f"card = CPU on every integer stat; RMIs "
          f"{ga['metrics']['reduce_msgs']}, suppressed "
          f"{ga['metrics']['suppressed']}, route_deferred "
          f"{ga['metrics']['route_deferred']}, wire_rows "
          f"{ga['metrics']['wire_rows']}; sink max err {g_err:.3e}; kernel "
          f"A in the coalescer {ga['coalescer']} launches on rank 0")
    print(f"[mesh-parity] training run (lr 0, 4 classes, route_cap "
          f"{m['parity_caps'][0]}): one fire on 4 "
          f"ranks, on the CPU and on one rank; last_grad and loss 4 ranks "
          f"vs CPU and vs one rank max err {t_err:.3e} (tolerance "
          f"{MESH_TOL} x (1 + |ref|)); loss {ta['stats']['loss']:.6f} (one "
          f"rank {one['stats']['loss']:.6f}); route_lane launches "
          f"{ta['launches']} over {ta['ticks']} ticks = "
          f"{ta['launches'].get('route_lane', 0) / max(ta['ticks'], 1):.1f} "
          f"a tick")
    a = ranks[0]["query", device.type]
    mt = a["metrics"]
    n_super = len(a["stats"])
    print(f"[mesh-parity] query plane (query_cap "
          f"{QUERY['mesh_query_cap']}, route_cap {m['parity_caps'][-1]}, "
          f"the wire lane's ring {a['ring_rows']} rows a rank): card = CPU "
          f"on {len(a['answers']['qid'])} answers (qid/kind/ok/tick/issue "
          f"exact, vec/score max err {q_err:.3e}) and every integer stat; "
          f"admitted {mt['queries_admitted']}, answered "
          f"{mt['queries_answered']}, dropped {mt['queries_dropped']}, held "
          f"query-ticks {mt['query_hold_ticks']}; ticks {mt['ticks']}, "
          f"wire_rows {mt['wire_rows']}, route_deferred "
          f"{mt['route_deferred']}; route_lane launches {a['launches']} = "
          f"{a['launches']['route_lane'] / max(mt['ticks'], 1):.1f} a tick; "
          f"collectives {a['calls']} over {n_super} super-tick calls = "
          f"{sum(a['calls'].values()) / max(mt['ticks'], 1):.2f} a tick "
          f"(the same stream without the plane at this route_cap: "
          f"{ranks[0][m['parity_caps'][-1], device.type]['calls']} over "
          f"{ranks[0][m['parity_caps'][-1], device.type]['metrics']['ticks']}"
          f" ticks)")
    # the telemetry case (route_cap 2): card = CPU on every stat and trace
    # column; telemetry changes no other stat and not the sink
    from repro_torch.telemetry.trace import Trace
    for r, res in enumerate(ranks):
        a, b = res["tel", device.type], res["tel", "cpu"]
        check(a["on"]["rows"] == b["on"]["rows"],
              f"[mesh-parity] telemetry run rank {r}: stats differ, card "
              "vs CPU")
        for c in a["trace"]:
            check(np.array_equal(a["trace"][c], b["trace"][c]),
                  f"[mesh-parity] telemetry run rank {r}: trace column {c} "
                  f"differs, card vs CPU")
            check(np.array_equal(a["trace"][c], ranks[0]["tel", device.type]
                                 ["trace"][c]),
                  f"[mesh-parity] telemetry run: rank {r}'s {c} differs "
                  "from rank 0's")
        check(gauge_free(a["on"]["rows"]) == gauge_free(a["off"]["rows"])
              and np.array_equal(a["on"]["sink"], a["off"]["sink"]),
              f"[mesh-parity] telemetry run rank {r}: telemetry changed a "
              "stat or the sink")
        check(a["fed"] == b["fed"] == 2, f"[mesh-parity] telemetry run rank "
              f"{r}: the straggler feed took {a['fed']} launches, not 2")
    a = ranks[0]["tel", device.type]
    tr = a["trace"]
    check(int(tr["route_peak"].max()) > 2 and int(tr["occ_rmi_defer"].max())
          > 0, f"[mesh-parity] telemetry run: route_peak max "
               f"{int(tr['route_peak'].max())}, occ_rmi_defer max "
               f"{int(tr['occ_rmi_defer'].max())}: nothing deferred")
    print(f"[mesh-parity] telemetry case (golden stream, 4 parts, route_cap "
          f"2, super-tick driver): card = CPU on every stat and on "
          f"{len(tr)} integer trace columns x {len(tr['tick'])} rows on "
          f"every rank; route_peak max {int(tr['route_peak'].max())}, "
          f"occ_rmi_defer max {int(tr['occ_rmi_defer'].max())}, "
          f"occ_bc_defer max {int(tr['occ_bc_defer'].max())}; telemetry "
          f"off: every other stat and the sink bit-equal; collectives "
          f"{a['on']['calls']} with telemetry, {a['off']['calls']} without")
    return Trace(a["meta"], a["cols"])


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
    emb = pipe.embeddings()            # a collective: every rank calls it
    out = {"secs": secs, "launches": launches, "calls": calls,
           "peak": peak, "host_seconds": pipe.metrics.host_seconds,
           "metrics": {k: v for k, v in vars(pipe.metrics).items()
                       if isinstance(v, int)},
           "emb": emb if mesh.rank == 0 else None,
           "agg_cnt": [ls.agg_cnt.cpu().numpy() for ls in pipe.states]}
    del pipe
    out["route_sites"] = _route_lanes_profile(mesh, cfg, full, edges, feats)
    return out


ROUTE_FRAMES = ("dist/router.py", "dist/wire.py", "dist/mesh.py",
                "kernels/route_pack/")


def _route_lanes_profile(mesh, cfg, full, edges, feats, warm=2):
    """Rank 0's device time inside route_lanes by call site over one
    steady super-tick: a fresh pipeline streams the same edges, `warm`
    super-ticks unprofiled, then one under torch.profiler with stacks on
    rank 0 (the other ranks run it unprofiled, in step). Returns
    {call site: (device ms, launches)} for the sites whose innermost
    frame lies in the routing plane (none off the card), or None off
    rank 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.pipeline import D3Pipeline
    from repro_torch.graph.sage import GraphSAGE
    pipe = D3Pipeline(GraphSAGE(full["dims"], seed=SEED), cfg, mesh=mesh)
    T = full["super_ticks"]
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, full["tick_edges"])
    for lo in range(0, warm * T, T):
        pipe.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T)
    lo = warm * T
    if mesh.rank != 0:
        pipe.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T)
        return None
    cuda = mesh.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync(torch.zeros((), device=mesh.device))
    verbose = torch._C._profiler._ExperimentalConfig(verbose=True)
    with profile(activities=acts, with_stack=True,
                 experimental_config=verbose) as prof:
        pipe.run_super_tick(e_chunks[lo:lo + T], f_chunks[lo:lo + T], T=T)
        sync(torch.zeros((), device=mesh.device))
    by_site, n_site, _ = device_ms_by_site(prof)
    # the fused kernel's launches in device order: each tick routes layer
    # 0's broadcast lane, its RMI lane, then layer 1's two
    kern = sorted((e for e in prof.events()
                   if "CUDA" in str(e.device_type)
                   and "route_lane_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    return {"sites": {site: (ms, n_site[site])
                      for site, ms in by_site.items()
                      if site.split(" < ")[0].startswith(ROUTE_FRAMES)},
            "kernel_ms": [e.time_range.elapsed_us() / 1e3 for e in kern]}


def phase_mesh_full(device, full=FULL, m=MESH, card=""):
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
            # the lanes go through the fused entry, never through the
            # placement alone (the earlier pack + cat + route_pack chain)
            check(res["launches"]["route_lane"] == 2 * L * mt["ticks"]
                  and res["launches"]["route_pack"] == 0,
                  f"rank {r} launches {res['launches']}: expected "
                  f"route_lane {2 * L} a tick x {mt['ticks']} ticks and no "
                  f"route_pack")
            check(all(res["launches"][k] > 0 for k in (
                "route_lane", "segment_sum_rows", "mean_rows_gather")),
                  f"rank {r}: a kernel never launched: {res['launches']}")
    prof0 = ranks[0]["route_sites"]
    sites, kern = prof0["sites"], prof0["kernel_ms"]
    if device.type == "cuda" and not (sites or kern):
        print("[mesh-full] rank 0's device time inside route_lanes: not "
              "measured (no device events in the profile)")
    if sites or kern:
        print(f"[mesh-full] rank 0, one steady super-tick of {T} ticks "
              f"under torch.profiler (a second run of the stream: 2 warm "
              f"super-ticks, the third profiled): device ms inside "
              f"route_lanes, {sum(ms for ms, _ in sites.values()):.3f} ms "
              f"by the call site of the op that launched it, and the fused "
              f"kernel's own {sum(kern):.3f} ms in {len(kern)} launches")
        for site, (ms, n) in sorted(sites.items(), key=lambda kv: -kv[1][0]):
            print(f"[mesh-full] {ms:9.3f} ms  {n:6d} x  {site[:110]}")
        # by call site: round A's broadcast lane (core/tick.py:343) and
        # round B's RMI lane (:351), layer by layer, 4 launches a tick
        if len(kern) == 2 * L * T:
            names = [f"layer {li} {lane}" for li in range(L) for lane in (
                "broadcast lane (round A, core/tick.py:343)",
                "RMI lane (round B, core/tick.py:351)")]
            for i, name in enumerate(names):
                ks = kern[i::2 * L]
                print(f"[mesh-full] route_lane kernel at the {name}: "
                      f"{sum(ks):.3f} ms in {len(ks)} launches, "
                      f"{sum(ks) / len(ks):.4f} ms each")
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
    # the port's exchange rate: rank 0's all_to_all bytes over the seconds
    # it spent blocked in all_to_all (waits for the other ranks included)
    a2a = ranks[0]["calls"]["all_to_all"]
    rate = a2a[2] / a2a[1]
    print(f"[mesh-full] exchange rate (gloo all_to_all, 4 ranks on one "
          f"card, rank 0): {a2a[2]} bytes in {a2a[1]:.3f}s blocked = "
          f"{rate:.1f} bytes/s on {card}")
    free_cuda()
    return sum(r["launches"]["route_lane"] for r in ranks), rate, emb


def lane_row_bytes(lane):
    """Bytes of one record of a lane's fields, as they lie in memory."""
    from repro_torch.dist import wire
    return sum(w * t.element_size() for _, t, _, w in wire.lane_fields(lane))


def phase_mesh_time(device, launches, max_err, full=FULL, m=MESH):
    """route_pack at [mesh-full]'s layer-0 RMI shape and at the dense shape
    (route_cap None: cap = C, every row live), beside its bound, its plain
    version and the library yardstick: index_copy_ of pre-gathered rows
    into a zeroed buffer (two calls, not one; the gather is not timed).
    Then the fused lane step (route_lane) on the full-width layer-0 RMI
    lane beside its bound, its plain chain and the parent's card chain
    (pack_lane + cat + the route_pack kernel + the ring gather), each
    with its bytes. launches: [mesh-full]'s route_lane launches, the
    kernel's launches on the main path. max_err: [mesh-kernel]'s max
    |kernel - plain|; the checks at these shapes fold into it."""
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
        fn = lambda: ops.route_pack(rows, order, slot_s, starts, D, cap)
        ms = time_ms(fn)
        plain = time_ms(lambda: ref.route_pack_ref(rows[order], slot_s,
                                                   D * cap))
        lib = time_ms(lambda: torch.zeros(D * cap + 1, W, device=device)
                      .index_copy_(0, slot_s, rows_s))
        # shipped rows read once with their order entries, starts read,
        # the send buffer written once; no arithmetic
        n_bytes = n_ship * W * 4 + n_ship * 8 + (D + 1) * 8 + D * cap * W * 4
        bound = bound_ms(n_bytes, 0)
        print(f"[mesh-time] route_pack {name}: N={N} W={W} D={D} cap={cap} "
              f"shipped {n_ship}: {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} "
              f"GB/s); bound {bound:.4f} ms by bytes ({n_bytes} bytes; "
              f"{bound / ms:.3f} of it reached); plain {plain:.4f} ms; zeros "
              f"+ index_copy_ of pre-gathered rows {lib:.4f} ms")
        win = event_window_check("mesh-time", f"route_pack {name}",
                                 "route_lane_kernel", fn, ms)
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                         library_ms=lib, **win)
        del rows, plan, rows_s, order, ship_s, slot_s, starts, fn
        free_cuda()

    # the fused lane step at the layer-0 RMI lane: the ring's K rows, then
    # the lane's C records read in place
    K, cap = m["route_defer_cap"], m["route_cap"]
    ring, lane, plan = mesh_lane(gen, "msg", C, full["dims"][0], K, D, cap,
                                 m["live"], True)
    n_ship, n_keep, err = mesh_lane_check(ring, lane, plan, D, cap)
    max_err = max(max_err, err)
    got, want = ops.route_lane(ring, lane, plan, D, cap), \
        parent_lane_chain(ring, lane, plan, D, cap)
    for g, w in zip(got, want):
        check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
              "route_lane differs from the parent's card chain")
    del got, want
    order, ship_s, _, left_s, _ = plan
    kept = left_s & (torch.cumsum(left_s, 0) <= K)
    src = order[ship_s | kept]
    from_ring = int((src < K).sum())
    rb = lane_row_bytes(lane)
    # the shipped and kept rows' source bytes (ring rows W words, lane
    # rows their fields), their order entries and starts read; the send
    # buffer and the ring written once
    f_bytes = (from_ring * W * 4 + (src.numel() - from_ring) * rb
               + src.numel() * 8 + (D + 1) * 8 + (D * cap + K) * W * 4)
    f_bound = bound_ms(f_bytes, 0)
    N = K + C
    # what the parent's chain moves as written: pack_lane reads the lane
    # and writes [C, W]; cat reads and writes [K + C, W]; the route_pack
    # kernel its own bytes; the ring's cumsum, searchsorted and index
    # gathers, the row gather and masked_fill_ (read and write) of [K, W]
    p_bytes = (C * rb + C * W * 4 + 2 * N * W * 4
               + n_ship * W * 4 + n_ship * 8 + (D + 1) * 8 + D * cap * W * 4
               + N + N * 8 + 4 * K * 8 + 4 * K * W * 4)
    p_bound = bound_ms(p_bytes, 0)
    fn = lambda: ops.route_lane(ring, lane, plan, D, cap)
    f_ms = time_ms(fn)
    f_plain = time_ms(lambda: ref.route_lane_ref(ring, lane, plan, D, cap))
    p_ms = time_ms(lambda: parent_lane_chain(ring, lane, plan, D, cap))
    f_ms2 = time_ms(fn)
    print(f"[mesh-time] route_lane (fused lane step) at the layer-0 RMI "
          f"lane: C={C} K={K} W={W} D={D} cap={cap}, {n_ship} rows shipped "
          f"and {n_keep} kept in the ring ({from_ring} of these from the "
          f"old ring): "
          f"{f_ms:.4f} / {f_ms2:.4f} ms (before / after the parent chain); "
          f"bound {f_bound:.4f} ms by bytes ({f_bytes} bytes; "
          f"{f_bound / f_ms:.3f} of it reached); plain chain on the card "
          f"{f_plain:.4f} ms; the parent's card chain (pack_lane + cat + "
          f"route_pack kernel + ring gather) {p_ms:.4f} ms, which moves "
          f"{p_bytes} bytes: {p_bound:.4f} ms at the memory rate")
    win = event_window_check("mesh-time", "route_lane", "route_lane_kernel",
                             fn, f_ms)
    del ring, lane, plan, order, ship_s, left_s, kept, src, fn
    free_cuda()

    # the fused lane step at the query plane's wire lane (QueryBatch, 11
    # fields) of a full-width rank: 16 x 32 = 512 rows, a 512-row ring
    Cq = c["n_parts"] // D * QUERY["query_cap"]
    ring, lane, plan = mesh_lane(gen, "query", Cq, full["dims"][-1], Cq, D,
                                 32, 0.9, True)
    Wq = ring.shape[1]
    n_ship, n_keep, err = mesh_lane_check(ring, lane, plan, D, 32)
    max_err = max(max_err, err)
    order, ship_s, _, left_s, _ = plan
    src = order[ship_s | (left_s & (torch.cumsum(left_s, 0) <= Cq))]
    from_ring = int((src < Cq).sum())
    q_bytes = (from_ring * Wq * 4 + (src.numel() - from_ring)
               * lane_row_bytes(lane) + src.numel() * 8 + (D + 1) * 8
               + (D * 32 + Cq) * Wq * 4)
    q_bound = bound_ms(q_bytes, 0)
    fn = lambda: ops.route_lane(ring, lane, plan, D, 32)
    q_ms = time_ms(fn)
    q_plain = time_ms(lambda: ref.route_lane_ref(ring, lane, plan, D, 32))
    print(f"[mesh-time] route_lane at the QueryBatch wire lane: C={Cq} "
          f"K={Cq} W={Wq} D={D} cap=32, {n_ship} rows shipped and {n_keep} "
          f"kept in the ring: {q_ms:.4f} ms; bound {q_bound:.4f} ms by "
          f"bytes ({q_bytes} bytes; {q_bound / q_ms:.3f} of it reached); "
          f"plain chain on the card {q_plain:.4f} ms")
    q_win = event_window_check("mesh-time", "route_lane, QueryBatch lane",
                               "route_lane_kernel", fn, q_ms)
    del ring, lane, plan, order, ship_s, left_s, src, fn
    free_cuda()
    capped = out["capped"]
    return {"name": "route_pack", "route": "cuda",
            "source": "src/repro_torch/csrc/route_pack.cu",
            "replaces": "src/repro/kernels/route_pack/ops.py:70",
            "launches": launches,
            "launches_by_entry": {"route_lane": launches, "route_pack": 0},
            "max_abs_err": max_err, "ms": capped["ms"],
            "plain_ms": capped["plain_ms"], "bound_ms": capped["bound_ms"],
            "bound_by": "bytes", "library_ms": capped["library_ms"],
            "capped_window": {k: capped[k] for k in (
                "profiler_ms", "host_ms", "flush_ms")},
            "dense": out["dense"],
            "fused_lane": {"ms": f_ms, "ms_again": f_ms2,
                           "plain_ms": f_plain, "bound_ms": f_bound,
                           "bound_by": "bytes", "library_ms": None,
                           "parent_chain_ms": p_ms,
                           "parent_chain_bytes_ms": p_bound, **win},
            "query_lane": {"ms": q_ms, "plain_ms": q_plain,
                           "bound_ms": q_bound, "bound_by": "bytes",
                           "library_ms": None, **q_win}}


# ------------------------------------------------------------- LM phases
# ------------------------------------------------- the 2-D stage pipeline
# [stage-parity]: test_pipeline_stage.py's golden small stream (32 nodes,
# dims (8, 8, 8), 4 parts, streaming window, 24 edges a tick) on 2 x 1 and
# 2 x 2 grids of gloo ranks, card against CPU over the same groups. The
# query case adds test_query_plane.py's golden mix; the training case a
# 4-class head at lr 0 (quiescent grads, one label tick after the flush).
# [stage-full]: GraphSAGE (602, 602, 602) — the reference's uniform-stack
# contract (in_dim == out_dim on every layer) rules out the published
# (602, 64, 64), so the staged run keeps the 602-wide input at every
# layer — at FULL's caps, route_cap 4096 and 100,000 power-law edges,
# stage 2 x data 2 beside stage 1 x data 4, both on 4 gloo ranks sharing
# the card. route_defer_cap 131,072 ring rows a lane a rank: at 2 x 2 a
# rank's bucket rows per call halve (2 destinations x 4096) while its
# lanes double (32 parts), and [mesh-full]'s 32,768 overflowed (14,393
# rows dropped in a trial run on the card).
STAGE = dict(ranks=4, dims=(602, 602, 602), n_edges=100_000,
             route_cap=4096, route_defer_cap=131072, timeout=900,
             golden=dict(n_nodes=32, n_edges=100, d=8, tick_edges=24,
                         super_ticks=4, n_classes=4))
# [reshard-full]: [mesh-full]'s configuration and stream. The live
# reshard moves 4 -> 2 ranks after `live_at` of the stream's launches; the
# fail-stop drill cuts a checkpoint after `cut_at` launches (with
# `consistent` held queries), loses data shards 1 and 3 before `fail_at`,
# restores, reshards onto ranks 0 and 2 and replays. route_defer_cap
# 131,072 ring rows a lane a rank: on 2 ranks a call ships 2 x 4096 rows
# a rank where 4 ranks shipped 4 x 4096, and [mesh-full]'s 32,768 dropped
# 16,235 rows after the move in a trial run on the card. The ring's size
# changes nothing while no row drops, so [mesh-full]'s sink stays the
# reference.
RESHARD = dict(live_at=0.5, cut_at=0.25, fail_at=0.375, consistent=16,
               query_cap=32, query_tick_cap=256, lose=(1, 3),
               route_defer_cap=131072)
# [decode-partial]: mistral-nemo-12b's decode head layout (32 query heads
# over 8 KV heads, head dim 128, bf16 cache) over a 32,768-token cache
# split 4 ways; combined partials vs the whole-cache decode, both against
# float64: |combined - decode| <= DECODE_TOL x max(1, |float64|) (the
# whole-cache decode rounds its softmax weights and its output to bf16;
# the partials keep f32 past the logits).
DECODE = dict(batch=4, heads=32, kv_heads=8, head_dim=128, seq=32768,
              shards=4, masked_tail=1000)
DECODE_TOL = 2.0 ** -8


def _stage_stream(g):
    return golden_small_stream(SEED, g["n_nodes"], g["n_edges"], g["d"])


def _stage_golden_run(mesh, driver, g, query=False, train=False):
    """One golden case on `mesh` (a rank of a 2-D grid): every call's
    integer TickStats, the metrics, the bubble count, the embeddings, and
    the answers or the training plane's stats and grads."""
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import tree_leaves
    edges, feats = _stage_stream(g)
    d = g["d"]
    cfg = PipelineConfig(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                         feat_cap=128, edge_tick_cap=32,
                         max_nodes=g["n_nodes"], n_stages=mesh.n_stages,
                         query_cap=8 if query else 0,
                         train_cap=64 if train else 0,
                         window=win.WindowConfig(kind=win.STREAMING))
    model = GraphSAGE((d, d, d), seed=SEED,
                      n_classes=g["n_classes"] if train else 0)
    pipe = D3Pipeline(model, cfg, mesh=mesh, train=TrainConfig(
        optimizer=sgd(), lr=0.0, batch_threshold=1) if train else None)
    record = []
    tick, sup = pipe.tick, pipe.run_super_tick

    def tick_rec(*a, **k):
        stats = tick(*a, **k)
        record.append(stats_row(stats))
        return stats

    def sup_rec(*a, **k):
        stats, quiet = sup(*a, **k)
        record.append(stats_row(stats))
        return stats, quiet

    pipe.tick, pipe.run_super_tick = tick_rec, sup_rec
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, g["tick_edges"])
    q = golden_query_mix(edges) if query else None
    if driver == "tick":
        for i, (ch, fe) in enumerate(zip(e_chunks, f_chunks)):
            pipe.tick(ch, fe, queries=q if i == len(e_chunks) - 1 else None)
        in_flight = pipe._ring_occupancy_host()
        pipe.flush(max_ticks=160)
    else:
        pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks),
                            query_chunks=[None] * (len(e_chunks) - 1) + [q])
        in_flight = pipe._ring_occupancy_host()
        pipe.flush_super(max_ticks=160, T=g["super_ticks"])
    out = {"stats": record, "in_flight": in_flight,
           "drained": pipe._ring_occupancy_host(),
           "metrics": {k: v for k, v in vars(pipe.metrics).items()
                       if isinstance(v, int)},
           "emb": pipe.embeddings(),
           "calls": {k: c[0] for k, c in mesh.calls.items()}}
    if query:
        out["answers"] = sorted_answers(pipe)
    if train:
        gold = {v: (v * 7 + 3) % g["n_classes"] for v in range(g["n_nodes"])}
        pipe.run_super_tick(T=1, label_chunks=[list(gold.items())])
        out["train"] = pipe.train_stats()
        out["grads"] = [x.cpu().numpy() for x in tree_leaves(
            pipe.train_state.last_grad)]
    return out


def _stage_parity_rank(world, g):
    """One rank of [stage-parity]: every golden case on the card, then on
    the CPU over the same groups (2 x 1 on ranks 0 and 1; 2 x 2 on all)."""
    import torch
    from repro_torch.kernels.route_pack import ops as rp
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.launch.mesh import make_stream_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    grids = {"2x1": make_stream_mesh(world.device, stage=2, ranks=[0, 1]),
             "2x2": make_stream_mesh(world.device, stage=2)}
    out = {}
    for dev in (world.device, torch.device("cpu")):
        rp.reset_launches()
        sr.reset_launches()
        for name, mesh in grids.items():
            if not mesh.member:
                continue
            for driver in ("tick", "super"):
                out[name, driver, dev.type] = _stage_golden_run(
                    mesh.on(dev), driver, g)
        out["query", dev.type] = _stage_golden_run(grids["2x2"].on(dev),
                                                   "super", g, query=True)
        out["train", dev.type] = _stage_golden_run(grids["2x2"].on(dev),
                                                   "super", g, train=True)
        out["launches", dev.type] = {**rp.LAUNCHES, **sr.LAUNCHES}
    return out


def phase_stage_parity(device, s=STAGE):
    """The 2-D program's golden cases, card = CPU on every integer stat of
    every call, the bubble counts and the answers; the sink within
    SINK_TOL of the float64 oracle; kernels 1-3 launched on the card."""
    import torch
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.launch.mesh import spawn_stream_mesh
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.core import windowing as win
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import tree_leaves
    free_cuda()
    g = s["golden"]
    t0 = time.perf_counter()
    ranks = spawn_stream_mesh(s["ranks"], _stage_parity_rank, backend="gloo",
                              device=device, args=(g,), timeout=s["timeout"])
    secs = time.perf_counter() - t0
    edges, feats = _stage_stream(g)
    d = g["d"]
    model64 = GraphSAGE((d, d, d), seed=SEED).double()
    snap, _ = build_snapshot(edges, feats, d, g["n_nodes"], "cpu",
                             dtype=torch.float64)
    ref = oracle_embeddings(model64, snap)
    worst, worst_oracle = 0.0, 0.0
    keys = [k for k in ranks[0] if len(k) == 3 and k[2] == device.type]
    for k in sorted(keys):
        name, driver, _ = k
        for r, res in enumerate(ranks):
            if k not in res:
                continue
            a, b = res[k], res[name, driver, "cpu"]
            for key in ("stats", "metrics", "in_flight", "drained"):
                check(a[key] == b[key], f"[stage-parity] {name} {driver} "
                                        f"rank {r}: {key} differ, card vs CPU")
            check(a["drained"] == 0 and a["in_flight"] > 0
                  and a["metrics"]["stage_idle"] > 0
                  and a["metrics"]["route_dropped"] == 0,
                  f"[stage-parity] {name} {driver} rank {r}: in flight "
                  f"{a['in_flight']}, left {a['drained']}, metrics "
                  f"{a['metrics']}")
            check(set(a["emb"]) == set(b["emb"]) == set(range(g["n_nodes"])),
                  f"[stage-parity] {name} {driver}: materialized sets")
            worst = max(worst, close_rows(
                "stage-parity", np.stack([a["emb"][v] for v in sorted(a["emb"])]),
                np.stack([b["emb"][v] for v in sorted(b["emb"])]), MESH_TOL))
            err, vid = sink_error(a["emb"], lambda vids: ref[vids])
            worst_oracle = max(worst_oracle, err)
            check(err <= SINK_TOL, f"[stage-parity] {name} {driver}: sink vs "
                                   f"oracle {err:.3e} at vid {vid}")
        mt = ranks[0][k]["metrics"]
        print(f"[stage-parity] {name} {driver}: card = CPU on "
              f"{len(ranks[0][k]['stats'])} calls of integer TickStats and "
              f"every metric (ticks {mt['ticks']}, RMIs {mt['reduce_msgs']}, "
              f"emitted {mt['emitted_total']}, stage_idle "
              f"{mt['stage_idle']}, wire_rows {mt['wire_rows']}); "
              f"{ranks[0][k]['in_flight']} rows in flight after the stream, "
              f"0 after the flush; collectives {ranks[0][k]['calls']}")
    for r, res in enumerate(ranks):
        a, b = res["query", device.type], res["query", "cpu"]
        for key in ("stats", "metrics"):
            check(a[key] == b[key], f"[stage-parity] query rank {r}: {key} "
                                    "differ, card vs CPU")
        answers_check("stage-parity", a["answers"], b["answers"], MESH_TOL)
        check(sorted(a["answers"]["qid"].tolist()) == [1, 2, 3, 4]
              and a["answers"]["ok"].all(),
              f"[stage-parity] query rank {r}: answers {a['answers']['qid']}")
    # training: card = CPU, and = a one-rank run at the same fixed point
    t = g["n_classes"]
    one = D3Pipeline(GraphSAGE((d, d, d), seed=SEED, n_classes=t),
                     PipelineConfig(n_parts=4, node_cap=32, edge_cap=128,
                                    repl_cap=128, feat_cap=128,
                                    edge_tick_cap=32, max_nodes=g["n_nodes"],
                                    train_cap=64,
                                    window=win.WindowConfig(
                                        kind=win.STREAMING)),
                     device="cpu", train=TrainConfig(
                         optimizer=sgd(), lr=0.0, batch_threshold=1))
    one.run_stream_super(edges, feats, tick_edges=g["tick_edges"],
                         super_ticks=g["super_ticks"])
    one.flush_super(max_ticks=160, T=g["super_ticks"])
    gold = {v: (v * 7 + 3) % t for v in range(g["n_nodes"])}
    one.run_super_tick(T=1, label_chunks=[list(gold.items())])
    one_grads = [x.numpy() for x in tree_leaves(one.train_state.last_grad)]
    t_err = 0.0
    for r, res in enumerate(ranks):
        a, b = res["train", device.type], res["train", "cpu"]
        check(a["stats"] == b["stats"] and a["train"]["steps"]
              == b["train"]["steps"] == 1,
              f"[stage-parity] training rank {r}: {a['train']} vs "
              f"{b['train']}")
        for x, y, z in zip(a["grads"], b["grads"], one_grads):
            t_err = max(t_err, close_rows("stage-parity", x, y, MESH_TOL),
                        close_rows("stage-parity", x, z, MESH_TOL))
    la = ranks[0]["launches", device.type]
    if device.type == "cuda":
        for r, res in enumerate(ranks):
            lr = res["launches", device.type]
            check(all(lr.get(k, 0) > 0 for k in (
                "route_lane", "segment_sum_rows", "mean_rows_gather")),
                  f"[stage-parity] rank {r}: a kernel never launched: {lr}")
    print(f"[stage-parity] query plane (2 x 2, super): card = CPU on the "
          f"golden mix's 4 answers and every stat; training (2 x 2, lr 0, "
          f"one fire): card vs CPU and vs a one-rank run, last_grad max err "
          f"{t_err:.3e}; sink vs the float64 oracle max "
          f"{worst_oracle:.3e} (tolerance {SINK_TOL}); card vs CPU "
          f"embeddings max {worst:.3e}; rank 0's card launches {la}; "
          f"{secs:.1f}s with the ranks' start")


def _stage_full_rank(world, full, s):
    """One rank of [stage-full]: the (602, 602, 602) stream at stage 2 x
    data 2, then at stage 1 x data 4; measurements of each."""
    import torch
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.kernels.route_pack import ops as rp
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.launch.mesh import make_stream_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    edges, feats = make_stream(full["n_nodes"], s["n_edges"], s["dims"][0])
    cuda = world.device.type == "cuda"
    out = {}
    for S in (2, 1):
        mesh = make_stream_mesh(world.device, stage=S)
        cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                             n_stages=S, route_cap=s["route_cap"],
                             route_defer_cap=s["route_defer_cap"],
                             window=win.WindowConfig(kind=win.SESSION,
                                                     interval=4))
        pipe = D3Pipeline(GraphSAGE(s["dims"], seed=SEED), cfg, mesh=mesh)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        rp.reset_launches()
        sr.reset_launches()
        t0 = time.perf_counter()
        pipe.run_stream_super(edges, feats, tick_edges=full["tick_edges"],
                              super_ticks=full["super_ticks"])
        pipe.flush_super(max_ticks=256, T=full["super_ticks"])
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[S] = {"secs": secs, "launches": {**rp.LAUNCHES, **sr.LAUNCHES},
                  "calls": {k: list(v) for k, v in mesh.calls.items()},
                  "peak": torch.cuda.max_memory_allocated() if cuda else 0,
                  "host_seconds": pipe.metrics.host_seconds,
                  "bubble": pipe.bubble_fraction(),
                  "metrics": {k: v for k, v in vars(pipe.metrics).items()
                              if isinstance(v, int)}}
        emb = pipe.embeddings()
        out[S]["emb"] = emb if mesh.rank == 0 else None
        del pipe
        free_cuda()
    return out


def phase_stage_full(device, full=FULL, s=STAGE, card=""):
    """GraphSAGE (602, 602, 602) at FULL's caps on 4 gloo ranks sharing
    the card, stage 2 x data 2 and stage 1 x data 4: edges/s a rank, the
    bubble fraction, host seconds blocked in each collective kind,
    collectives a super-tick, peak memory a rank, and the sink of both
    against the float64 oracle."""
    import torch
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.launch.mesh import spawn_stream_mesh
    free_cuda()
    t0 = time.perf_counter()
    ranks = spawn_stream_mesh(s["ranks"], _stage_full_rank, backend="gloo",
                              device=device, args=(full, s),
                              timeout=s["timeout"])
    spawn_secs = time.perf_counter() - t0
    T = full["super_ticks"]
    print(f"[stage-full] GraphSAGE {s['dims']} (the published (602, 64, 64) "
          f"kept 602 wide at every layer: the staged program needs in_dim "
          f"== out_dim), caps {full['caps']}, route_cap {s['route_cap']}, "
          f"route_defer_cap {s['route_defer_cap']}, window session(4), "
          f"driver super(T={T}), {s['n_edges']} power-law edges; 4 gloo "
          f"ranks on one card; {spawn_secs:.1f}s with the ranks' start")
    edges, feats = make_stream(full["n_nodes"], s["n_edges"], s["dims"][0])
    model64 = GraphSAGE(s["dims"], seed=SEED).to(device).double()
    g, _ = build_snapshot(edges, feats, s["dims"][0], full["n_nodes"],
                          device, dtype=torch.float64)
    ref = oracle_embeddings(model64, g).cpu()
    del model64, g
    rates = {}
    for S in (2, 1):
        D = s["ranks"] // S
        mt = ranks[0][S]["metrics"]
        n_super = max(mt["ticks"] // T, 1)
        for r, res in enumerate(ranks):
            x = res[S]
            check(x["metrics"] == mt, f"[stage-full] {S} x {D}: rank {r}'s "
                                      "metrics differ from rank 0's")
            blocked = {k: round(c[1], 3) for k, c in x["calls"].items()}
            n_calls = sum(c[0] for c in x["calls"].values())
            print(f"[stage-full] stage {S} x data {D} rank {r}: "
                  f"{x['secs']:.3f}s = {s['n_edges'] / x['secs']:.1f} "
                  f"edges/s; host staging {x['host_seconds']:.3f}s; host "
                  f"seconds blocked by kind {blocked}; collectives "
                  f"{ {k: c[0] for k, c in x['calls'].items()} } = "
                  f"{n_calls / n_super:.1f} per super-tick; launches "
                  f"{x['launches']}; peak memory {x['peak']} bytes "
                  f"({x['peak'] / 2**30:.2f} GiB)")
            if device.type == "cuda":
                check(all(x["launches"].get(k, 0) > 0 for k in (
                    "route_lane", "segment_sum_rows", "mean_rows_gather")),
                      f"[stage-full] {S} x {D} rank {r}: a kernel never "
                      f"launched: {x['launches']}")
        check(mt["route_dropped"] == 0, f"[stage-full] {S} x {D}: "
                                        f"{mt['route_dropped']} rows dropped")
        emb = ranks[0][S]["emb"]
        check(len(emb) > 0 and all(np.isfinite(v).all()
                                   and v.shape == (s["dims"][-1],)
                                   for v in emb.values()),
              f"[stage-full] {S} x {D}: non-finite, misshapen or no "
              "embeddings")
        err, vid = sink_error(emb, lambda vids: ref[vids])
        rates[S] = s["n_edges"] / ranks[0][S]["secs"]
        print(f"[stage-full] stage {S} x data {D}: ticks {mt['ticks']}, "
              f"RMIs {mt['reduce_msgs']}, wire_rows {mt['wire_rows']}, "
              f"wire_bytes {mt['wire_bytes']}, route_deferred "
              f"{mt['route_deferred']}, stage_idle {mt['stage_idle']}, "
              f"bubble_fraction {ranks[0][S]['bubble']:.4f}; sink vs the "
              f"float64 oracle max |diff|/max(1,|ref|) {err:.3e} at vid "
              f"{vid} (tolerance {SINK_TOL}); materialized {len(emb)}")
        check(err <= SINK_TOL, f"[stage-full] {S} x {D}: sink vs oracle "
                               f"{err:.3e} > {SINK_TOL}")
    print(f"[stage-full] edges/s rank 0: stage 2 x data 2 {rates[2]:.1f}, "
          f"stage 1 x data 4 {rates[1]:.1f} (ratio {rates[2] / rates[1]:.3f})"
          f" on {card}; four gloo ranks share ONE card: not multi-GPU "
          f"scaling")
    free_cuda()
    return rates


# ------------------------------------------------------- the live reshard
def _reshard_golden(dev, case):
    """test_chaos.py's small reshard goldens on this process's `dev`
    (stream half, reshard, stream the rest, flush): the global sink and
    the logical stats, or None on a rank the reshard removes."""
    from dataclasses import asdict
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.launch.mesh import make_stream_mesh, survivor_mesh
    name, driver, S, old, new, kw = case
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 32, 150), rng.integers(0, 32, 150)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=8).astype(np.float32) for v in range(32)}
    mk = lambda ranks, stage=1: (None if ranks is None else make_stream_mesh(
        dev, stage=stage, ranks=ranks))
    mesh = mk(old, S)
    cfg = PipelineConfig(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                         feat_cap=128, edge_tick_cap=32, max_nodes=32,
                         n_stages=S, window=win.WindowConfig(
                             kind=win.SESSION, interval=3), **kw)
    pipe = D3Pipeline(GraphSAGE((8, 8, 8), seed=SEED), cfg, mesh=mesh,
                      device=None if mesh is not None else dev)
    chunks = [edges[i:i + 16] for i in range(0, len(edges), 16)]
    rows = [[(int(v), feats[int(v)]) for e in c for v in set(map(int, e))]
            for c in chunks]
    half = len(edges) // 32

    def feed(lo, hi):
        if not pipe.active:
            return
        if driver == "tick":
            for c, r in zip(chunks[lo:hi], rows[lo:hi]):
                pipe.tick(c, r)
        else:
            pipe.run_super_tick(chunks[lo:hi], rows[lo:hi])

    feed(0, half)
    if new == "local":
        pipe.reshard(None)
    elif new == "survivors":
        pipe.reshard(survivor_mesh(mesh, [1, 3]))
    elif new is not None:
        pipe.reshard(mk(new, S))
    feed(half, len(chunks))
    if not pipe.active:
        return None
    pipe.flush(max_ticks=128)
    m = asdict(pipe.metrics)
    return {"sink": pipe.sink_global().cpu().numpy(),
            "stats": {k: m[k] for k in (
                "ticks", "emitted_total", "reduce_msgs", "broadcast_msgs",
                "cross_part_msgs", "dropped", "route_dropped")}}


RESHARD_GOLDENS = (
    ("local run", "tick", 1, None, None, {}),
    ("4 -> 2 tick", "tick", 1, [0, 1, 2, 3], [0, 1], {}),
    ("2 -> 4 super", "super", 1, [0, 1], [0, 1, 2, 3], {}),
    ("4 -> local", "tick", 1, [0, 1, 2, 3], "local", {}),
    ("4 -> survivors 0, 2", "tick", 1, [0, 1, 2, 3], "survivors", {}),
    ("4 -> 2 capped", "tick", 1, [0, 1, 2, 3], [0, 1], dict(route_cap=8)),
    ("2 x 2 -> 2 x 1 super", "super", 2, [0, 1, 2, 3], [0, 1], {}),
)


def _reshard_full_rank(world, full, m, r, ckpt_dir):
    """One rank of [reshard-full]: the live 4 -> 2 reshard mid-stream and
    the fail-stop drill, at [mesh-full]'s configuration; then the small
    goldens on the card and on the CPU."""
    import torch
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.launch.mesh import make_stream_mesh, survivor_mesh
    from repro_torch.serve.query import KIND_EMBED
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = world.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    edges, feats = make_stream(full["n_nodes"], m["n_edges"],
                               full["dims"][0])
    T = full["super_ticks"]

    def build(mesh, **kw):
        cfg = PipelineConfig(**full["caps"], max_nodes=full["n_nodes"],
                             route_cap=m["route_cap"],
                             route_defer_cap=r["route_defer_cap"],
                             window=win.WindowConfig(kind=win.SESSION,
                                                     interval=4), **kw)
        return D3Pipeline(GraphSAGE(full["dims"], seed=SEED), cfg, mesh=mesh)

    out = {}
    # (a) the live reshard, 4 -> 2 ranks, mid-stream
    pipe = build(make_stream_mesh(dev))
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, full["tick_edges"])
    launches = [(e_chunks[i:i + T], f_chunks[i:i + T])
                for i in range(0, len(e_chunks), T)]
    k = max(1, int(len(launches) * r["live_at"]))
    for e, f in launches[:k]:
        pipe.run_super_tick(e, f, T=T)
    two = make_stream_mesh(dev, ranks=[0, 1])
    sync()
    pipe.reshard(two)
    sync()
    out["live"] = dict(pipe.last_reshard, launches=len(launches), at=k)
    if pipe.active:
        t0 = time.perf_counter()
        n_after = sum(len(x) for e, _ in launches[k:] for x in e)
        for e, f in launches[k:]:
            pipe.run_super_tick(e, f, T=T)
        pipe.flush_super(max_ticks=256, T=T)
        sync()
        secs = time.perf_counter() - t0
        emb = pipe.embeddings()
        out["live"].update(secs_after=secs, edges_after=n_after,
                           metrics={k2: v for k2, v in vars(
                               pipe.metrics).items() if isinstance(v, int)},
                           emb=emb if two.rank == 0 else None)
    del pipe
    free_cuda()
    # (b) the fail-stop drill: cut, lose shards 1 and 3, restore, reshard
    # onto the survivors, replay
    mesh = make_stream_mesh(dev)
    pipe = build(mesh, query_cap=r["query_cap"],
                 query_tick_cap=r["query_tick_cap"])
    cut = max(1, int(len(launches) * r["cut_at"]))
    fail = min(max(cut + 1, int(len(launches) * r["fail_at"])),
               len(launches))
    deg = np.bincount(edges[:, 1], minlength=full["n_nodes"])
    hubs = [int(v) for v in np.argsort(-deg, kind="stable")[:r["consistent"]]]
    held = [(10_000 + i, KIND_EMBED, v, True) for i, v in enumerate(hubs)]
    mgr = CheckpointManager(ckpt_dir, keep=2)
    save_s = None
    for i, (e, f) in enumerate(launches[:fail]):
        pipe.run_super_tick(e, f, T=T, query_chunks=[held] if i == cut - 1
                            else None)
        if i == cut - 1:
            t0 = time.perf_counter()
            mgr.save_pipeline(cut, pipe)
            save_s = time.perf_counter() - t0
    surv = survivor_mesh(mesh, r["lose"], n_data=2)
    sync()
    t0 = time.perf_counter()
    step = mgr.restore_pipeline(pipe)
    sync()
    restore_s = time.perf_counter() - t0
    pipe.reshard(surv)
    sync()
    out["failstop"] = dict(pipe.last_reshard, restore_s=restore_s,
                           save_s=save_s, step=step, cut=cut, fail=fail,
                           hubs=hubs)
    if pipe.active:
        t0 = time.perf_counter()
        for e, f in launches[step:]:
            pipe.run_super_tick(e, f, T=T)
        pipe.flush_super(max_ticks=256, T=T)
        sync()
        out["failstop"].update(
            secs_after=time.perf_counter() - t0,
            metrics={k2: v for k2, v in vars(pipe.metrics).items()
                     if isinstance(v, int)},
            answers=sorted_answers(pipe), emb=pipe.embeddings())
        if surv.rank != 0:
            out["failstop"]["emb"] = None
    del pipe
    free_cuda()
    # (c) the small goldens, card and CPU
    for dev_g in (dev, torch.device("cpu")):
        for case in RESHARD_GOLDENS:
            if case[3] is None and world.rank != 0:
                continue
            out["golden", case[0], dev_g.type] = _reshard_golden(dev_g,
                                                                 case)
    return out


def phase_reshard_full(device, mesh_emb, full=FULL, m=MESH, r=RESHARD,
                       card=""):
    """[mesh-full]'s configuration on 4 gloo ranks: a live 4 -> 2 reshard
    mid-stream and a fail-stop drill onto the survivors; both sinks
    within SINK_TOL of [mesh-full]'s uninterrupted run, nothing dropped,
    the held consistent queries answered; then the small reshard goldens
    card = CPU."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.mesh import spawn_stream_mesh
    free_cuda()
    ckpt = tempfile.mkdtemp(prefix="reshard_full-")
    try:
        t0 = time.perf_counter()
        ranks = spawn_stream_mesh(m["ranks"], _reshard_full_rank,
                                  backend="gloo", device=device,
                                  args=(full, m, r, ckpt),
                                  timeout=m["timeout"])
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    ref = lambda vids: torch.as_tensor(np.stack([mesh_emb[v] for v in vids]),
                                       dtype=torch.float64)
    print(f"[reshard-full] [mesh-full]'s configuration (GraphSAGE "
          f"{full['dims']}, caps {full['caps']}, route_cap "
          f"{m['route_cap']}, route_defer_cap {r['route_defer_cap']}, "
          f"{m['n_edges']} edges, super T={full['super_ticks']}) on 4 gloo "
          f"ranks on {card}; {secs:.1f}s with the ranks' start")
    for what in ("live", "failstop"):
        mine = [res[what] for res in ranks]
        a = mine[0]
        for i, x in enumerate(mine):
            print(f"[reshard-full] {what} rank {i}: reshard "
                  f"{x['seconds']:.3f}s, {x['sent_bytes']} bytes sent into "
                  f"the relay" + (f"; {x['edges_after']} edges after it in "
                                  f"{x['secs_after']:.3f}s = "
                                  f"{x['edges_after'] / x['secs_after']:.1f}"
                                  f" edges/s on 2 ranks"
                                  if what == "live" and "secs_after" in x
                                  else "") +
                  ("" if "metrics" in x else " (removed: owns nothing)"))
        check([("metrics" in x) for x in mine] == (
            [True, True, False, False] if what == "live"
            else [True, False, True, False]),
              f"[reshard-full] {what}: the wrong ranks survived")
        mt = a["metrics"]
        check(mt["route_dropped"] == 0 and mt["dropped"] == 0,
              f"[reshard-full] {what}: rows dropped: {mt}")
        err, vid = sink_error(a["emb"], ref)
        check(set(a["emb"]) == set(mesh_emb) and err <= SINK_TOL,
              f"[reshard-full] {what}: sink vs the uninterrupted run "
              f"{err:.3e} at vid {vid} (materialized {len(a['emb'])} vs "
              f"{len(mesh_emb)})")
        extra = ""
        if what == "failstop":
            ans = a["answers"]
            held = sorted(ans["qid"][ans["qid"] >= 10_000].tolist())
            check(held == list(range(10_000, 10_000 + r["consistent"]))
                  and ans["ok"][ans["qid"] >= 10_000].all(),
                  f"[reshard-full] failstop: held consistent answers {held}")
            got = {a["hubs"][int(q) - 10_000]: v
                   for q, v in zip(ans["qid"], ans["vec"]) if q >= 10_000}
            vec_err, _ = sink_error(got, ref)
            check(vec_err <= SINK_TOL, f"[reshard-full] failstop: held "
                                       f"answers vs the uninterrupted sink "
                                       f"{vec_err:.3e}")
            extra = (f"; cut after {a['cut']} launches (save "
                     f"{a['save_s']:.3f}s), fail before launch {a['fail']}, "
                     f"restore {a['restore_s']:.3f}s, time to recover "
                     f"(restore + reshard) "
                     f"{a['restore_s'] + a['seconds']:.3f}s, replay and "
                     f"finish {a['secs_after']:.3f}s; {len(held)} held "
                     f"consistent queries answered ok, within {vec_err:.3e} of the "
                     f"uninterrupted sink")
        print(f"[reshard-full] {what}: ticks {mt['ticks']}, RMIs "
              f"{mt['reduce_msgs']}, route_deferred {mt['route_deferred']},"
              f" route_dropped {mt['route_dropped']}; sink vs [mesh-full]'s "
              f"uninterrupted run max |diff|/max(1,|ref|) {err:.3e} "
              f"(tolerance {SINK_TOL}){extra}")
    worst = 0.0
    base = ranks[0]["golden", RESHARD_GOLDENS[0][0], device.type]
    for case in RESHARD_GOLDENS:
        for i, res in enumerate(ranks):
            a = res.get(("golden", case[0], device.type))
            b = res.get(("golden", case[0], "cpu"))
            if a is None:
                check(b is None, f"[reshard-full] golden {case[0]} rank "
                                 f"{i}: card and CPU disagree on who holds")
                continue
            check(a["stats"] == b["stats"] and a["stats"]["route_dropped"]
                  == 0, f"[reshard-full] golden {case[0]} rank {i}: stats "
                        f"{a['stats']} vs CPU {b['stats']}")
            worst = max(worst, close_rows("reshard-full", a["sink"],
                                          b["sink"], MESH_TOL))
            tol = 0.0 if case[2] == 1 and "cap" not in case[0] else 1e-5
            diff = float(np.abs(a["sink"] - base["sink"]).max())
            check(diff <= tol, f"[reshard-full] golden {case[0]} rank {i}: "
                               f"sink vs the local run {diff:.3e} > {tol}")
            if tol == 0.0:
                check(a["stats"] == base["stats"],
                      f"[reshard-full] golden {case[0]}: stats differ from "
                      "the local run")
    print(f"[reshard-full] test_chaos.py's reshard goldens on the card "
          f"({', '.join(c[0] for c in RESHARD_GOLDENS)}): card = CPU on the "
          f"logical stats, sinks within {worst:.3e}; the uncapped 1-D ones "
          f"bit-equal to the local run, the capped and staged ones within "
          f"1e-5")
    free_cuda()


def phase_decode_partial(device, dc=DECODE):
    """The sequence-sharded decode at mistral-nemo-12b's head layout: each
    of 4 shards of a 32,768-token bf16 cache attended in part, combined by
    log-sum-exp, against the whole-cache decode and float64."""
    import torch
    from repro_torch.nn.attention import (combine_partial_decodes,
                                          decode_attend,
                                          decode_attend_partial)
    B, H, Kh, D, T = (dc["batch"], dc["heads"], dc["kv_heads"],
                      dc["head_dim"], dc["seq"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn((B, 1, H, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    k = torch.randn((B, T, Kh, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    v = torch.randn((B, T, Kh, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    valid = torch.ones((B, T), dtype=torch.bool, device=device)
    valid[0, T - dc["masked_tail"]:] = False    # a short sequence
    n = T // dc["shards"]
    full = decode_attend(q, k, v, valid).float()
    t0 = time.perf_counter()
    parts = [decode_attend_partial(q, k[:, i * n:(i + 1) * n],
                                   v[:, i * n:(i + 1) * n],
                                   valid[:, i * n:(i + 1) * n])
             for i in range(dc["shards"])]
    comb = combine_partial_decodes(*(torch.stack(x) for x in zip(*parts)))
    sync(comb)
    secs = time.perf_counter() - t0
    G = H // Kh
    qg = q.double().reshape(B, Kh, G, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.double()) / D ** 0.5
    logits = torch.where(valid[:, None, None, :], logits, -float("inf"))
    ref = torch.einsum("bkgt,btkd->bkgd", torch.softmax(logits, dim=-1),
                       v.double()).reshape(B, 1, H, D)
    scale = torch.clamp(ref.abs(), min=1.0)
    e_cf = float(((comb - full).abs() / scale).max())
    e_c64 = float(((comb.double() - ref).abs() / scale).max())
    e_f64 = float(((full.double() - ref).abs() / scale).max())
    check(comb.shape == (B, 1, H, D) and bool(torch.isfinite(comb).all()),
          "[decode-partial] non-finite or misshapen output")
    check(e_cf <= DECODE_TOL, f"[decode-partial] combined vs decode_attend "
                              f"{e_cf:.3e} > {DECODE_TOL}")
    print(f"[decode-partial] B {B}, {H} query heads over {Kh} KV heads, D "
          f"{D}, bf16 cache of {T} tokens ({dc['masked_tail']} masked at "
          f"the tail of sequence 0) in {dc['shards']} shards: combined vs "
          f"decode_attend max |diff|/max(1,|ref|) {e_cf:.3e} (tolerance "
          f"{DECODE_TOL}); vs float64: combined {e_c64:.3e}, whole-cache "
          f"decode {e_f64:.3e}; partials + combine {secs * 1e3:.3f} ms "
          f"(first call, host clock)")


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


# ------------------------------------------------------ the zoo's training
# the zoo's train steps. [lm-train]: mistral-nemo-12b at its published
# widths and train_4k shape (batch 256 x seq 4096), bf16 compute over f32
# parameters and Adam, depth cut from 40 layers to `lm_layers` (1.887 B
# f32 parameters, 7.55 GB; Adam's update holds ~8 such trees), the batch
# in `lm_accum` microbatches of 2 x 4096, `lm_steps` steps on
# token_batches(seed 0) (one: a step takes ~49 s, and the script, with
# the tooling's phases, took 1,134.9 s of its 1,200 s limit with two),
# then the loss of the updated parameters on the first microbatch.
# [rs-train]: two-tower-retrieval at its published widths, batch 65,536
# and temperature, f32, the tables cut to
# configs/two_tower_retrieval.py's TRAIN_USER_VOCAB / TRAIN_ITEM_VOCAB,
# `rs_steps` steps. [train-zoo-parity]: the reduced configs, card vs CPU
# (TF32 off), `parity_steps` steps of lm_step on [256, parity_seq] tokens
# (grad_accum 8) and of train_batch at `rs_parity_batch`.
ZOO = dict(lm_layers=2, lm_accum=128, lm_steps=1, rs_steps=3,
           parity_seq=32, parity_steps=2, rs_parity_batch=256, descent=0.05,
           moved=1.0, blowup=3.0)
# [lm-train]'s loss falls along its gradient: on the first microbatch,
# params - t g with t = descent / ||g||^2 (a first-order fall of `descent`
# nats) must lower the loss by at least half that. JAX's recipe itself
# (Adam at a constant 3e-4, no warmup) raises the loss at this width: the
# first step moves every weight by ~lr sign(g), so an output of a
# 5,120-wide row moves by ~lr sum |x_i| ~ 1.2, as large as the outputs
# themselves. Step 0's loss, the init's, lies within [ln V, ln V + 1]
# (logits of unit spread: ln V + 1/2). After the step the loss on the
# first microbatch must be finite, moved by at least `moved` nats from
# the init's (the recipe's first step raised it 12.300 -> 23.052 on the
# next batch in two-step runs; a step that updates nothing moves it by
# 0) and below `blowup` x ln V
# card vs CPU after a train step: loss within ZOO_LOSS_TOL x |cpu|,
# parameters and Adam's moments within ZOO_STATE_TOL absolute, and the
# moments also within ZOO_MOMENT_RTOL x max |cpu| per leaf (v ~ 1e-3 g^2
# lies far below ZOO_STATE_TOL) (the CPU parity tests' bounds against
# JAX, tests/test_torch_train_zoo.py). At
# full width [rs-train] holds the loss through kernel 4 to the plain
# lookup's within ZOO_LOSS_TOL, and the table gradients through kernel 1
# to the plain backward's on the same forward within ZOO_GRAD_TOL x max
# |plain| per table (a row sums a few records: f32 sums in another
# order). Gradients through two forwards are not compared element by
# element: a relu unit within rounding of 0 takes its kink one way in one
# and the other way in the other, and the gradient of a bag row reached
# through it jumps (on an H100 at train_batch's full width: 5% of the
# table's max |grad|)
ZOO_LOSS_TOL, ZOO_STATE_TOL, ZOO_GRAD_TOL = 1e-5, 1e-5, 1e-5
ZOO_MOMENT_RTOL = 1e-4


def zoo_bag_case(gen, B, W, V, d, device):
    """A [V, d] table, [B, W] bag ids as the two-tower draws them
    (random_bag_ids) and a [B, d] output gradient."""
    import torch
    from repro_torch.launch.serve import random_bag_ids
    table = torch.randn(V, d, generator=gen, device=device)
    ids = random_bag_ids(gen, (B, W), V)
    w = torch.randn(B, d, generator=gen, device=device)
    return table, ids, w


def zoo_bag_grad_check(eb, eb_ref, seg, w, ids, V, mode, what):
    """Kernel 1's bag backward against the plain table gradient: per
    element |diff| <= KA_TOL x (1 + the row's sum of |w| / count), the
    plain gradient of |w| (f32 sums of the same rows in another order).
    Returns (max abs err, the kernel's gradient)."""
    seg.reset_launches()
    got = eb.embedding_bag_grad(w, ids, V, mode)
    sync(got)
    check(not w.is_cuda or seg.LAUNCHES["segment_sum_rows"] == 1,
          f"{what}: the bag backward launched kernel 1 "
          f"{seg.LAUNCHES['segment_sum_rows']} times")
    want = eb_ref.embedding_bag_grad_ref(w, ids, V, mode)
    mag = eb_ref.embedding_bag_grad_ref(w.abs(), ids, V, mode)
    err = (got - want).abs()
    worst = float(err.max())
    check(bool((err <= KA_TOL * (1 + mag)).all()),
          f"{what}: bag backward vs plain, max err {worst}")
    del want, mag, err
    return worst, got


def phase_train_zoo_kernel(device, z=ZOO):
    """Kernel 4 at the two-tower's training forward and kernel 1 at its
    backward (the table gradient), at both towers' train_batch call sites,
    against their plain versions; through autograd (one launch of each,
    the gradient the direct call's bit for bit); then both timed at the
    user call site beside their bounds, plain versions and library calls.
    Returns the two `kernels` entries without their main-path launches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.kernels.embedding_bag import ops as eb, ref as eb_ref
    from repro_torch.kernels.segment_reduce import ops as seg
    c = tt.CONFIG
    B = tt.SHAPES["train_batch"].dims["batch"]
    W, d = c.max_ids_per_field, c.embed_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    errs = {"fwd": 0.0, "bwd": 0.0}
    sides = (("item", B * c.item_fields, tt.TRAIN_ITEM_VOCAB),
             ("user", B * c.user_fields, tt.TRAIN_USER_VOCAB))
    for side, n_bags, V in sides:
        table, ids, w = zoo_bag_case(gen, n_bags, W, V, d, device)
        for mode in ("mean", "sum"):
            e, _ = eb_check(eb, eb_ref, table, ids, mode)
            errs["fwd"] = max(errs["fwd"], e)
            e, got = zoo_bag_grad_check(eb, eb_ref, seg, w, ids, V, mode,
                                        f"{side} bags, {mode}")
            errs["bwd"] = max(errs["bwd"], e)
            # through autograd: kernel 4 forward, kernel 1 backward
            leaf = table.detach().requires_grad_()
            eb.reset_launches()
            seg.reset_launches()
            (auto,) = torch.autograd.grad(eb.embedding_bag(leaf, ids, mode),
                                          leaf, w)
            check(device.type != "cuda" or (
                eb.LAUNCHES["embedding_bag"] == 1
                and seg.LAUNCHES["segment_sum_rows"] == 1),
                  f"{side} bags under autograd launched {eb.LAUNCHES}, "
                  f"{seg.LAUNCHES}")
            check(torch.equal(auto, got), f"{side} bags: the autograd "
                                          "gradient is not the direct call's")
            del got, auto
        n_valid = int((ids >= 0).sum())
        print(f"[train-zoo-kernel] {side} call site: {n_bags} bags of W={W} "
              f"({n_valid} valid ids) over a [{V}, {d}] f32 table: "
              f"forward vs plain and backward (the dense table gradient) "
              f"vs plain passed, mean and sum; through autograd one launch "
              f"of each kernel, the gradient the direct call's bit for bit")
        if side == "item":
            del table, ids, w
            free_cuda()
    print(f"[train-zoo-kernel] max abs err: forward {errs['fwd']:.3e} "
          f"(tolerance {EB_TOL} x (1 + sum |w row|)), backward "
          f"{errs['bwd']:.3e} (tolerance {KA_TOL} x (1 + sum |g| / cnt))")

    # timing at the user call site (mean, as the towers run)
    valid = ids >= 0
    n_valid = int(valid.sum())
    flat = ids[valid]
    offsets = torch.zeros(ids.shape[0], dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)[:-1]
    fwd_ms = time_ms(lambda: eb.embedding_bag(table, ids, "mean"))
    fwd_plain = time_ms(lambda: eb_ref.embedding_bag_ref(table, ids, "mean"))
    fwd_lib = time_ms(lambda: F.embedding_bag(flat, table, offsets,
                                              mode="mean"))
    n_bags = ids.shape[0]
    fwd_bytes = n_valid * d * 4 + ids.numel() * ids.element_size() \
        + n_bags * d * 4
    fwd_ops = n_valid * d + n_bags * d
    fwd_bound = bound_ms(fwd_bytes, fwd_ops)
    fwd_by = "bytes" if fwd_bytes / PEAK_BYTES_PER_S > \
        fwd_ops / PEAK_F32_OPS_PER_S else "operations"
    print(f"[train-zoo-kernel] embedding_bag at the training forward "
          f"(user side, {n_bags} bags, {n_valid} valid ids, a "
          f"[{V}, {d}] table): {fwd_ms:.4f} ms; bound {fwd_bound:.4f} ms "
          f"by {fwd_by} ({fwd_bytes} bytes); plain {fwd_plain:.4f} ms; "
          f"F.embedding_bag {fwd_lib:.4f} ms")
    rows_idx = flat.to(torch.int64)
    counts = valid.sum(dim=1).clamp(min=1).to(torch.float32)
    g_rows = (w / counts[:, None])[:, None, :].expand(
        n_bags, W, d)[valid].contiguous()
    bwd_ms = time_ms(lambda: eb.embedding_bag_grad(w, ids, V, "mean"))
    bwd_plain = time_ms(lambda: eb_ref.embedding_bag_grad_ref(w, ids, V,
                                                              "mean"))
    bwd_lib = time_ms(lambda: torch.zeros(V, d, device=device).index_add_(
        0, rows_idx, g_rows))
    # the function reads grad_out and the ids once and writes the dense
    # gradient once; an add per valid id's element, a division per bag's
    bwd_bytes = n_bags * d * 4 + ids.numel() * ids.element_size() \
        + V * d * 4
    bwd_ops = n_valid * d + n_bags * d
    bwd_bound = bound_ms(bwd_bytes, bwd_ops)
    bwd_by = "bytes" if bwd_bytes / PEAK_BYTES_PER_S > \
        bwd_ops / PEAK_F32_OPS_PER_S else "operations"
    print(f"[train-zoo-kernel] the bag backward on kernel 1 (sort_runs + "
          f"deliver_rows; user side, {n_valid} records into {V} rows, d "
          f"{d}): {bwd_ms:.4f} ms; bound {bwd_bound:.4f} ms by {bwd_by} "
          f"({bwd_bytes} bytes); plain (zeros + index_add_ of the "
          f"expanded rows) {bwd_plain:.4f} ms; zeros + index_add_ of "
          f"pre-expanded rows {bwd_lib:.4f} ms")
    del table, ids, w, flat, offsets, rows_idx, g_rows, valid, counts
    free_cuda()
    return [
        {"name": "embedding_bag (two-tower training forward)",
         "route": "cuda", "source": "src/repro_torch/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag/kernel.py:43",
         "launches": None, "max_abs_err": errs["fwd"], "ms": fwd_ms,
         "plain_ms": fwd_plain, "bound_ms": fwd_bound, "bound_by": fwd_by,
         "library_ms": fwd_lib},
        {"name": "segment_sum_rows (embedding-bag backward)",
         "route": "cuda", "source": "src/repro_torch/csrc/segment_reduce.cu",
         "replaces": "src/repro/kernels/segment_reduce/kernel.py:59",
         "launches": None, "max_abs_err": errs["bwd"], "ms": bwd_ms,
         "plain_ms": bwd_plain, "bound_ms": bwd_bound, "bound_by": bwd_by,
         "library_ms": bwd_lib}]


def zoo_runs_match(tag, cpu_runs, card_runs):
    """Card vs CPU after each train step (ZOO_LOSS_TOL, ZOO_STATE_TOL,
    ZOO_MOMENT_RTOL). Returns (max loss rel err, max state abs err, max
    moment err / max |cpu| of its leaf)."""
    e_loss = e_state = e_moment = 0.0
    for i, ((lc, pc, sc), (lg, pg, sg)) in enumerate(zip(cpu_runs,
                                                         card_runs)):
        e = abs(float(lg) - float(lc)) / abs(float(lc))
        check(e <= ZOO_LOSS_TOL, f"[{tag}] step {i}: loss card "
                                 f"{float(lg)} vs CPU {float(lc)}")
        e_loss = max(e_loss, e)
        for name in pc:
            for what, a, b in (("param", pc, pg), ("m", sc["m"], sg["m"]),
                               ("v", sc["v"], sg["v"])):
                e = float((b[name].cpu() - a[name]).abs().max())
                check(e <= ZOO_STATE_TOL, f"[{tag}] step {i}: {what} "
                                          f"{name} card vs CPU {e}")
                e_state = max(e_state, e)
                if what != "param":
                    scale = float(a[name].abs().max())
                    check(e <= ZOO_MOMENT_RTOL * scale,
                          f"[{tag}] step {i}: {what} {name} card vs CPU "
                          f"{e} > {ZOO_MOMENT_RTOL} x {scale}")
                    e_moment = max(e_moment, e / scale if scale else e)
        check(int(sg["t"]) == int(sc["t"]) == i + 1, f"[{tag}] step count")
    return e_loss, e_state, e_moment


def phase_train_zoo_parity(device, z=ZOO):
    """The reduced LM's lm_step("train_4k") and the reduced two-tower's
    train_batch, built on the CPU from a seed and copied to the card (f32,
    TF32 off): loss, parameters and Adam's moments after each step, card
    vs CPU; on the card the LM launches no flash kernel, each two-tower
    step kernel 4 twice and kernel 1 twice."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.mistral_nemo_12b import REDUCED
    from repro_torch.data.streams import token_batches
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.segment_reduce import ops as seg
    from repro_torch.launch.serve import random_bag_ids
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    torch.backends.cuda.matmul.allow_tf32 = False

    def run(spec, shape, batches, to_args):
        cpu = spec.build_reduced(device="cpu", seed=SEED, train=True)
        card = spec.build_reduced(device=device, seed=SEED + 1, train=True)
        card.load_state_dict(cpu.state_dict())
        runs = {}
        for model in (cpu, card):
            step = spec.step(model, shape)
            p = param_tree(model)
            s = adam().init(p)
            runs[model.device.type] = out = []
            for reset in (fa.reset_launches, eb.reset_launches,
                          seg.reset_launches):
                reset()
            for b in batches:
                p, s, loss = step(p, s, *to_args(b, model.device))
                out.append((loss, p, s))
        return runs[device.type], runs["cpu"]

    lm = get_arch("mistral-nemo-12b")
    data = list(token_batches(SEED, REDUCED.vocab, 256, z["parity_seq"],
                              z["parity_steps"]))
    card_runs, cpu_runs = run(lm, "train_4k", data, lambda b, dev: (
        torch.as_tensor(b[0], device=dev), torch.as_tensor(b[1],
                                                           device=dev)))
    if device.type == "cuda":
        check(fa.LAUNCHES["flash_attention"] == 0,
              f"the LM train step launched the flash kernel: {fa.LAUNCHES}")
    lm_err = zoo_runs_match("train-zoo-parity", cpu_runs, card_runs)
    tt = get_arch("two-tower-retrieval")
    c = tt.build_reduced(device="cpu").cfg
    gen = torch.Generator().manual_seed(SEED)
    n = z["rs_parity_batch"]
    batches = [{"user_ids": random_bag_ids(gen, (n, c.user_fields,
                                                 c.max_ids_per_field),
                                           c.user_vocab),
                "item_ids": random_bag_ids(gen, (n, c.item_fields,
                                                 c.max_ids_per_field),
                                           c.item_vocab),
                "item_logq": torch.randn(n, generator=gen) - 5.0}
               for _ in range(z["parity_steps"])]
    card_runs, cpu_runs = run(tt, "train_batch", batches, lambda b, dev: (
        {k: v.to(dev) for k, v in b.items()},))
    if device.type == "cuda":
        n_steps = z["parity_steps"]
        check(eb.LAUNCHES["embedding_bag"] == 2 * n_steps
              and seg.LAUNCHES["segment_sum_rows"] == 2 * n_steps,
              f"{n_steps} reduced train_batch steps launched "
              f"{eb.LAUNCHES}, {seg.LAUNCHES}")
    tt_err = zoo_runs_match("train-zoo-parity", cpu_runs, card_runs)
    print(f"[train-zoo-parity] reduced LM, {z['parity_steps']} lm_step "
          f"train_4k steps on [256, {z['parity_seq']}] tokens (grad_accum "
          f"8), card vs CPU: loss rel err {lm_err[0]:.3e}, params and "
          f"Adam moments max abs err {lm_err[1]:.3e}, moments "
          f"{lm_err[2]:.3e} of their leaf's max; no flash launch")
    print(f"[train-zoo-parity] reduced two-tower, {z['parity_steps']} "
          f"train_batch steps of {n}: loss rel err {tt_err[0]:.3e}, state "
          f"max abs err {tt_err[1]:.3e}, moments {tt_err[2]:.3e} of their "
          f"leaf's max; kernels 4 and 1 twice a step (tolerances: loss "
          f"{ZOO_LOSS_TOL} x |cpu|, state {ZOO_STATE_TOL}, moments "
          f"{ZOO_MOMENT_RTOL} x max |cpu|)")
    free_cuda()


def lm_train_flops(cfg, B, S):
    """FLOPs of one train_4k step as the port runs it: the forward's
    matmuls (2 per multiply-add; attention over all T keys a query block,
    as mha_chunked takes it), times 4: the forward, the rematerialised
    forward of every layer and loss chunk, and the backward's two."""
    d, H, Kh, D = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    per_tok = cfg.n_layers * (2 * d * D * (2 * H + 2 * Kh)
                              + 2 * 3 * d * cfg.d_ff) + 2 * d * cfg.vocab
    attn = cfg.n_layers * 4 * B * S * S * H * D
    return 4 * (per_tok * B * S + attn)


def phase_lm_train(device, z=ZOO):
    """mistral-nemo-12b train_4k at its published widths, depth cut (ZOO):
    the gradient of the first microbatch is a descent direction (ZOO's
    `descent`); then `lm_steps` steps of lm_step through the spec's entry
    point on token_batches: finite losses, step 0's at the init's, no
    flash launch, the updated parameters' loss on the first microbatch
    finite, moved and not blown up (ZOO's `moved`, `blowup`); step
    seconds, tokens/s, the FLOPs' bf16 bound, peak
    memory, and one microbatch's forward and backward under
    torch.profiler."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.data.streams import token_batches
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.configs.base import value_and_grad
    from repro_torch.nn.module import (bind_params, param_bytes,
                                       param_count, param_tree)
    from repro_torch.nn.transformer import TransformerLM
    from repro_torch.optim import adam
    spec = get_arch("mistral-nemo-12b")
    cfg = dataclasses.replace(CONFIG, n_layers=z["lm_layers"])
    dims = spec.shapes["train_4k"].dims
    B, S = dims["batch"], dims["seq"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device, seed=SEED, train=True)
    params = param_tree(model)
    sync(params["lm_head"])
    build_s = time.perf_counter() - t0
    data = [(torch.as_tensor(t, device=device),
             torch.as_tensor(lab, device=device))
            for t, lab in token_batches(SEED, cfg.vocab, B, S,
                                        z["lm_steps"])]
    # the first microbatch's loss falls along its gradient
    mb = B // z["lm_accum"]
    toks0, labs0 = data[0][0][:mb], data[0][1][:mb]
    loss0, g = value_and_grad(model, model.loss, params, toks0, labs0)
    gn2 = float(sum(x.float().square().sum() for x in g.values()))
    t_step = z["descent"] / gn2
    moved = {n: p - t_step * g[n] for n, p in params.items()}
    del g
    # through value_and_grad as loss0, so both take the training route
    loss1 = float(value_and_grad(model, model.loss, moved, toks0, labs0)[0])
    del moved
    fell = float(loss0) - loss1
    check(fell >= 0.5 * z["descent"], f"[lm-train] params - t g lowered "
                                      f"the loss by {fell}, expected "
                                      f"~{z['descent']}")
    print(f"[lm-train] descent check on microbatch 0 ({mb} x {S}): loss "
          f"{float(loss0):.6f}, ||g|| {gn2 ** 0.5:.4f}; at params - t g, t "
          f"= {z['descent']} / ||g||^2, {loss1:.6f}: fell {fell:.6f} "
          f"(first order {z['descent']})")
    if cuda:
        profile_call("lm-train", f"one microbatch's forward and backward "
                                 f"({mb} x {S} tokens)",
                     lambda: value_and_grad(model, model.loss, params, toks0,
                                            labs0), top=14)
    free_cuda()
    state = adam().init(params)
    step = spec.step(model, "train_4k", grad_accum=z["lm_accum"])
    print(f"[lm-train] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv} kv, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_layers} of 40 layers; "
          f"{param_count(model)} f32 params ({param_bytes(model)} bytes) "
          f"and Adam's m, v drawn on the device in {build_s:.2f}s; batch "
          f"{B} x seq {S} in {z['lm_accum']} microbatches, compute "
          f"{cfg.dtype}, q_chunk {cfg.q_chunk}, loss_chunks "
          f"{cfg.loss_chunks}, remat {cfg.remat}")
    fa.reset_launches()
    losses, secs = [], []
    for toks, labels in data:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, toks, labels)
        bind_params(model, params)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
        print(f"[lm-train] step {len(losses) - 1}: loss {losses[-1]:.6f} "
              f"in {secs[-1]:.3f} s ({B * S / secs[-1]:.1f} tokens/s)")
    # the update itself: the updated parameters' loss on microbatch 0,
    # through value_and_grad as loss0 (the training route)
    after = float(value_and_grad(model, model.loss, params, toks0,
                                 labs0)[0])
    launches = fa.LAUNCHES["flash_attention"]
    check(all(math.isfinite(x) for x in losses), f"[lm-train] losses "
                                                  f"{losses}")
    ln_v = math.log(cfg.vocab)
    print(f"[lm-train] after {len(losses)} step(s), microbatch 0's loss "
          f"{after:.6f} (at the init {float(loss0):.6f}; ln V {ln_v:.4f})")
    check(math.isfinite(after) and abs(after - float(loss0)) >= z["moved"]
          and after <= z["blowup"] * ln_v,
          f"[lm-train] the updated parameters' loss {after} on microbatch "
          f"0: not finite, moved less than {z['moved']} from the init's "
          f"{float(loss0)}, or above {z['blowup']} ln V")
    check(ln_v <= losses[0] <= ln_v + 1, f"[lm-train] step 0's loss "
                                         f"{losses[0]} is not the init's "
                                         f"(ln V = {ln_v})")
    check(launches == 0, f"[lm-train] the train step launched the flash "
                         f"kernel {launches} times")
    flops = lm_train_flops(cfg, B, S)
    bound = flops / PEAK_BF16_OPS_PER_S
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"[lm-train] {len(losses)} steps, {B * S} tokens each: per step "
          + ", ".join(f"{s:.3f} s" for s in secs)
          + f"; {B * S * len(secs) / sum(secs):.1f} tokens/s; "
          f"{flops} FLOPs a step ({flops / min(secs) / 1e12:.1f} TFLOP/s at "
          f"the fastest step), {bound:.3f} s at the bf16 peak; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (ln vocab {ln_v:.4f}); "
          f"flash launches {launches}; peak "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    del model, params, state, step, data, toks0, labs0
    free_cuda()
    return {"losses": losses, "secs": secs}


def phase_rs_train(device, z=ZOO):
    """two-tower-retrieval train_batch at its published widths and batch,
    the tables cut for training: the first batch's loss and gradient
    through the kernels (kernel 4 twice forward, kernel 1 twice backward)
    against the plain lookup's autograd; then `rs_steps` timed steps
    through the spec's entry point, each launching both kernels twice.
    Returns the launches of the timed steps."""
    import math
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import value_and_grad
    from repro_torch.kernels.embedding_bag import ops as eb, ref as eb_ref
    from repro_torch.kernels.segment_reduce import ops as seg
    from repro_torch.launch.serve import random_bag_ids
    from repro_torch.nn.module import bind_params, param_bytes, param_count
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    cuda = device.type == "cuda"
    spec = get_arch("two-tower-retrieval")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = spec.build(device=device, seed=SEED, train=True)
    c = model.cfg
    B = spec.shapes["train_batch"].dims["batch"]
    W = c.max_ids_per_field
    gen = torch.Generator(device=device).manual_seed(SEED + 6)

    def batch():
        # item_logq: log of a sampling probability near uniform over the
        # table, spread as a frequency estimate would be
        return {"user_ids": random_bag_ids(gen, (B, c.user_fields, W),
                                           c.user_vocab),
                "item_ids": random_bag_ids(gen, (B, c.item_fields, W),
                                           c.item_vocab),
                "item_logq": -math.log(c.item_vocab) + 0.5 * torch.randn(
                    B, generator=gen, device=device)}

    print(f"[rs-train] {c.name}: user table "
          f"{tuple(model.user_emb.table.shape)}, item table "
          f"{tuple(model.item_emb.table.shape)} f32, embed_dim "
          f"{c.embed_dim}, towers {c.tower_mlp}, temperature "
          f"{c.temperature}; {param_count(model)} params "
          f"({param_bytes(model)} bytes); batch {B}")
    params = param_tree(model)
    b0 = batch()
    args = (b0["user_ids"], b0["item_ids"], b0["item_logq"])
    eb.reset_launches()
    seg.reset_launches()
    loss_k, g_k = value_and_grad(model, model.loss, params, *args)
    sync(loss_k)
    if cuda:
        check(eb.LAUNCHES["embedding_bag"] == 2
              and seg.LAUNCHES["segment_sum_rows"] == 2,
              f"one loss and gradient launched {eb.LAUNCHES}, {seg.LAUNCHES}")
    with torch.no_grad(), mock.patch.object(eb, "embedding_bag",
                                            eb_ref.embedding_bag_ref):
        loss_p = model.loss(*args)
    e_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(e_loss <= ZOO_LOSS_TOL, f"[rs-train] loss kernels {float(loss_k)} "
                                  f"vs plain {float(loss_p)}")
    with mock.patch.object(eb, "embedding_bag_grad",
                           eb_ref.embedding_bag_grad_ref):
        _, g_p = value_and_grad(model, model.loss, params, *args)
    e_grad = {}
    for name in ("user_emb.table", "item_emb.table"):
        scale = float(g_p[name].abs().max())
        err = float((g_k[name] - g_p[name]).abs().max())
        check(err <= ZOO_GRAD_TOL * scale, f"[rs-train] grad {name}: "
                                           f"kernel 1 vs plain {err} > "
                                           f"{ZOO_GRAD_TOL} x {scale}")
        e_grad[name] = err / max(scale, 1e-30)
    print(f"[rs-train] the first batch: loss through kernel 4 "
          f"{float(loss_k):.6f} vs the plain lookup's, rel err "
          f"{e_loss:.3e}; the tables' gradients through kernel 1 vs the "
          f"plain backward on the same forward, max err / max |plain| "
          + ", ".join(f"{n} {e:.3e}" for n, e in e_grad.items())
          + f" (tolerances {ZOO_LOSS_TOL}, {ZOO_GRAD_TOL})")
    del g_k, g_p, loss_p
    free_cuda()
    step = spec.step(model, "train_batch")
    state = adam().init(params)
    eb.reset_launches()
    seg.reset_launches()
    losses, secs = [], []
    for i in range(z["rs_steps"]):
        b = b0 if i == 0 else batch()
        sync(b["item_logq"])
        t0 = time.perf_counter()
        params, state, loss = step(params, state, b)
        bind_params(model, params)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
    launches = {"embedding_bag": eb.LAUNCHES["embedding_bag"],
                "segment_sum_rows": seg.LAUNCHES["segment_sum_rows"]}
    n = z["rs_steps"]
    if cuda:
        check(launches == {"embedding_bag": 2 * n,
                           "segment_sum_rows": 2 * n},
              f"[rs-train] {n} steps launched {launches}")
    check(all(math.isfinite(x) for x in losses), f"[rs-train] {losses}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"[rs-train] {n} train_batch steps of {B}: per step "
          + ", ".join(f"{s * 1e3:.3f} ms" for s in secs)
          + f"; {B * n / sum(secs):.1f} examples/s; loss "
          + " -> ".join(f"{x:.4f}" for x in losses)
          + f" (ln batch {math.log(B):.4f}); launches {launches}; peak "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if cuda:
        b = batch()
        profile_call("rs-train", "one train_batch step",
                     lambda: step(params, state, b), top=10)
    del model, params, state, step, b0
    free_cuda()
    return launches


def phase_train_cli(device):
    """`python -m repro_torch.launch.train --reduced --steps 3` for both
    archs as subprocesses, on the device (CUDA: no --device flag)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape in (("mistral-nemo-12b", "train_4k"),
                        ("two-tower-retrieval", "train_batch")):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               arch, "--shape", shape, "--reduced", "--steps", "3"]
        if device.type != "cuda":
            cmd += ["--device", str(device)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, cwd=str(ROOT),
                              capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        check(proc.returncode == 0, f"[train-cli] {arch} exited "
                                    f"{proc.returncode}:\n{proc.stdout}\n"
                                    f"{proc.stderr[-4000:]}")
        check(len(lines) == 4 and lines[-1] == "train driver done"
              and all(line.startswith(f"step {i}: loss=")
                      for i, line in enumerate(lines[:3])),
              f"[train-cli] {arch} printed {lines}")
        print(f"[train-cli] {arch} --shape {shape} --reduced --steps 3 "
              f"({secs:.1f} s with the interpreter's start): "
              + "; ".join(lines))


# ------------------------------------------------------- the graph zoo
# [gnn-*]: pna, gatedgcn, dimenet and nequip at minibatch_lg's published
# widths (configs/gnn_common.py) on one batch of the port's sampler: 1,024
# seeds drawn uniformly, fanout (15, 10), over a powerlaw_edges global
# graph of 232,965 nodes (reddit's) with 602 standard-normal features and
# 41 classes; the loss is on the seeds. `global_edges` is cut 5x from the
# shape's 114,615,892 so that drawing them and sorting their CSR fit this
# phase's 20 s allowance on the H100 machine's host (the times of each
# count tried: PERF.md §4). Each node still has far more in-edges than
# the fanout draws, so the batch's statistics barely move with the cut.
# The degree law is powerlaw_edges' at alpha 0.5: rank k draws a share
# ~ k^-0.5 of the edges, a degree distribution P(d) ~ d^-3, preferential
# attachment's. Its top node's expected in-degree, E / sum(k^-0.5) =
# 118,912 at the full edge count, stays under N - 1 = 232,964, the most
# any node of a simple graph of reddit's size can have; the default
# alpha 1.5 gives that node 38% of all edges (43.9 M), so a batch held
# ~5,100 distinct nodes of 169,984 rows and runs of ~58,000 edges into
# one row. The run checks that bound on the drawn graph and prints the
# batch's distinct-node share. DimeNet and NequIP get
# positions 3 x N(0, 1) (erdos_graph's), DimeNet triplets capped at 4 x
# the edge cap; then both again at `molecule` (128 graphs x 30 nodes x 64
# edges, energy MSE). `steps` timed steps a model; the loss falls along
# its gradient: params - t g with t = descent x |loss| / ||g||^2 must
# lower the loss by at least half of descent x |loss|.
GNN = dict(global_nodes=232_965, global_edges=22_923_178, alpha=0.5,
           d_feat=602, n_classes=41, seeds=1024, fanout=(15, 10), steps=3,
           descent=1e-3, molecule=(128, 30, 64), profile_top=8,
           rmi_rows=262_144, rmi_records=1_052_672, rmi_live=400_000,
           rmi_reads=8192, rmi_d=602, pna_d=75)
# [gnn-parity] card vs CPU, the CPU parity tests' bounds
# (tests/test_torch_zoo_harness.py): forward within GNN_FWD_TOL x (1 + |cpu|);
# gradients, parameters and Adam's moments after each of two steps within
# GNN_LEAF_TOL x max |cpu| per leaf; losses within GNN_FWD_TOL x |cpu|.
# PNA's gradients and steps run in float64, as in the CPU tests (its std
# aggregator cancels in f32: the reference's own f32 gradient lies ~1e-4
# of a leaf's max from float64)
GNN_FWD_TOL, GNN_LEAF_TOL = 1e-5, 1e-4
GNN_PARITY = ("pna", "gatedgcn", "dimenet", "nequip", "gat", "gcn")


def gnn_global_graph(g=GNN):
    """The global graph: powerlaw_edges, its in-edge CSR and the node
    features, drawn from numpy seeds; returns (csr, feats, seconds of the
    edges and CSR, seconds of the features)."""
    from repro_torch.graph.graphs import powerlaw_edges
    from repro_torch.graph.sampler import CSRGraph
    rng = np.random.default_rng(SEED + 20)
    t0 = time.perf_counter()
    edges = powerlaw_edges(rng, g["global_nodes"], g["global_edges"],
                           g["alpha"])
    csr = CSRGraph.from_edges(edges[:, 0], edges[:, 1], g["global_nodes"])
    build_s = time.perf_counter() - t0
    del edges
    top = int(np.diff(csr.indptr).max())
    check(top <= g["global_nodes"] - 1, f"[gnn] a node has {top} in-edges, "
          f"more than a simple graph of {g['global_nodes']} nodes allows")
    t0 = time.perf_counter()
    feats = rng.standard_normal((g["global_nodes"], g["d_feat"]),
                                dtype=np.float32)
    return csr, feats, build_s, time.perf_counter() - t0


def gnn_minibatch(device, g=GNN):
    """One minibatch_lg batch of the sampler, padded to the shape's caps,
    as a dict of tensors on `device` (input_specs' names), with `pos` and
    DimeNet's triplets; prints how it was made. Returns (batch, info)."""
    import torch
    from repro_torch.configs.gnn_common import GNN_SHAPES, pad512
    from repro_torch.graph.sampler import sample_subgraph
    from repro_torch.graph.triplets import build_triplets
    dims = GNN_SHAPES["minibatch_lg"].dims
    csr, feats, build_s, feat_s = gnn_global_graph(g)
    rng = np.random.default_rng(SEED + 21)
    deg = np.diff(csr.indptr)
    seeds = rng.choice(g["global_nodes"], g["seeds"], replace=False)
    t0 = time.perf_counter()
    sub, local_seeds, _ = sample_subgraph(rng, csr, seeds, g["fanout"],
                                          feats)
    sample_s = time.perf_counter() - t0
    del csr, feats
    N, E = int(sub.node_mask.sum()), int(sub.edge_mask.sum())
    caps = (sub.n_nodes, sub.n_edges)
    check(g["seeds"] != 1024 or caps == (dims["n_nodes"], dims["n_edges"])
          == tuple(map(pad512, caps)), f"[gnn] the sampler's caps {caps} "
          f"are not minibatch_lg's {dims['n_nodes']}, {dims['n_edges']}")
    labels = np.zeros(sub.n_nodes, np.int64)
    labels[:N] = rng.integers(0, g["n_classes"], N)
    label_mask = np.zeros(sub.n_nodes, bool)
    label_mask[local_seeds] = True
    pos = np.zeros((sub.n_nodes, 3), np.float32)
    pos[:N] = 3.0 * rng.normal(size=(N, 3))
    t_max = pad512(4 * sub.n_edges)
    t0 = time.perf_counter()
    kj, ji, tmask = build_triplets(sub.senders[:E].numpy(),
                                   sub.receivers[:E].numpy(), sub.n_nodes,
                                   t_max)
    trip_s = time.perf_counter() - t0
    batch = {"senders": sub.senders, "receivers": sub.receivers,
             "x": sub.x, "edge_mask": sub.edge_mask,
             "node_mask": sub.node_mask, "labels": torch.as_tensor(labels),
             "label_mask": torch.as_tensor(label_mask),
             "pos": torch.as_tensor(pos), "t_kj": torch.as_tensor(kj,
                                                               dtype=torch.int64),
             "t_ji": torch.as_tensor(ji, dtype=torch.int64),
             "t_mask": torch.as_tensor(tmask)}
    batch = {k: v.to(device) for k, v in batch.items()}
    run = int(np.bincount(sub.receivers[:E].numpy()).max()) if E else 0
    print(f"[gnn] global graph: {g['global_nodes']} nodes, "
          f"{g['global_edges']} powerlaw_edges (alpha {g['alpha']}) and "
          f"their CSR in {build_s:.2f} s, {g['d_feat']} f32 features in "
          f"{feat_s:.2f} s; in-degree mean {deg.mean():.2f}, median "
          f"{int(np.median(deg))}, max {int(deg.max())}, "
          f"{int((deg < g['fanout'][0]).sum())} nodes under "
          f"{g['fanout'][0]}; {g['seeds']} uniform seeds sampled at fanout "
          f"{g['fanout']} in {sample_s:.2f} s: {N} distinct nodes of "
          f"{sub.n_nodes} rows ({N / sub.n_nodes:.4f}), {E} of "
          f"{sub.n_edges} edges, the longest run into one row {run}; "
          f"{int(tmask.sum())} triplets of {t_max} in {trip_s:.2f} s")
    return batch, {"build_s": build_s, "nodes": N, "edges": E}


def gnn_molecule_batch(device, seed, g=GNN):
    """`molecule`: batch_molecules' graphs padded to the shape's caps
    (pad512), energy targets N(0, 1), and triplets capped at 4 x E."""
    import torch
    from repro_torch.configs.gnn_common import GNN_SHAPES, pad512
    from repro_torch.graph.graphs import batch_molecules
    from repro_torch.graph.triplets import build_triplets
    dims = GNN_SHAPES["molecule"].dims
    n_graphs, nodes_per, edges_per = g["molecule"]
    rng = np.random.default_rng(seed)
    mol = batch_molecules(rng, n_graphs, nodes_per, edges_per,
                          dims["d_feat"])
    N, E = mol.n_nodes, mol.n_edges
    Np, Ep = pad512(dims["n_nodes"]), pad512(dims["n_edges"])

    def pad(t, n):
        out = torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype)
        out[:t.shape[0]] = t
        return out

    kj, ji, tmask = build_triplets(mol.senders.numpy(),
                                   mol.receivers.numpy(), Np, pad512(4 * Ep))
    batch = {"senders": pad(mol.senders, Ep),
             "receivers": pad(mol.receivers, Ep), "x": pad(mol.x, Np),
             "edge_mask": torch.arange(Ep) < E,
             "node_mask": torch.arange(Np) < N, "pos": pad(mol.pos, Np),
             "graph_ids": pad(mol.graph_ids, Np),
             "targets": torch.as_tensor(rng.normal(size=n_graphs),
                                        dtype=torch.float32),
             "t_kj": torch.as_tensor(kj, dtype=torch.int64),
             "t_ji": torch.as_tensor(ji, dtype=torch.int64),
             "t_mask": torch.as_tensor(tmask)}
    return {k: v.to(device) for k, v in batch.items()}


def gss_within(got, want, mag):
    """gather_segment_sum against its plain version run in float64: per
    element |diff| <= KA_TOL x (1 + the row's sum of |x|). The plain
    version in f32 is no yardstick here: its index_add_ adds a hub's
    records one at a time onto a growing sum, and where the sampler
    repeats source rows (a hub's features thousands of times) those
    partial sums grow with the run, so its error does too (0.07 off the
    float64 sum of a 3,205-record row where the kernel's shares and
    carries are 0.002 off; on the H100 machine)."""
    return bool(((got.double() - want).abs() <= KA_TOL * (1 + mag)).all())


def gss_case(ops, ref, x, s, r, n, mask, what):
    """Kernel A through gather_segment_sum vs the plain version in
    float64; one launch. Returns (max abs err vs float64, the f32 plain
    version's)."""
    ops.reset_launches()
    got = ops.gather_segment_sum(x, s, r, n, mask)
    sync(got)
    check(not x.is_cuda or ops.LAUNCHES["segment_sum_rows"] == 1,
          f"[gnn-kernel] {what}: {ops.LAUNCHES}")
    want = ref.gather_segment_sum_ref(x.double(), s, r, n, mask)
    mag = ref.gather_segment_sum_ref(x.abs(), s, r, n, mask)
    check(gss_within(got, want, mag), f"[gnn-kernel] {what}: max err "
                                      f"{float((got - want).abs().max())}")
    plain = ref.gather_segment_sum_ref(x, s, r, n, mask)
    return (float((got.double() - want).abs().max()),
            float((plain.double() - want).abs().max()))


def rmi_within(got, want, mag, ridx):
    """rmi_apply_read vs its plain version in float64: agg' within KA_TOL
    x (1 + sum of |records| + |agg|), counts and dirty flags equal, the
    reads within that bound / max(cnt, 1) plus KB_TOL x (1 + |read|)."""
    n = want[1][ridx].clamp(min=1)[:, None]
    return (bool(((got[0].double() - want[0]).abs()
                  <= KA_TOL * (1 + mag)).all())
            and torch_equal(got[1].double(), want[1])
            and torch_equal(got[2], want[2])
            and bool(((got[3].double() - want[3]).abs()
                      <= KA_TOL * (1 + mag[ridx]) / n
                      + KB_TOL * (1 + want[3].abs())).all()))


def rmi_wide(args):
    """rmi_apply_read's inputs with the floats in float64."""
    return tuple(t.double() if t.is_floating_point() else t for t in args)


def rmi_case(ops, ref, args, what):
    """Kernels A and B through rmi_apply_read vs the plain version in
    float64; one launch each. Returns (max abs err over agg' and the
    reads, the f32 plain version's)."""
    agg, cnt, idx, vec, dcnt, ridx = args
    ops.reset_launches()
    got = ops.rmi_apply_read(*args)
    sync(got[0])
    check(not agg.is_cuda or ops.LAUNCHES == {"segment_sum_rows": 1,
                                              "mean_rows_gather": 1},
          f"[gnn-kernel] {what}: {ops.LAUNCHES}")
    want = ref.rmi_apply_read_ref(*rmi_wide(args))
    mag = ref.rmi_apply_read_ref(agg.abs(), cnt, idx, vec.abs(), dcnt,
                                 ridx)[0]
    check(rmi_within(got, want, mag, ridx), f"[gnn-kernel] {what}: "
                                            "rmi_apply_read vs plain")
    plain = ref.rmi_apply_read_ref(*args)

    def err(a):
        e = float((a[0].double() - want[0]).abs().max())
        return max(e, float((a[3].double() - want[3]).abs().max())
                   if ridx.numel() else 0.0)

    return err(got), err(plain)


def rmi_lane(gen, device, R, C, live, K, d):
    """A layer-0 RMI lane of the d3gnn pipeline's shape: R synopsis rows,
    C records of which `live` address power-law rows (the rest the drop
    sentinel R), K read rows; agg, vec normal, counts small integers."""
    import torch
    idx = torch.full((C,), R, dtype=torch.int64, device=device)
    pos = torch.randperm(C, generator=gen, device=device)[:live]
    idx[pos] = powerlaw_rows(gen, R, live)
    agg = torch.randn(R, d, generator=gen, device=device)
    cnt = torch.randint(0, 6, (R,), generator=gen, device=device).float()
    vec = torch.randn(C, d, generator=gen, device=device)
    dcnt = torch.randint(-1, 2, (C,), generator=gen, device=device).float()
    ridx = torch.randint(0, R, (K,), generator=gen, device=device)
    return agg, cnt, idx, vec, dcnt, ridx


def phase_gnn_kernel(device, batch, g=GNN):
    """Kernel 1 through gather_segment_sum and kernels 1 + 2 through
    rmi_apply_read against their plain versions on the card: no edges,
    every edge masked, one hub receiving every edge, receivers out of
    order, and rows 1e and 2e's shapes (the sampler's minibatch_lg batch
    at d 602 and PNA's 75; the d3gnn layer-0 lane with 8,192 reads); a
    planted fault each comparison must catch; then rows 1e and 2e timed
    beside their bounds, plain versions and (1e) zeros + index_add_ of
    pre-gathered rows. Returns their `kernels` entries, "launches" left
    for [gnn-train]'s counts."""
    import torch
    from repro_torch.kernels.segment_reduce import ops, ref
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    errs = {"gss": 0.0, "rmi": 0.0}

    def idx(n, hi):
        return torch.randint(0, hi, (n,), generator=gen, device=device)

    N, d = 500, 75
    x = torch.randn(N, d, generator=gen, device=device)
    E = 4000
    s, r = idx(E, N), idx(E, N)
    live = torch.rand(E, generator=gen, device=device) > 0.3
    cases = {
        "no edges": (s[:0], r[:0], live[:0]),
        "all edges masked": (s, r, torch.zeros_like(live)),
        "one hub receives every edge": (s, torch.full_like(r, 11), live),
        "receivers out of order": (s, r.sort().values[torch.randperm(
            E, generator=gen, device=device)], live),
        "receivers sorted, no mask": (s, r.sort().values, None)}
    for what, (ss, rr, mm) in cases.items():
        errs["gss"] = max(errs["gss"], gss_case(ops, ref, x, ss, rr, N, mm,
                                                what)[0])
    R, C, K = 300, 6000, 200
    small = rmi_lane(gen, device, R, C, 2000, K, 64)
    cases = {"records onto a base": small,
             "no records": tuple(t[:0] if i in (2, 3, 4) else t
                                 for i, t in enumerate(small)),
             "every record on one row": small[:2] + (torch.where(
                 small[2] < R, 5, R),) + small[3:]}
    for what, args in cases.items():
        errs["rmi"] = max(errs["rmi"], rmi_case(ops, ref, args, what)[0])
    # planted faults: one element moved past the bound must fail
    with torch.no_grad():
        got = ops.gather_segment_sum(x, s, r, N, live)
        want = ref.gather_segment_sum_ref(x.double(), s, r, N, live)
        mag = ref.gather_segment_sum_ref(x.abs(), s, r, N, live)
        bad = got.clone()
        bad[int(r[0])] += 1e-3 * (1 + mag[int(r[0])])
        check(gss_within(got, want, mag) and not gss_within(bad, want, mag),
              "[gnn-kernel] the gather_segment_sum comparison missed a "
              "planted fault")
        got = ops.rmi_apply_read(*small)
        want = ref.rmi_apply_read_ref(*rmi_wide(small))
        mag = ref.rmi_apply_read_ref(small[0].abs(), small[1], small[2],
                                     small[3].abs(), small[4], small[5])[0]
        bad = (got[0], got[1] + (torch.arange(R, device=device) == 3),
               got[2], got[3])
        check(rmi_within(got, want, mag, small[5])
              and not rmi_within(bad, want, mag, small[5]),
              "[gnn-kernel] the rmi_apply_read comparison missed a planted "
              "fault")
    print("[gnn-kernel] gather_segment_sum (kernel 1, gather form) vs "
          "plain: no edges, every edge masked, a hub receiving every edge, "
          "receivers out of order and sorted; rmi_apply_read (kernels 1 + "
          "2) vs plain: records onto a base, none, all on one row; "
          "planted faults caught")

    entries = []
    xb, sb, rb, mb = (batch[k] for k in ("x", "senders", "receivers",
                                         "edge_mask"))
    keep = torch.nonzero(mb).squeeze(1)
    n_src = int(torch.unique(sb[keep]).numel())
    n_nodes, n_edges = xb.shape[0], int(keep.numel())
    for width in (xb.shape[1], g["pna_d"]):
        xw = xb[:, :width].contiguous()
        what = f"the minibatch_lg batch at d {width}"
        err, plain_err = gss_case(ops, ref, xw, sb, rb, n_nodes, mb, what)
        rows = xw[sb[keep]]
        ms = time_ms(lambda: ops.gather_segment_sum(xw, sb, rb, n_nodes, mb))
        plain = time_ms(lambda: ref.gather_segment_sum_ref(xw, sb, rb,
                                                           n_nodes, mb))
        lib = time_ms(lambda: torch.zeros(n_nodes, width,
                                          device=device).index_add_(
            0, rb[keep], rows))
        # x's gathered rows read once, the edge arrays and mask read, the
        # output written; an add per live edge's element
        n_bytes = (n_src * width * 4 + sb.numel() * 8 * 2 + mb.numel()
                   + n_nodes * width * 4)
        n_ops = n_edges * width
        bound = bound_ms(n_bytes, n_ops)
        by = "bytes" if n_bytes / PEAK_BYTES_PER_S > \
            n_ops / PEAK_F32_OPS_PER_S else "operations"
        print(f"[gnn-kernel] row 1e, gather_segment_sum at {what} "
              f"({n_edges} live of {sb.numel()} edges, {n_src} distinct "
              f"sources, x [{n_nodes}, {width}]): max abs err vs the plain "
              f"version in float64 {err:.4g} (the f32 plain version's "
              f"{plain_err:.4g}); {ms:.4f} ms; bound "
              f"{bound:.4f} ms by {by} ({n_bytes} bytes); plain "
              f"{plain:.4f} ms; zeros + index_add_ of pre-gathered rows "
              f"{lib:.4f} ms")
        entries.append({
            "name": f"segment_sum_rows (gather_segment_sum, minibatch_lg, "
                    f"d {width})",
            "route": "cuda", "source": "src/repro_torch/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce/kernel.py:59",
            "launches": None, "max_abs_err": max(errs["gss"], err),
            "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib})
        del xw, rows
    free_cuda()
    args = rmi_lane(gen, device, g["rmi_rows"], g["rmi_records"],
                    g["rmi_live"], g["rmi_reads"], g["rmi_d"])
    err, plain_err = rmi_case(ops, ref, args, "the d3gnn layer-0 lane")
    agg, cnt, ridx_ = args[0], args[1], args[5]
    R, d, C, K = agg.shape[0], agg.shape[1], args[2].numel(), ridx_.numel()
    L = g["rmi_live"]
    ms = time_ms(lambda: ops.rmi_apply_read(*args))
    plain = time_ms(lambda: ref.rmi_apply_read_ref(*args))
    # agg and cnt read and written (agg', cnt' are new), the records'
    # indices read, the live records' rows and counts read, dirty and the
    # reads written; an add per live element, a division per read element
    n_bytes = (2 * R * d * 4 + 2 * R * 4 + C * 8 + L * (d + 1) * 4 + R
               + K * 8 + K * d * 4)
    n_ops = L * (d + 1) + K * d
    bound = bound_ms(n_bytes, n_ops)
    by = "bytes" if n_bytes / PEAK_BYTES_PER_S > \
        n_ops / PEAK_F32_OPS_PER_S else "operations"
    print(f"[gnn-kernel] row 2e, rmi_apply_read at the d3gnn layer-0 lane "
          f"({R} rows, d {d}, {C} records of which {L} live, {K} reads): "
          f"max abs err vs the plain version in float64 {err:.4g} (the f32 "
          f"plain version's {plain_err:.4g}); {ms:.4f} ms; bound {bound:.4f} ms by {by} ({n_bytes} bytes); "
          f"plain {plain:.4f} ms; no single PyTorch call does it")
    entries.append({
        "name": "segment_sum_rows + mean_rows_gather (rmi_apply_read, d3gnn "
                "layer-0 lane)",
        "route": "cuda", "source": "src/repro_torch/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce/kernel.py:59, :95",
        "launches": None, "max_abs_err": max(errs["rmi"], err), "ms": ms,
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None})
    del args
    free_cuda()
    return entries


def gnn_parity_graph(arch, shape_name, seed=SEED + 23, n=48, e=160):
    """A numpy-drawn graph for the reduced models (erdos_graph with
    positions, then a ring edge into every node), its labels on the seeds'
    share, or at an energy shape 4 graphs of 12 nodes and targets for the
    shape's graphs. CPU tensors."""
    import torch
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.graph.graphs import erdos_graph
    dims = GNN_SHAPES[shape_name].dims
    rng = np.random.default_rng(seed)
    gr = erdos_graph(rng, n, e, 16, with_pos=True)
    ring = torch.arange(n)
    b = {"senders": torch.cat([gr.senders, ring]),
         "receivers": torch.cat([gr.receivers, (ring + 1) % n]),
         "x": gr.x, "pos": gr.pos, "node_mask": torch.ones(n, dtype=bool)}
    b["edge_mask"] = torch.as_tensor(np.concatenate(
        [rng.random(e) >= 0.2, np.ones(n, bool)]))
    if dims["n_classes"]:
        b["labels"] = torch.as_tensor(rng.integers(0, dims["n_classes"], n))
        b["label_mask"] = torch.as_tensor(rng.random(n) < 0.8)
    else:
        b["graph_ids"] = torch.arange(n) // (n // 4)
        b["targets"] = torch.as_tensor(rng.normal(size=dims["n_graphs"]),
                                       dtype=torch.float32)
    if arch == "dimenet":
        from repro_torch.graph.triplets import build_triplets
        E = b["senders"].numel()
        kj, ji, tm = build_triplets(b["senders"].numpy(),
                                    b["receivers"].numpy(), n, 4 * E)
        b.update(t_kj=torch.as_tensor(kj, dtype=torch.int64),
                 t_ji=torch.as_tensor(ji, dtype=torch.int64),
                 t_mask=torch.as_tensor(tm))
    return b


def gnn_parity_model(arch, device):
    """(model, shape name, train step) of a reduced zoo model."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import GNN_SHAPES, make_gnn_train_step
    from repro_torch.graph.gat import GAT
    from repro_torch.graph.sage import GCN
    if arch in ("gat", "gcn"):
        model = (GAT((16, 16, 16), n_heads=4, n_classes=7, device=device)
                 if arch == "gat" else GCN((16, 16, 16), 7, device=device))
        return model, "full_graph_sm", make_gnn_train_step(
            model, GNN_SHAPES["full_graph_sm"], needs_triplets=False)
    spec = get_arch(arch)
    shape = "molecule" if arch in ("dimenet", "nequip") else "full_graph_sm"
    model = spec.build_reduced(shape, device=device)
    return model, shape, spec.step(model, shape)


def gnn_leaves_within(tag, got, want, tol):
    """Per leaf max |got - want| <= tol x max |want|; returns the worst
    ratio err / max |want|."""
    import torch
    worst = 0.0
    for k, w in want.items():
        gk = got[k].detach().double().cpu()
        w = w.detach().double().cpu()
        check(bool(torch.isfinite(gk).all()), f"[gnn-parity] {tag} {k} not "
                                              "finite")
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((gk - w).abs().max()) if w.numel() else 0.0
        check(err <= max(tol * scale, 1e-12), f"[gnn-parity] {tag} {k}: "
                                              f"{err} > {tol} x {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def phase_gnn_parity(device):
    """The six reduced models (pna, gatedgcn, dimenet, nequip, GAT, GCN),
    card vs CPU on the same numpy-drawn graph: the forward, the loss's
    gradients, and two train steps (loss, every parameter and Adam leaf),
    with TF32 off; PNA's gradients and steps in float64 (GNN_PARITY's
    note)."""
    import torch
    from repro_torch.configs.base import value_and_grad
    from repro_torch.configs.gnn_common import GNN_SHAPES, batch_graph
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    for arch in GNN_PARITY:
        cpu_model, shape, _ = gnn_parity_model(arch, "cpu")
        b = gnn_parity_graph(arch, shape)
        n_graphs = GNN_SHAPES[shape].dims["n_graphs"]
        trip = (b["t_kj"], b["t_ji"], b["t_mask"]) if arch == "dimenet" \
            else ()
        runs = {}
        for dev in ("cpu", device):
            model, _, step = gnn_parity_model(arch, dev)
            model.load_state_dict(cpu_model.state_dict())
            bd = {k: v.to(dev) for k, v in b.items()}
            extra = tuple(t.to(dev) for t in trip)
            with torch.no_grad():
                out = model(batch_graph(bd, n_graphs), *extra)
            if arch == "pna":
                model = model.double()
                bd = {k: v.double() if v.is_floating_point() else v
                      for k, v in bd.items()}
            params = param_tree(model)
            loss, grads = value_and_grad(model, step.loss_fn, params, bd)
            state, steps = adam().init(params), []
            for _ in range(2):
                params, state, l2 = step(params, state, bd)
                steps.append((float(l2), params, state))
            runs[str(dev)] = (out, float(loss), grads, steps)
        (o_c, l_c, g_c, s_c), (o_g, l_g, g_g, s_g) = runs["cpu"], \
            runs[str(device)]
        e_fwd = float(((o_g.cpu().double() - o_c.double()).abs()
                       / (1 + o_c.double().abs())).max())
        check(e_fwd <= GNN_FWD_TOL, f"[gnn-parity] {arch} forward {e_fwd}")
        check(abs(l_g - l_c) <= GNN_FWD_TOL * abs(l_c),
              f"[gnn-parity] {arch} loss {l_g} vs {l_c}")
        e_grad = gnn_leaves_within(f"{arch} grads", g_g, g_c, GNN_LEAF_TOL)
        e_state = 0.0
        for i, ((lc, pc, sc), (lg, pg, sg)) in enumerate(zip(s_c, s_g)):
            check(abs(lg - lc) <= GNN_FWD_TOL * abs(lc),
                  f"[gnn-parity] {arch} step {i} loss {lg} vs {lc}")
            check(int(sg["t"]) == int(sc["t"]) == i + 1,
                  f"[gnn-parity] {arch} step {i}: Adam's t")
            for what, got, want in (("params", pg, pc), ("m", sg["m"],
                                                          sc["m"]),
                                    ("v", sg["v"], sc["v"])):
                e_state = max(e_state, gnn_leaves_within(
                    f"{arch} step {i} {what}", got, want, GNN_LEAF_TOL))
        print(f"[gnn-parity] {arch} ({shape}, reduced{', grads and steps '
              'in float64' if arch == 'pna' else ''}): card vs CPU forward "
              f"{e_fwd:.3e} (x (1 + |cpu|)), loss {l_g:.6f} vs {l_c:.6f}, "
              f"grads {e_grad:.3e} and two steps' params / moments "
              f"{e_state:.3e} of their leaf's max (tolerances "
              f"{GNN_FWD_TOL}, {GNN_LEAF_TOL})")


def gnn_descent(tag, model, loss_fn, params, batch, g=GNN):
    """The loss falls along -g: params - t g, t = descent x |loss| /
    ||g||^2, lowers it by at least half of descent x |loss|; every
    gradient finite. Returns (loss, fall, expected)."""
    import math
    import torch
    from repro_torch.configs.base import value_and_grad
    loss0, grads = value_and_grad(model, loss_fn, params, batch)
    loss0 = float(loss0)
    check(math.isfinite(loss0), f"[{tag}] loss {loss0}")
    check(all(bool(torch.isfinite(v).all()) for v in grads.values()),
          f"[{tag}] a gradient is not finite")
    gn2 = float(sum(v.double().square().sum() for v in grads.values()))
    want = g["descent"] * abs(loss0)
    moved = {n: p - (want / gn2) * grads[n] for n, p in params.items()}
    del grads
    loss1 = float(value_and_grad(model, loss_fn, moved, batch)[0])
    fell = loss0 - loss1
    check(fell >= 0.5 * want, f"[{tag}] params - t g lowered the loss by "
                              f"{fell}, expected ~{want}")
    return loss0, fell, want


def gnn_train_run(tag, arch, shape, batch, device, per_step, unit, g=GNN):
    """One arch at one shape at the published widths: build, the descent
    check, `steps` timed steps, one profiled step. Returns a summary."""
    import math
    import statistics
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.nn.module import bind_params, param_count, param_tree
    from repro_torch.optim import adam
    spec = get_arch(arch)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = spec.build(shape, device=device)
    step = spec.step(model, shape)
    params = param_tree(model)
    loss0, fell, want = gnn_descent(tag, model, step.loss_fn, params, batch)
    free_cuda()
    state = adam().init(params)
    losses, secs = [], []
    for _ in range(g["steps"]):
        sync(batch["x"])
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
        bind_params(model, params)
    check(all(math.isfinite(x) for x in losses), f"[{tag}] losses {losses}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    med = statistics.median(secs[1:]) if len(secs) > 1 else secs[0]
    print(f"[{tag}] {arch} at {shape} ({param_count(model)} params): "
          f"descent: loss {loss0:.6f}, fell {fell:.6f} along -g (first "
          f"order {want:.6f}); {g['steps']} steps: "
          + ", ".join(f"{s:.4f} s" for s in secs)
          + f"; median of steps 1-{g['steps'] - 1} {med:.4f} s, "
          f"{per_step / med:.1f} {unit}/s; loss "
          + " -> ".join(f"{x:.6f}" for x in losses)
          + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if cuda:
        profile_call(tag, f"{arch} at {shape}, one train step",
                     lambda: step(params, state, batch),
                     top=g["profile_top"])
    del model, params, state, step
    free_cuda()
    return {"secs": secs, "median_s": med, "peak": peak, "losses": losses}


def phase_gnn_train(device, batch, g=GNN):
    """pna, gatedgcn, dimenet and nequip at minibatch_lg's published
    widths on the sampler's batch (seeds/s), then dimenet and nequip at
    molecule (graphs/s): finite losses and gradients, the descent check,
    seconds a step, peak memory, one step's top device ops. Kernels 1 and
    2's counts are set to 0 before the runs and read after them: no zoo
    model calls gather_segment_sum or rmi_apply_read (the reference's
    models call jax.ops.segment_* alike), so both must read 0. Returns
    (the runs' summaries, the counts)."""
    from repro_torch.kernels.segment_reduce import ops
    ops.reset_launches()
    out = {}
    for arch in ("pna", "gatedgcn", "dimenet", "nequip"):
        out[arch, "minibatch_lg"] = gnn_train_run(
            "gnn-train", arch, "minibatch_lg", batch, device, g["seeds"],
            "seeds")
    mol = gnn_molecule_batch(device, SEED + 24)
    for arch in ("dimenet", "nequip"):
        out[arch, "molecule"] = gnn_train_run(
            "gnn-train", arch, "molecule", mol, device, g["molecule"][0],
            "graphs")
    launches = {k: ops.LAUNCHES[k] for k in ("segment_sum_rows",
                                             "mean_rows_gather")}
    check(launches == {"segment_sum_rows": 0, "mean_rows_gather": 0},
          f"[gnn-train] the zoo's runs launched {launches}")
    print(f"[gnn-train] kernel launches over the six runs: {launches}")
    return out, launches


def phase_gnn_cli(device):
    """`python -m repro_torch.launch.train --arch gatedgcn --shape
    full_graph_sm --steps 2` as a subprocess on the device (the published
    config; CUDA: no --device flag)."""
    import math
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "gatedgcn", "--shape", "full_graph_sm", "--steps", "2"]
    if device.type != "cuda":
        cmd += ["--device", str(device)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True,
                          text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0, f"[gnn-cli] exited {proc.returncode}:\n"
                                f"{proc.stdout}\n{proc.stderr[-4000:]}")
    losses = [float(line.split("loss=")[1].split()[0]) for line in lines[:2]
              if line.startswith("step ")]
    check(len(lines) == 3 and lines[-1] == "train driver done"
          and len(losses) == 2 and all(math.isfinite(x) for x in losses),
          f"[gnn-cli] printed {lines}")
    print(f"[gnn-cli] gatedgcn --shape full_graph_sm --steps 2 ({secs:.1f} "
          f"s with the interpreter's start): " + "; ".join(lines))



# ------------------------------------------------------------ MoE phases
# moonshot-v1-16b-a3b (src/repro/configs/moonshot_v1_16b_a3b.py:15-21) at
# its published widths and all 48 layers, bf16, random weights drawn on
# the card (~28.89 B parameters, 57.8 GB); prefill_32k's batch cut from 32
# to 1, as [lm-full]'s. [moe-parity] runs the four configs of the slice at
# their REDUCED sizes (f32), card vs CPU. [moe-ep]: one layer at
# moonshot's widths on `ep_ranks` gloo ranks sharing the card (64 / 4 = 16
# experts each), `ep_tokens` tokens a rank, f32, at each capacity factor
# of `ep_cfs` (8: nothing drops, T K <= C S; 1.25: the config's).
MOE = dict(arch="moonshot-v1-16b-a3b", shape="prefill_32k", check_s=2048,
           layer_t=256, decode_tokens=32,
           prefill_qkv=(1, 32768, 16, 16, 128),   # B, S, H, Kh, D: a layer
           parity_archs=("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
                         "internlm2-20b", "mistral-large-123b"),
           parity_seq=64, parity_step=(256, 16, 8),
           ep_ranks=4, ep_tokens=2048, ep_cfs=(8.0, 1.25), timeout=900)
# [moe-parity], card vs CPU (TF32 off): logits and decode logits within
# LM_PARITY_TOL x (1 + |cpu|) and equal greedy tokens; the loss within
# ZOO_LOSS_TOL x |cpu|; gradients per leaf within MOE_GRAD_TOL x max |cpu|
# (tests/test_torch_moe.py's bounds against JAX); after one Adam step the
# parameters within ZOO_STATE_TOL, except where the gradient lies within
# MOE_GRAD_TOL of the leaf's max of 0, where Adam's first step lr g /
# (|g| + eps) may take either sign on the two devices (2 lr + ZOO_STATE_TOL
# there: tests/test_torch_moe.py's assert_first_adam_step_close), and the
# moments as [train-zoo-parity] holds them; the dispatch equal to
# dense_oracle within MOE_EP_TOL x (1 + |oracle|) where nothing drops.
MOE_GRAD_TOL = 1e-4
# [moe-full] at check_s: the kernel path no farther from a path whose
# attention runs in f32 than LM_PATH_RATIO x the plain path, as [lm-full];
# but the kernel path within MOE_PATH_RATIO x the plain path's distance
# from f32 of the plain path, not within [lm-full]'s LM_PATH_TOL: the
# router's logits are bf16 (as JAX computes them), so bf16 rounding
# anywhere flips near-tied top-6 choices, and a flipped pair changes its
# token's FFN output whole. On an H100 at S = 2048 over 48 layers the
# plain path lay 1.488e-01 from f32 attention and the kernel path
# 1.520e-01, and the two 1.481e-01 apart (two bf16 paths, each a
# perturbation of that size). One layer at layer_t tokens (dropless: T <= 4 E): the bf16 dispatch and the
# bf16 dense oracle, each ||. - f32|| / ||f32|| <= MOE_BF16_TOL against
# the layer's experts run in f32 on the same routing (x and the weights
# as stored, the f32 router weights of the same top-k)
MOE_BF16_TOL = 2.0 ** -6
MOE_PATH_RATIO = 1.5
# [moe-ep] f32, TF32 off: per element |diff| <= MOE_EP_TOL x (1 + |ref|)
# against dense_oracle (cf 8) and against the same ranks' CPU run (cf
# 1.25): f32 sums in another order over d = 2,048 then d_ff = 1,408
# terms. MESH_TOL's 1e-5 holds sums over 64-602 terms; rounding grows as
# the root of the terms summed, so sqrt(2048 / 602) = 1.84 of it, 2e-5
# (an H100 run read 7.547e-06 and 6.735e-06). Tokens and router
# lie on a grid (x in k / 8, -16 <= k <= 24; router in j / 512, -3 <= j
# <= 4) so every router logit is exact in f32 whatever the summation order,
# and the card, the CPU and the oracle route each token alike.
MOE_EP_TOL = 2e-5


def moe_leaves_within(tag, what, got, want, tol):
    """Per leaf max |got - want| <= tol x max |want| (1e-12 for a zero
    leaf). Returns the worst ratio err / max |want|."""
    worst = 0.0
    for name, w in want.items():
        w = w.detach().cpu().double()
        scale = float(w.abs().max()) if w.numel() else 0.0
        e = float((got[name].detach().cpu().double() - w).abs().max()) \
            if w.numel() else 0.0
        check(e <= max(tol * scale, 1e-12),
              f"[{tag}] {what} {name}: {e} > {tol} x {scale}")
        worst = max(worst, e / scale if scale else 0.0)
    return worst


def moe_first_step_within(tag, got, want, grads, lr=3e-4):
    """Parameters after the first Adam step, card vs CPU (MOE_GRAD_TOL's
    exemption, above). Returns the max error outside the exempt
    elements and their count."""
    import torch
    worst, exempt = 0.0, 0
    for name, w in want.items():
        g = grads[name].cpu()
        noise = g.abs() <= MOE_GRAD_TOL * float(g.abs().max())
        err = (got[name].cpu() - w).abs()
        bound = torch.where(noise, 2 * lr + ZOO_STATE_TOL, ZOO_STATE_TOL)
        check(bool((err <= bound).all()), f"[{tag}] param {name} after "
              f"one Adam step: max err {float(err.max())}")
        worst = max(worst, float(torch.where(noise, 0.0, err).max()))
        exempt += int((noise & (err > ZOO_STATE_TOL)).sum())
    return worst, exempt


def moe_logits_err(got, want):
    """max |got - want| / (1 + |want|) (LM_PARITY_TOL's measure)."""
    return float(((got.cpu() - want).abs() / (1 + want.abs())).max())


def phase_moe_parity(device, moe=MOE):
    """The four configs of the slice at their REDUCED sizes, built on the
    CPU from a seed and copied to the card (f32, TF32 off): logits; 8
    greedy decode steps from an empty cache; the loss with its aux and its
    gradients; one lm_step("train_4k") Adam step. On the MoE configs the
    dispatch against dense_oracle where nothing drops, and a planted fault
    (two experts' wd swapped on the card) the logits comparison must
    catch."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import lm_step, value_and_grad
    from repro_torch.data.streams import token_batches
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    cuda = device.type == "cuda"
    rng = np.random.default_rng(SEED + 24)
    B_step, S_step, accum = moe["parity_step"]
    for arch in moe["parity_archs"]:
        spec = get_arch(arch)
        cpu = spec.build_reduced(device="cpu", seed=SEED, train=True)
        card = spec.build_reduced(device=device, seed=SEED + 1, train=True)
        card.load_state_dict(cpu.state_dict())
        c = cpu.cfg
        toks = torch.as_tensor(rng.integers(0, c.vocab,
                                            (2, moe["parity_seq"])))
        fa.reset_launches()
        want = cpu.logits(toks)
        e_logits = moe_logits_err(card.logits(toks.to(device)), want)
        check(e_logits <= LM_PARITY_TOL, f"[moe-parity] {arch} logits card "
                                         f"vs CPU {e_logits:.3e}")
        if cuda:
            check(fa.LAUNCHES["flash_attention"] == c.n_layers,
                  f"[moe-parity] {arch} logits launched {fa.LAUNCHES}")
        planted = None
        moe_blocks = [b for b in card.blocks if b.kind == "moe"]
        if moe_blocks:
            with torch.no_grad():
                for b in moe_blocks:
                    b.ffn.wd[[0, 1]] = b.ffn.wd[[1, 0]].clone()
                planted = moe_logits_err(card.logits(toks.to(device)), want)
                for b in moe_blocks:
                    b.ffn.wd[[0, 1]] = b.ffn.wd[[1, 0]].clone()
            check(planted > LM_PARITY_TOL, f"[moe-parity] {arch}: two "
                  f"experts' wd swapped reads {planted:.3e}, within the "
                  f"bound")
            # the dispatch is the oracle where nothing drops (T <= 4 E)
            lay = moe_blocks[0].ffn
            x = torch.randn(4 * lay.cfg.num_experts, c.d_model,
                            generator=torch.Generator(device).manual_seed(
                                SEED), device=device)
            with torch.no_grad():
                got, oracle = lay(x)[0], lay.dense_oracle(x)[0]
            e_oracle = float(((got - oracle).abs()
                              / (1 + oracle.abs())).max())
            check(e_oracle <= MOE_EP_TOL, f"[moe-parity] {arch} dispatch "
                                          f"vs dense_oracle {e_oracle:.3e}")
        B, n = 4, 8
        tok = torch.as_tensor(rng.integers(0, c.vocab, (B, 1)))
        c_cpu, c_card = cpu.init_cache(B, n + 8), card.init_cache(B, n + 8)
        t_cpu, t_card, e_dec = tok, tok.to(device), 0.0
        for _ in range(n):
            l_cpu, c_cpu = cpu.decode_step(c_cpu, t_cpu)
            l_card, c_card = card.decode_step(c_card, t_card)
            e_dec = max(e_dec, moe_logits_err(l_card, l_cpu))
            t_cpu = torch.argmax(l_cpu[:, -1:], dim=-1)
            t_card = torch.argmax(l_card[:, -1:], dim=-1)
            check(torch.equal(t_card.cpu(), t_cpu),
                  f"[moe-parity] {arch}: greedy tokens differ")
        check(e_dec <= LM_PARITY_TOL, f"[moe-parity] {arch} decode logits "
                                      f"card vs CPU {e_dec:.3e}")
        labels = torch.roll(toks, -1, 1)
        labels[0, -5:] = -100
        lc, gc = value_and_grad(cpu, cpu.loss, param_tree(cpu), toks, labels)
        lg, gg = value_and_grad(card, card.loss, param_tree(card),
                                toks.to(device), labels.to(device))
        e_loss = abs(float(lg) - float(lc)) / abs(float(lc))
        check(e_loss <= ZOO_LOSS_TOL, f"[moe-parity] {arch} loss card "
                                      f"{float(lg)} vs CPU {float(lc)}")
        e_grad = moe_leaves_within("moe-parity", f"{arch} grad", gg, gc,
                                   MOE_GRAD_TOL)
        data = next(iter(token_batches(SEED, c.vocab, B_step, S_step, 1)))
        runs = {}
        for name, m in (("cpu", cpu), ("card", card)):
            p = param_tree(m)
            runs[name] = lm_step(m, "train_4k", grad_accum=accum)(
                p, adam().init(p), *(torch.as_tensor(a, device=m.device)
                                     for a in data))
        (pc, sc, lc1), (pg, sg, lg1) = runs["cpu"], runs["card"]
        e_step = abs(float(lg1) - float(lc1)) / abs(float(lc1))
        check(e_step <= ZOO_LOSS_TOL, f"[moe-parity] {arch} step loss")
        g_step = {k: v / 0.1 for k, v in sc["m"].items()}   # m = (1 - b1) g
        e_param, exempt = moe_first_step_within("moe-parity", pg, pc,
                                                g_step)
        e_mom = max(moe_leaves_within("moe-parity", f"{arch} {mv}", sg[mv],
                                      sc[mv], ZOO_MOMENT_RTOL)
                    for mv in ("m", "v"))
        for mv in ("m", "v"):
            for k in sc[mv]:
                e = float((sg[mv][k].cpu() - sc[mv][k]).abs().max())
                check(e <= ZOO_STATE_TOL, f"[moe-parity] {arch} {mv} {k}")
        print(f"[moe-parity] {arch} ({c.n_layers} layers, pattern "
              f"{c.pattern}, d {c.d_model}, head dim {c.head_dim}"
              + (f", {c.moe.num_experts} experts top-{c.moe.top_k}, "
                 f"{c.moe.n_shared} shared" if c.moe else "")
              + f"), card vs CPU: logits {e_logits:.3e}, {n} greedy decode "
              f"steps x {B} equal tokens, logits {e_dec:.3e} (tolerance "
              f"{LM_PARITY_TOL} x (1 + |cpu|)); loss {float(lc):.6f} rel "
              f"{e_loss:.3e}; grads {e_grad:.3e} of a leaf's max (tolerance "
              f"{MOE_GRAD_TOL}); one train_4k Adam step ({B_step} x "
              f"{S_step}, grad_accum {accum}): loss rel {e_step:.3e}, "
              f"params {e_param:.3e} ({exempt} elements past "
              f"{ZOO_STATE_TOL} where |g| is within the gradient bound of "
              f"0), moments {e_mom:.3e} of a leaf's max"
              + (f"; dispatch vs dense_oracle {e_oracle:.3e}; planted fault "
                 f"(experts 0, 1 wd swapped) reads {planted:.3e} "
                 f"(must be > {LM_PARITY_TOL})" if moe_blocks else ""))
        del cpu, card, runs
        free_cuda()


def moe_f32_reference(layer, x, ids):
    """The layer's output in f32 on the given routing: x and the stored
    weights cast to f32, each token's top-k experts weighted by the f32
    router probabilities at `ids` renormalised, plus the shared experts."""
    import torch
    import torch.nn.functional as F
    xf = x.float()
    probs = torch.softmax((x @ layer.router.to(x.dtype)).float(), dim=-1)
    w = probs.gather(1, ids)
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in torch.unique(ids).tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        xe = xf[tok]
        y = (F.silu(xe @ layer.wg[e].float()) * (xe @ layer.wu[e].float())) \
            @ layer.wd[e].float()
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    if layer.shared is not None:
        s = layer.shared
        out += (F.silu(xf @ s.wg.float()) * (xf @ s.wu.float())) \
            @ s.wd.float()
    return out


def moe_drop_hooks(model):
    """Forward hooks on every MoE layer that add up, on the device, the
    (token, expert) pairs routed and the pairs past the capacity (the
    sorted dispatch's drops: per expert, max(0, pairs - C)). Returns
    (hooks, counts [routed, dropped])."""
    import torch
    from repro_torch.nn.moe import capacity
    counts = torch.zeros(2, dtype=torch.int64, device=model.device)

    def hook(mod, args, out):
        x = args[0]
        ids = mod.route(x)[0]
        E, K = mod.cfg.num_experts, mod.cfg.top_k
        C = capacity(x.shape[0], K, mod.cfg.capacity_factor, E, E)
        per = torch.bincount(ids.reshape(-1), minlength=E)
        counts[0] += ids.numel()
        counts[1] += torch.clamp(per - C, min=0).sum()

    hooks = [b.ffn.register_forward_hook(hook) for b in model.blocks
             if b.kind == "moe"]
    return hooks, counts


def phase_moe_full(device, moe=MOE):
    """moonshot-v1-16b-a3b at its published widths and depth: the kernel
    path against the plain-attention path at check_s; one layer's dispatch
    and dense oracle at layer_t tokens against f32; one prefill_32k
    prefill (batch 1) with its flash launches and the dispatch's dropped
    share; the serve CLI (batch 4) and a warm decode; tokens/s, peak
    memory, and a profile of one prefill and one decode step. Returns the
    flash launches counted over one prefill."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa, ref
    from repro_torch.launch import serve
    from repro_torch.nn import attention
    from repro_torch.nn.module import param_bytes, param_count
    cuda = device.type == "cuda"
    spec = get_arch(moe["arch"])
    S = spec.shapes[moe["shape"]].dims["seq"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = spec.build(device=device, seed=SEED)
    sync(model.lm_head)
    cfg = model.cfg
    m = cfg.moe
    print(f"[moe-full] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads of "
          f"{cfg.head_dim}, {m.num_experts} experts top-{m.top_k} of d_ff "
          f"{m.d_ff} + {m.n_shared} shared, capacity factor "
          f"{m.capacity_factor}, vocab {cfg.vocab}; {param_count(model)} "
          f"params, {param_bytes(model)} bytes ({cfg.dtype}), drawn on the "
          f"device in {time.perf_counter() - t0:.2f}s")
    gen = torch.Generator(device=device).manual_seed(SEED)

    # the kernel path against the plain-attention path, and both against
    # attention in f32 (as [lm-full])
    toks = torch.randint(0, cfg.vocab, (1, moe["check_s"]), generator=gen,
                         device=device)
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
    print(f"[moe-full] S={moe['check_s']}: kernel path vs plain-attention "
          f"path: final hidden states ||diff||/||plain|| {path_err:.3e} "
          f"(at most {MOE_PATH_RATIO}x the plain path's distance from f32 "
          f"attention); vs f32 attention: kernel {from_f32[0]:.3e}, plain "
          f"{from_f32[1]:.3e} (kernel at most {LM_PATH_RATIO}x plain)")
    check(path_err <= MOE_PATH_RATIO * from_f32[1],
          f"[moe-full] kernel path vs plain path: {path_err:.3e}, the plain "
          f"path {from_f32[1]:.3e} from f32 attention")
    check(from_f32[0] <= LM_PATH_RATIO * from_f32[1],
          f"[moe-full] kernel path {from_f32[0]:.3e} from f32 attention, "
          f"plain path {from_f32[1]:.3e}")
    del h_kernel, h_plain, h_f32

    # one layer's dispatch and oracle, dropless, against f32
    check(moe["layer_t"] <= 4 * m.num_experts,
          f"[moe-full] layer_t {moe['layer_t']} > 4 E: capacity applies")
    lay = model.blocks[0].ffn
    x = torch.randn(moe["layer_t"], cfg.d_model, generator=gen,
                    device=device).to(lay.router.dtype)
    with torch.no_grad():
        got, _ = lay(x)
        oracle, _ = lay.dense_oracle(x)
        want = moe_f32_reference(lay, x, lay.route(x)[0])
    e_call, e_oracle = rel(got, want), rel(oracle, want)
    print(f"[moe-full] layer 0 at T={moe['layer_t']} (dropless: T <= 4 E) "
          f"in {cfg.dtype}: dispatch {e_call:.3e}, dense_oracle "
          f"{e_oracle:.3e} from the f32 experts on the same routing "
          f"(||.-f32||/||f32||, tolerance {MOE_BF16_TOL}); dispatch vs "
          f"oracle {rel(got, oracle):.3e}")
    check(max(e_call, e_oracle) <= MOE_BF16_TOL,
          f"[moe-full] layer 0: dispatch {e_call:.3e}, oracle "
          f"{e_oracle:.3e} from f32")
    del x, got, oracle, want

    # one prefill of the assigned shape at batch 1: the launches and the
    # dropped share (hooked), then a timed one and a profiled one
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=device)
    prefill = spec.step(model, moe["shape"])
    hooks, counts = moe_drop_hooks(model)
    fa.reset_launches()
    logits = prefill(toks)
    sync(logits)
    launches = dict(fa.LAUNCHES)
    for h in hooks:
        h.remove()
    routed, dropped = (int(v) for v in counts.tolist())
    check(logits.shape == (1, cfg.vocab) and bool(logits.isfinite().all()),
          "[moe-full] prefill logits misshapen or not finite")
    if cuda:
        check(launches["flash_attention"] == cfg.n_layers
              and launches["flash_attention_wgmma"] == cfg.n_layers,
              f"[moe-full] the prefill launched the flash kernels "
              f"{launches} times, expected {cfg.n_layers}, all wgmma")
    sync(toks)
    t0 = time.perf_counter()
    logits = prefill(toks)
    sync(logits)
    secs = time.perf_counter() - t0
    print(f"[moe-full] prefill S={S} batch 1: {secs:.3f}s = "
          f"{S / secs:.1f} tokens/s (second call); launches {launches}; "
          f"logits finite; dispatch dropped {dropped} of {routed} (token, "
          f"expert) pairs ({dropped / routed:.4f}) at capacity factor "
          f"{m.capacity_factor}")
    if cuda:
        profile_call("moe-profile", f"one prefill S={S}",
                     lambda: prefill(toks), top=10)
    del model, prefill, logits, toks
    free_cuda()

    # the serve CLI: batch 4, greedy, from an empty cache
    n = moe["decode_tokens"]
    model, generated, secs = serve.main(
        ["--arch", moe["arch"], "--tokens", str(n), "--device", str(device)])
    check(generated.shape == (4, n) and int(generated.min()) >= 0
          and int(generated.max()) < cfg.vocab,
          "[moe-full] served tokens out of range")
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
        profile_call("moe-profile", "one warm decode step, batch 4",
                     lambda: model.decode_step(cache, tok), top=10)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"[moe-full] serve: {4 * n / secs:.1f} tokens/s over its {n} "
          f"steps (first step included); warm decode batch 4: "
          f"{4 * n / warm:.1f} tokens/s, {warm / n * 1e3:.2f} ms a step "
          f"(the weights' {param_bytes(model)} bytes over "
          f"{PEAK_BYTES_PER_S / 1e12} TB/s: "
          f"{param_bytes(model) / PEAK_BYTES_PER_S * 1e3:.2f} ms); peak "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if cuda:
        check(peak < 76 * 2**30, f"[moe-full] peak {peak / 2**30:.2f} GiB")
    del model, cache
    free_cuda()
    return launches


def phase_moe_time(device, launches, max_err, moe=MOE):
    """Row 5m: the kernel at moonshot's prefill layer (q, k, v [1, S, 16,
    128] bf16, causal: MHA, G = 1) beside its bound, its plain version and
    scaled_dot_product_attention (timed only, as a yardstick), in turns;
    the kernel held to its plain version per block against float64 there
    first (fa_check)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as fa, ref
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    q, k, v = make_qkv(gen, torch.bfloat16, *moe["prefill_qkv"])
    err, excess, _ = fa_check(fa, ref, q, k, v, True)
    free_cuda()
    B, S, H, D = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    runs = {"wgmma": [], "sdpa": []}
    for name in ("wgmma", "sdpa", "sdpa", "wgmma"):
        fn = {"wgmma": lambda: fa.flash_attention(q, k, v, causal=True),
              "sdpa": sdpa}[name]
        runs[name].append(time_ms(fn))
    ms, lib_ms = (sum(r) / len(r) for r in runs.values())
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=True))
    flops = 4 * D * H * B * (S * (S + 1) // 2)
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_OPS_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes > t_ops else "operations"
    rate = lambda t: f"{flops / t / 1e9:.1f} TFLOP/s"
    print(f"[moe-time] flash_attention bf16 q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)} causal (moonshot's prefill layer, G = 1): vs "
          f"plain max abs err {err:.3e}, worst block {excess:.3f} (limit "
          f"1); in turns (wgmma, sdpa, sdpa, wgmma): wgmma kernel "
          f"{runs['wgmma']} ms, mean {ms:.3f} ms ({rate(ms)}, "
          f"{bound / ms:.3f} of the bound); scaled_dot_product_attention "
          f"(flash backend) {runs['sdpa']} ms, mean {lib_ms:.3f} ms "
          f"({rate(lib_ms)}); plain {plain_ms:.3f} ms; bound {bound:.3f} ms "
          f"by {by} ({flops} FLOPs, {n_bytes} bytes)")
    return {"name": "flash_attention (moonshot-v1-16b-a3b prefill layer)",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            "launches": launches["flash_attention_wgmma"],
            "max_abs_err": max(max_err, err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def ep_weights(moe_cfg, d, experts, device):
    """Expert e's (wg [d, h], wu [d, h], wd [h, d]), each drawn by
    lecun_normal on `device` from a generator seeded SEED + 1000 + e, so
    any process draws the same expert; stacked over `experts`."""
    import torch
    from repro_torch.nn.initializers import lecun_normal
    out = {"wg": [], "wu": [], "wd": []}
    h = moe_cfg.d_ff
    for e in experts:
        g = torch.Generator(device=device).manual_seed(SEED + 1000 + e)
        out["wg"].append(lecun_normal((d, h), g, device))
        out["wu"].append(lecun_normal((d, h), g, device))
        out["wd"].append(lecun_normal((h, d), g, device))
    return {k: torch.stack(v) for k, v in out.items()}


def ep_inputs(moe_cfg, d, n_tokens, device):
    """(router, shared {wg, wu, wd}, tokens x [n_tokens, d]) on `device`
    from one seed: the router and x on MOE_EP_TOL's grid, the first 64
    features of every token and their router rows leaning toward the
    first rank's 16 experts (+0.125 on their logits, 0.6 of the logits'
    spread across tokens), so that at capacity factor 1.25 some pairs
    drop at that rank while every rank receives pairs."""
    import torch
    from repro_torch.nn.initializers import lecun_normal
    g = torch.Generator(device=device).manual_seed(SEED + 999)
    E, hs = moe_cfg.num_experts, moe_cfg.d_ff * moe_cfg.n_shared
    router = torch.randint(-3, 4, (d, E), generator=g, device=device) / 512
    router[:64, :16] += 1 / 512
    shared = {"wg": lecun_normal((d, hs), g, device),
              "wu": lecun_normal((d, hs), g, device),
              "wd": lecun_normal((hs, d), g, device)}
    x = torch.randint(-16, 17, (n_tokens, d), generator=g,
                      device=device) / 8
    x[:, :64] += 1.0
    return router, shared, x


def ep_layer(moe_cfg, d, router, shared, experts=None):
    """An MoELayer holding `router` and the shared experts; its expert
    slabs are `experts` ({wg, wu, wd} stacked over all E) or, on a rank
    that holds only its slab, left on the meta device (no memory)."""
    from repro_torch.nn.moe import MoELayer
    lay = MoELayer(d, moe_cfg, device="meta")
    state = {"router": router,
             **{f"shared.{k}": v for k, v in shared.items()},
             **(experts or {})}
    lay.load_state_dict(state, strict=False, assign=True)
    return lay


def _moe_ep_rank(mesh, moe):
    """This rank's 16 experts of moonshot's layer 0 shape, its
    `ep_tokens` tokens, moe_ep_apply at each capacity factor on the card
    (and, at the config's 1.25, on the CPU over the same gloo group).
    Returns {(cf, where): (out, calls, seconds)} and the drops."""
    import dataclasses
    import torch
    from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG
    from repro_torch.dist.moe_ep import moe_ep_apply
    from repro_torch.nn.moe import capacity
    torch.backends.cuda.matmul.allow_tf32 = False
    d, S, T = CONFIG.d_model, mesh.size, moe["ep_tokens"]
    E = CONFIG.moe.num_experts
    e_loc = E // S
    lo = mesh.rank * e_loc
    slab = ep_weights(CONFIG.moe, d, range(lo, lo + e_loc), mesh.device)
    router, shared, x = ep_inputs(CONFIG.moe, d, S * T, mesh.device)
    x = x[mesh.rank * T:(mesh.rank + 1) * T]
    out, drops = {}, {}
    for cf in moe["ep_cfs"]:
        cfg = dataclasses.replace(CONFIG.moe, capacity_factor=cf,
                                  ep_axis=("model",))
        places = [("card", mesh)] + ([("cpu", mesh.on("cpu"))]
                                     if cf == CONFIG.moe.capacity_factor
                                     else [])
        for where, m in places:
            mv = lambda t: t.to(m.device)
            lay = ep_layer(cfg, d, mv(router), {k: mv(v) for k, v in
                                                shared.items()})
            params = {"router": lay.router,
                      **{k: mv(v) for k, v in slab.items()}}
            m.reset_calls()
            xm = mv(x)
            sync(xm)
            t0 = time.perf_counter()
            with torch.no_grad():
                y = moe_ep_apply(lay, params, xm, m)
            sync(y)
            out[cf, where] = (y.cpu(), dict(m.calls),
                              time.perf_counter() - t0)
        ids = lay.route(mv(x))[0]
        C = capacity(T, CONFIG.moe.top_k, cf, S, E)
        per_dest = torch.bincount((ids // e_loc).reshape(-1), minlength=S)
        drops[cf] = (int(torch.clamp(per_dest - C, min=0).sum()),
                     ids.numel(), C, per_dest.tolist())
    peak = torch.cuda.max_memory_allocated(mesh.device) \
        if mesh.device.type == "cuda" else 0
    return out, drops, peak


def phase_moe_ep(device, moe=MOE):
    """One MoE layer at moonshot's widths over `ep_ranks` gloo ranks that
    share the card, f32: at capacity factor 8 the gathered outputs equal
    dense_oracle on all the tokens (run after the ranks exit), at 1.25 the
    same ranks' CPU run; all_to_all calls, bytes and seconds blocked."""
    import torch
    from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG
    from repro_torch.launch.mesh import spawn_stream_mesh
    n, T = moe["ep_ranks"], moe["ep_tokens"]
    d = CONFIG.d_model
    t0 = time.perf_counter()
    ranks = spawn_stream_mesh(n, _moe_ep_rank, backend="gloo",
                              device=str(device), args=(moe,),
                              timeout=moe["timeout"])
    wall = time.perf_counter() - t0
    e_cpu = 0.0
    cf_drop = CONFIG.moe.capacity_factor
    for r, (out, drops, peak) in enumerate(ranks):
        got, want = out[cf_drop, "card"][0], out[cf_drop, "cpu"][0]
        e = float(((got - want).abs() / (1 + want.abs())).max())
        check(e <= MOE_EP_TOL, f"[moe-ep] rank {r} cf {cf_drop}: card vs "
                               f"CPU {e:.3e}")
        e_cpu = max(e_cpu, e)
    for r, (out, drops, peak) in enumerate(ranks):
        for cf in moe["ep_cfs"]:
            y, calls, secs = out[cf, "card"]
            a2a = calls.get("all_to_all", [0, 0.0, 0])
            print(f"[moe-ep] rank {r} cf {cf}: pairs to each rank "
                  f"{drops[cf][3]}, capacity {drops[cf][2]} rows a "
                  f"destination, dropped {drops[cf][0]} of {drops[cf][1]}; "
                  f"all_to_all {a2a[0]} calls, "
                  f"{a2a[2]} bytes sent, {a2a[1]:.3f} s blocked of "
                  f"{secs:.3f} s (card)"
                  + (f"; CPU run {out[cf, 'cpu'][2]:.3f} s"
                     if (cf, "cpu") in out else "")
                  + f"; peak {peak / 2**30:.2f} GiB")
    check(all(drops[8.0][0] == 0 for _, drops, _ in ranks)
          if 8.0 in moe["ep_cfs"] else True,
          "[moe-ep] pairs dropped at capacity factor 8")
    # the oracle on all the tokens, one process, after the ranks exit
    experts = ep_weights(CONFIG.moe, d, range(CONFIG.moe.num_experts),
                         device)
    router, shared, x = ep_inputs(CONFIG.moe, d, n * T, device)
    lay = ep_layer(CONFIG.moe, d, router, shared, experts)
    with torch.no_grad():
        oracle = torch.cat([lay.dense_oracle(x[i:i + 1024])[0].cpu()
                            for i in range(0, n * T, 1024)])
    got = torch.cat([out[8.0, "card"][0] for out, _, _ in ranks])
    e_oracle = float(((got - oracle).abs() / (1 + oracle.abs())).max())
    check(e_oracle <= MOE_EP_TOL, f"[moe-ep] cf 8 vs dense_oracle "
                                  f"{e_oracle:.3e}")
    slab_bytes = sum(v.numel() * v.element_size() for v in experts.values())
    print(f"[moe-ep] {n} gloo ranks on one card, {T} tokens a rank, d "
          f"{d}, {CONFIG.moe.num_experts // n} experts a rank (the slabs "
          f"{slab_bytes} bytes in all, f32): cf 8 vs dense_oracle on the "
          f"gathered tokens {e_oracle:.3e}, cf {cf_drop} card vs the same "
          f"ranks' CPU run {e_cpu:.3e} (tolerance {MOE_EP_TOL} x (1 + "
          f"|ref|)); {wall:.1f} s with the ranks' start")
    del experts, lay, oracle
    free_cuda()


# [gnn-locality]: PNA at ogb_products' published widths
# (src/repro/perf/variants.py:33-36: d_feat 100, hidden 75, 4 layers, 47
# classes, avg_log_deg 3.2) on a powerlaw_edges graph (alpha 0.5, no
# community structure) cut 20x in nodes and edges from ogb_products'
# 2,449,029 / 61,859,140 (mean in-degree kept, 25.3; nodes rounded to a
# multiple of the ranks), its node ids relabelled by a seeded
# permutation, 100 standard-normal features, 47 uniform classes, every
# node labelled. Cut 20x, not 10x: at a tenth (244,904 nodes, 6,185,914
# edges) each rank held 16-18 GiB and the four ran the card out of
# memory (on an H100), the global step alone 51.74 GiB. And
# relabelled: powerlaw_edges gives the low ids the high degrees, so the
# block partition handed rank 0 half the edges (3,088,277 of 6,185,914,
# 27.4 GiB); relabelled, each rank receives ~1/4 of them.
# build_plan over `ranks` gloo ranks that share the card, each rank's
# step held to the global single-rank step on the card. Loss within
# LOC_LOSS_TOL x max(1, |loss|) (the reference's contract,
# tests/test_perf_machinery.py:36-94). Gradients per leaf within
# max(LOC_GRAD_TOL x max |global|, LOC_GAP x the gap of the global step
# against itself: run again (the card's atomic index_add_ reorders its
# sums from run to run) and run on the same graph with its node ids and
# edge order permuted), taking each leaf's larger gap. PNA's f32
# gradients are ill-conditioned (R17: its std aggregator's Σm²/n -
# (Σm/n)² cancels, and so do the reductions over nodes of its terms):
# this phase run on the CPU at 4,000 nodes, where sums run in a fixed
# order, put the global step's own f32 gradient up to 1.21e-3 of a
# leaf's max from float64 and the ranks' that far from the global
# step's (they summed closer to float64), past LOC_GRAD_TOL and the
# CPU's small gap; on an H100 the gap term carries it (the ranks
# 1.534e-4 of a leaf's max from the global step at most, against gaps
# up to 2.144e-4; a dropped halo row 1.6e-2 to 1.5e-1). The 1e-5
# contract on the updated parameters is held on the CPU only
# (tests/test_torch_locality.py).
LOC = dict(n_nodes=122_452, n_edges=3_092_957, alpha=0.5, d_feat=100,
           hidden=75, layers=4, classes=47, avg_log_deg=3.2, ranks=4,
           timeout=900)
LOC_LOSS_TOL, LOC_GRAD_TOL, LOC_GAP = 1e-5, 1e-4, 4.0


def loc_graph(loc=LOC):
    """(senders, receivers, x, labels, seconds) from numpy seeds; the
    node ids of powerlaw_edges relabelled by a seeded permutation."""
    from repro_torch.graph.graphs import powerlaw_edges
    rng = np.random.default_rng(SEED + 25)
    t0 = time.perf_counter()
    edges = powerlaw_edges(rng, loc["n_nodes"], loc["n_edges"],
                           loc["alpha"])
    edges = rng.permutation(loc["n_nodes"])[edges]
    x = rng.standard_normal((loc["n_nodes"], loc["d_feat"]),
                            dtype=np.float32)
    labels = rng.integers(0, loc["classes"], loc["n_nodes"])
    return edges[:, 0], edges[:, 1], x, labels, time.perf_counter() - t0


def loc_model(loc, device):
    from repro_torch.graph.pna import PNA
    return PNA(loc["d_feat"], loc["hidden"], loc["layers"], loc["classes"],
               loc["avg_log_deg"], seed=SEED, device=device)


def _loc_rank(mesh, loc, plan, x, labels):
    """Each case's (loss, gradients) on this rank, a timed step each,
    the exchange's calls, and the planted fault (rank 0 drops the first
    halo row it sends rank 1)."""
    import torch
    from repro_torch.dist import gnn_locality as gl
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    torch.backends.cuda.matmul.allow_tf32 = False
    model = loc_model(loc, mesh.device)
    batch = gl.rank_batch(plan, mesh.rank, x, labels,
                          np.ones(len(labels), bool), mesh.device)
    out = {}
    for case, local in (("global layers", False), ("local update", True),
                        ("dropped halo row", False)):
        if case == "dropped halo row" and mesh.rank == 0:
            batch["send_mask"] = batch["send_mask"].clone()
            batch["send_mask"][1, 0] = False
        step = gl.make_locality_train_step(model, loc["classes"], mesh,
                                           local_update=local)
        params = param_tree(model)
        mesh.reset_calls()
        loss, grads = step.grads_fn(params, batch)
        calls = {k: list(v) for k, v in mesh.calls.items()}
        sync(loss)
        t0 = time.perf_counter()
        new, _, _ = step(params, adam().init(params), batch)
        sync(next(iter(new.values())))
        out[case] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                     calls, time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(mesh.device) \
        if mesh.device.type == "cuda" else 0
    return out, peak


def loc_breaches(loss, grads, ref_loss, ref_grads, gap):
    """What of one rank's (loss, grads) misses the global step's (LOC's
    bounds); [] when it passes."""
    out = []
    if abs(loss - ref_loss) > LOC_LOSS_TOL * max(1.0, abs(ref_loss)):
        out.append(f"loss {loss} vs {ref_loss}")
    for k, w in ref_grads.items():
        e = float((grads[k] - w).abs().max())
        bound = max(LOC_GRAD_TOL * float(w.abs().max()), LOC_GAP * gap[k])
        if e > bound:
            out.append(f"grad {k}: {e} > {bound}")
    return out


def phase_gnn_locality(device, loc=LOC):
    """The locality plan on the host, the global single-rank step twice on
    the card (its gradients' run-to-run gap), then `ranks` gloo ranks on
    the card: with local_update False and True each rank's loss and
    gradients against the global step's, a planted fault the comparison
    must catch; s a step, halo rows and bytes a layer, seconds blocked in
    the exchange, the plan's host seconds, peak memory."""
    import torch
    from repro_torch.configs.base import value_and_grad
    from repro_torch.dist.gnn_locality import build_plan
    from repro_torch.graph.graphs import Graph
    from repro_torch.launch.mesh import spawn_stream_mesh
    from repro_torch.nn.module import param_tree
    cuda = device.type == "cuda"
    s, r, x, labels, graph_s = loc_graph(loc)
    N, S = loc["n_nodes"], loc["ranks"]
    t0 = time.perf_counter()
    plan = build_plan(s, r, N, S)
    plan_s = time.perf_counter() - t0
    halo = plan.send_mask.sum(axis=(0, 2))          # rows each rank gets
    print(f"[gnn-locality] graph: {N} nodes, {len(s)} powerlaw_edges "
          f"(alpha {loc['alpha']}) in {graph_s:.2f} s; build_plan over {S} "
          f"ranks {plan_s:.2f} s (host): n_loc {plan.n_loc}, e_cap "
          f"{plan.senders_local.shape[1]}, r_cap {plan.r_cap}; halo rows "
          f"a rank {halo.tolist()} ({halo.sum() / N:.3f} of the nodes "
          f"over all ranks)")

    # the global step on one rank, twice: the second on the same graph
    # with its node ids and its edge order permuted (seeded), so the two
    # differ by f32 sums taken in another order and grouping, over edges
    # and over nodes, as the ranks' partial sums differ from the global's
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = loc_model(loc, device)
    prng = np.random.default_rng(SEED + 26)
    new_id = prng.permutation(N)
    order = prng.permutation(len(s))
    old_id = np.argsort(new_id)
    graphs = ((s, r, x, labels), (s, r, x, labels),
              (new_id[s[order]], new_id[r[order]], x[old_id], labels[old_id]))
    runs, secs = [], []
    for gs, gr, gx, gy in graphs:
        g = Graph(senders=torch.as_tensor(gs, dtype=torch.int64,
                                          device=device),
                  receivers=torch.as_tensor(gr, dtype=torch.int64,
                                            device=device),
                  x=torch.as_tensor(gx, device=device))
        y = torch.as_tensor(gy, device=device)

        def global_loss():
            logp = torch.log_softmax(model(g).float(), dim=-1)
            return -torch.gather(logp, -1, y[:, None]).mean()

        sync(g.x)
        t0 = time.perf_counter()
        loss, grads = value_and_grad(model, global_loss, param_tree(model))
        sync(loss)
        secs.append(time.perf_counter() - t0)
        runs.append((float(loss), {k: v.cpu() for k, v in grads.items()}))
        del g, y, grads
    peak_global = torch.cuda.max_memory_allocated() if cuda else 0
    ref_loss, ref_grads = runs[0]
    gap = {k: max(float((run[1][k] - v).abs().max()) for run in runs[1:])
           for k, v in ref_grads.items()}
    print(f"[gnn-locality] global step on one rank: loss {ref_loss:.6f} "
          f"(again: {runs[1][0]:.6f}; nodes and edges permuted: "
          f"{runs[2][0]:.6f}); loss and gradients "
          f"{', '.join(f'{t:.3f}' for t in secs)} s; the gradients' gap "
          f"between them (the larger of the two against the first) "
          f"{max(gap.values()):.3e} at most "
          f"({sum(v > 0 for v in gap.values())} of {len(gap)} leaves "
          f"differ); peak {peak_global / 2**30:.2f} GiB")
    del model, runs
    free_cuda()

    t0 = time.perf_counter()
    ranks = spawn_stream_mesh(S, _loc_rank, backend="gloo",
                              device=str(device),
                              args=(loc, plan, x, labels),
                              timeout=loc["timeout"])
    wall = time.perf_counter() - t0
    scale = {n: float(w.abs().max()) or 1.0 for n, w in ref_grads.items()}
    print("[gnn-locality] per leaf, of its max |grad|: the global runs' gap;"
          " rank 0's error with local_update False, True, and with a dropped"
          " halo row")
    for n in ref_grads:
        errs = [float((ranks[0][0][c][1][n] - ref_grads[n]).abs().max())
                / scale[n] for c in ("global layers", "local update",
                                     "dropped halo row")]
        print(f"[gnn-locality]   {n}: gap {gap[n] / scale[n]:.3e}; "
              + ", ".join(f"{e:.3e}" for e in errs))
    for case in ("global layers", "local update"):
        worst = 0.0
        for k, (out, peak) in enumerate(ranks):
            loss, grads, calls, step_s = out[case]
            bad = loc_breaches(loss, grads, ref_loss, ref_grads, gap)
            check(not bad, f"[gnn-locality] {case}, rank {k}: {bad[:4]}")
            worst = max([worst] + [float((grads[n] - w).abs().max())
                                   / float(w.abs().max())
                                   for n, w in ref_grads.items()
                                   if float(w.abs().max())])
        halo_c = ranks[0][0][case][2].get("halo", [0, 0.0, 0])
        back_c = ranks[0][0][case][2].get("halo backward", [0, 0.0, 0])
        print(f"[gnn-locality] {case}: loss {ranks[0][0][case][0]:.6f} "
              f"(global {ref_loss:.6f}); gradients at most {worst:.3e} of a "
              f"leaf's max from the global step's; s a step (forward, "
              f"backward, all_reduce, clip, Adam) "
              f"{[round(o[case][3], 4) for o, _ in ranks]}; rank 0's halo "
              f"exchange {halo_c[0]} calls ({loc['layers']} a forward), "
              f"{halo_c[2]} bytes sent, {halo_c[1]:.3f} s blocked; its "
              f"backward {back_c[0]} calls, {back_c[2]} bytes, "
              f"{back_c[1]:.3f} s")
    planted = [loc_breaches(o["dropped halo row"][0],
                            o["dropped halo row"][1], ref_loss, ref_grads,
                            gap) for o, _ in ranks]
    check(all(planted), f"[gnn-locality] a dropped halo row passes the "
                        f"comparison on some rank: {planted}")
    print(f"[gnn-locality] planted fault (rank 0 drops one halo row it "
          f"sends rank 1): every rank fails the comparison, e.g. "
          f"{planted[1][:2]}; peaks a rank "
          f"{[round(p / 2**30, 2) for _, p in ranks]} GiB; {wall:.1f} s "
          f"with the ranks' start; the graph has no community structure, "
          f"so its halo (an upper bound on a co-purchase graph's) holds "
          f"nearly every vertex")


# ------------------------------------------------------------- tooling
DRYRUN = dict(multi_lms=("llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b",
                         "mistral-large-123b", "mistral-nemo-12b",
                         "internlm2-20b"), check_seq=2048)


def phase_dryrun_meta(d=DRYRUN):
    """Every single-mesh cell (d3gnn-sage included) and the LMs'
    train_4k on the multi-pod mesh through `run_cell` on meta; all must
    pass."""
    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun
    cells = [(a, s, False) for a, s in all_cells(include_extra=True)]
    cells += [(a, "train_4k", True) for a in d["multi_lms"]]
    t0, failures = time.perf_counter(), []
    for arch, shape, multi in cells:
        tag = f"{arch} x {shape} x {'multi' if multi else 'single'}"
        try:
            print(dryrun.ok_line(tag, dryrun.run_cell(arch, shape, multi)))
        except Exception as e:  # noqa: BLE001 - every cell is reported
            failures.append(f"{tag}: {e!r}")
            print(f"[FAIL] {tag}: {e!r}")
    print(f"[dryrun-meta] {len(cells)} cells, "
          f"{time.perf_counter() - t0:.1f}s, {len(failures)} failures")
    check(not failures, f"dry-run cells failed: {failures}")


def _counted(fn, *args):
    from repro_torch.roofline.analysis import analyze_step
    r = analyze_step(fn, *args)
    return (r["op_flops"], r["op_bytes"], r["op_masked_flops"],
            r["_counter"].kernels.get("flash_attention", [0, 0, 0])[1])


def dryrun_count_checks(device, d=DRYRUN):
    """The analyzer through kernels 5 and 4 against their plain versions
    on the same model and inputs. Flash: the kernel is charged the
    causal pairs' products, L x 4 H D S (S + 1) / 2 at batch 1 (the
    closed form of row 5's bound), the plain attention's aten products
    (every pair) less their masked share, L x 4 H D S (S - 1) / 2, come
    to the same total, and the kernel counts fewer bytes. The bag: equal
    FLOPs."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.nn import attention
    from repro_torch.recsys import embedding_bag
    gen = torch.Generator(device=device).manual_seed(SEED)
    spec = get_arch("mistral-nemo-12b")
    model = spec.build(device=device, seed=SEED)
    step = spec.step(model, "prefill_32k")
    tok = torch.randint(0, model.cfg.vocab, (1, d["check_seq"]),
                        generator=gen, device=device)
    fa_ops.reset_launches()
    kern = _counted(step, tok)
    check(fa_ops.LAUNCHES["flash_attention_wgmma"] == model.cfg.n_layers,
          f"flash launched {fa_ops.LAUNCHES} in the counted prefill")
    with mock.patch.object(attention, "flash_attention",
                           fa_ref.attention_ref):
        plain = _counted(step, tok)
    cfg, S = model.cfg, d["check_seq"]
    per_pair = cfg.n_layers * 4 * cfg.n_heads * cfg.head_dim
    visible, masked = S * (S + 1) // 2, S * (S - 1) // 2
    print(f"[dryrun-card] mistral-nemo-12b prefill S={S}: kernel 5 "
          f"{kern[0]} FLOPs ({kern[3]} of them the kernel's), "
          f"{kern[1]} bytes; plain attention {plain[0]} FLOPs and "
          f"{plain[2]} masked, {plain[1]} bytes; closed form: the "
          f"attention's causal pairs {per_pair * visible}, masked "
          f"{per_pair * masked}")
    check(kern[3] == per_pair * visible, "kernel 5's FLOPs "
          "are not the causal pairs' products")
    check(kern[2] == 0 and plain[2] == per_pair * masked, "the masked "
          "pairs' products are not charged apart in closed form")
    check(kern[0] == plain[0], "kernel 5's FLOPs differ from the plain "
          "attention's")
    check(kern[1] < plain[1], "kernel 5 counts no fewer bytes than the "
          "plain attention")
    del model, step
    free_cuda()
    spec = get_arch("two-tower-retrieval")
    model = spec.build(device=device, seed=SEED)
    step = spec.step(model, "serve_p99")
    c = model.cfg
    ids = torch.randint(0, c.user_vocab, (spec.shapes["serve_p99"].dims[
        "batch"], c.user_fields, c.max_ids_per_field), generator=gen,
        device=device, dtype=torch.int64).to(torch.int32)
    kern = _counted(step, {"user_ids": ids})
    with mock.patch.object(embedding_bag.ops, "embedding_bag",
                           eb_ref.embedding_bag_ref):
        plain = _counted(step, {"user_ids": ids})
    print(f"[dryrun-card] two-tower serve_p99: kernel 4 {kern[0]} FLOPs "
          f"{kern[1]} bytes; plain lookup {plain[0]} FLOPs {plain[1]} "
          "bytes")
    check(kern[0] == plain[0], "kernel 4's FLOPs differ from the plain "
          "lookup's")
    del model, step
    free_cuda()


def phase_dryrun_card(device, card):
    """The one-card cells, one real step each (counts reset before, read
    after: kernels 5, 4, 1 and 2 must launch; the d3gnn tick, on live
    records, must emit), then the count checks."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.segment_reduce import ops as sr_ops
    from repro_torch.launch import dryrun
    for m in (fa_ops, eb_ops, sr_ops):
        m.reset_launches()
    for arch, shape in dryrun.CARD_CELLS:
        r = dryrun.run_cell(arch, shape, False, device="cuda")
        print(dryrun.ok_line(f"{arch} x {shape} x card", r))
        print(f"[dryrun-card] {arch} {shape}: first call "
              f"{r['first_call_s']:.3f} s, step {r['step_s']:.4f} s, peak "
              f"{r['peak_memory_gb']:.3f} GiB, op {r['op_gflops']:.3f} "
              f"GFLOP, {r['op_bytes_gb']:.3f} GiB; t_compute "
              f"{r['t_compute_s']} s, t_memory {r['t_memory_s']} s "
              f"({r['bottleneck']}); {r['roofline_fraction_measured']:.4f} "
              f"of the roofline at {r['peak_flops'] / 1e12:.0f} TFLOP/s and "
              f"3.35 TB/s ({card}); reduced {r['reduced']}; kernels "
              f"{ {k: v['calls'] for k, v in r['kernels'].items()} }"
              + (f"; live load {r['load']}, layer 1 emitted "
                 f"{r['emitted']} rows" if "load" in r else ""))
        check("load" not in r or r["emitted"] > 0, f"[dryrun-card] the "
              f"{arch} tick on live records emitted nothing: {r.get('load')}")
        free_cuda()
    launches = {**fa_ops.LAUNCHES, **eb_ops.LAUNCHES, **sr_ops.LAUNCHES}
    print(f"[dryrun-card] launches over the cells: {launches}")
    for k in ("flash_attention", "embedding_bag", "segment_sum_rows",
              "mean_rows_gather"):
        check(launches[k] > 0, f"{k} never launched in [dryrun-card]")
    dryrun_count_checks(device)
    return launches


def phase_perf_variants():
    from repro_torch.perf import run as perf_run
    from repro_torch.perf.variants import VARIANTS
    for name in VARIANTS:
        r = perf_run.run_variant(name)
        print(perf_run.ok_line(r))
        check(r["op_gflops"] > 0, f"{name} counted no FLOPs")


# ------------------------------------------------------------ examples
# The lines of each example's printout that hold the JAX example's
# integers, as `examples/<name>.py` prints them at the same flags on the
# CPU (the weights are random, so losses are not pinned; walls, rates and
# latencies are not compared). streaming_serve restores the cut it saved.
def _serve_pins(recovered):
    return ("checkpointed at tick 16 (emitted so far: 0, queries "
            "answered: 25)", f"recovered checkpoint step=16; {recovered}",
            "emitted=317 reduce_msgs=8689 cross_part=6929",
            "queries resolved=93 (ok=18, device-answered=93, dropped=0, "
            "shed=0, degraded_ticks=0)", "staleness ticks p50=0 max=25",
            "embedding table size: 313 (read_nodes on 8 vids: 8)",
            "serve driver OK")


EXAMPLE_PINS = {
    "quickstart": (
        "mesh: {'data': 1}",
        "ticks=11 emitted=130 reduce_msgs=2010 cross_part=1708 "
        "replication=1.67", "embeddings materialized: 130;",
        "StartTraining votes: 8/8", "quickstart OK"),
    "train_streaming_gnn": (
        "phase 0: steps=42 ", "phase 1: steps=89 ", "phase 2: steps=136 ",
        "online continual-training driver OK"),
    "train_streaming_gnn --mode halt-flush": (
        "phase 0: votes=8 flush_ticks=3 ", "phase 1: votes=8 flush_ticks=3 ",
        "phase 2: votes=8 flush_ticks=3 ",
        "halt-flush continual-training driver OK"),
    "streaming_serve": _serve_pins("single-shard relay"),
    "streaming_serve --ranks 4": _serve_pins(
        "live reshard 4->2 shards moved 75% of logical parts"),
    "arch_zoo": tuple("decode logits (2, 1, 512)" for _ in range(5)) + tuple(
        "forward out (64, 7), finite=True" for _ in range(4)) + (
        "retrieval (1, 8)",),
}


def _example_pins(name, lines):
    """Every pinned fragment in the printout, each on its own line (in
    order), and no backlog left by the online driver."""
    rest = list(lines)
    for pin in EXAMPLE_PINS[name]:
        hit = next((i for i, x in enumerate(rest) if pin in x), None)
        check(hit is not None, f"[examples] {name}: no line holds {pin!r} "
                               f"in {lines}")
        rest = rest[hit + 1:]
    check(all("backlog=" not in x or x.endswith("backlog=0")
              for x in lines), f"[examples] {name}: backlog left {lines}")


def phase_examples(device):
    """The four examples on the card (see the docstring's [examples]);
    on another device (a rehearsal) with --device."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    from importlib import import_module

    import torch
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.segment_reduce import ops as sr_ops
    tmp = tempfile.mkdtemp(prefix="examples-")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    mesh_name = "streaming_serve --ranks 4"
    on = [] if device.type == "cuda" else ["--device", str(device)]
    t_mesh = time.perf_counter()
    # its output goes to files: a pipe nobody reads until the end can fill
    log_out, log_err = (open(Path(tmp) / n, "w+") for n in ("out", "err"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.streaming_serve",
         "--ranks", "4", "--ckpt-dir", str(Path(tmp) / "ranks4"), *on],
        env=env, cwd=str(ROOT), stdout=log_out, stderr=log_err, text=True)
    try:
        for m in (fa_ops, eb_ops, sr_ops):
            m.reset_launches()
        for name in EXAMPLE_PINS:
            if name == mesh_name:
                continue
            mod, *argv = name.split()
            if mod == "streaming_serve":
                argv += ["--ckpt-dir", str(Path(tmp) / "one")]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):  # echoed below
                say = import_module(f"repro_torch.examples.{mod}").main(
                    argv + on)
            if device.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            _example_pins(name, say.lines)
            print(f"[examples] {name}: {secs:.2f} s on the card; "
                  + " | ".join(say.lines))
        launches = {**fa_ops.LAUNCHES, **eb_ops.LAUNCHES, **sr_ops.LAUNCHES}
        print(f"[examples] launches over the in-process examples: "
              f"{launches}")
        for k in ("segment_sum_rows", "mean_rows_gather", "flash_attention",
                  "embedding_bag"):
            check(launches[k] > 0, f"[examples] {k} never launched")
        proc.wait(timeout=600)
        secs = time.perf_counter() - t_mesh
        out, err = (f.seek(0) or f.read() for f in (log_out, log_err))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_out.close()
        log_err.close()
        shutil.rmtree(tmp, ignore_errors=True)
    lines = out.strip().splitlines()
    check(proc.returncode == 0, f"[examples] {mesh_name} exited "
                                f"{proc.returncode}:\n{out}\n{err[-4000:]}")
    _example_pins(mesh_name, lines)
    print(f"[examples] {mesh_name}: {secs:.2f} s from its start beside the "
          f"others, the ranks' start included; " + " | ".join(lines))
    free_cuda()


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
    clock = [time.perf_counter()]

    def phase(name, fn, *args):
        """Run one phase and print its seconds."""
        out = fn(*args)
        now = time.perf_counter()
        print(f"[secs] {name}: {now - clock[0]:.1f}s")
        clock[0] = now
        return out

    phase("build", build_kernels)
    errs = phase("kernels", phase_kernels_vs_plain, device)
    phase("parity", phase_parity_gate, device)
    pipe, launches, baseline = phase("full", phase_full_width, FULL, device)
    result = phase("time", phase_timing, pipe, launches, errs)
    # the same stream as phase 4 (its pipeline is the eps = 0 run)
    edges, feats = make_stream(FULL["n_nodes"], FULL["n_edges"],
                               FULL["dims"][0])
    gate_info = phase("gate-full", phase_gate_full, device, pipe, edges,
                      feats)
    del pipe
    phase("profile", phase_profile, FULL, device)
    free_cuda()
    phase("query-parity", phase_query_parity, device)
    phase("query-full", phase_query_full, device, baseline)
    free_cuda()
    phase("gate-parity", phase_gate_parity, device)
    phase("train-parity", phase_train_parity, device)
    tpipe = phase("train-full (a)", phase_train_exact, device, edges, feats)
    online = phase("train-full (b)", phase_train_online, device, edges,
                   feats, baseline)
    seg = result["kernels"][0]
    seg["call_sites"] = phase("train-time", phase_train_time, tpipe, errs,
                              online["launches_per_tick"], gate_info)
    seg["max_abs_err"] = errs["segment_sum_rows"]
    del tpipe, edges, feats
    free_cuda()
    phase("telemetry-parity", phase_telemetry_parity, device)
    phase("telemetry-full", phase_telemetry_full, device, baseline)
    free_cuda()
    phase("ckpt-parity", phase_ckpt_parity, device)
    phase("ckpt-full", phase_ckpt_full, device)
    free_cuda()
    mesh_err = phase("mesh-kernel", phase_mesh_kernel, device)
    mesh_trace = phase("mesh-parity", phase_mesh_parity, device)
    mesh_launches, rate, mesh_emb = phase("mesh-full", phase_mesh_full,
                                          device, FULL, MESH, card)
    phase("what-if", phase_what_if, mesh_trace, rate, card)
    result["kernels"].append(phase("mesh-time", phase_mesh_time, device,
                                   mesh_launches, mesh_err))
    free_cuda()
    phase("stage-parity", phase_stage_parity, device)
    phase("stage-full", phase_stage_full, device, FULL, STAGE, card)
    phase("reshard-full", phase_reshard_full, device, mesh_emb, FULL, MESH,
          RESHARD, card)
    del mesh_emb
    phase("decode-partial", phase_decode_partial, device)
    free_cuda()
    fa_err = phase("lm-kernel", phase_lm_kernel, device)
    phase("lm-parity", phase_lm_parity, device)
    lm_launches = phase("lm-full", phase_lm_full, device)
    result["kernels"].append(phase("lm-time", phase_lm_time, device,
                                   lm_launches, fa_err))
    free_cuda()
    eb_err = phase("rs-kernel", phase_rs_kernel, device)
    phase("rs-parity", phase_rs_parity, device)
    rs_launches = phase("rs-full", phase_rs_full, device)
    result["kernels"].append(phase("rs-time", phase_rs_time, device,
                                   rs_launches, eb_err))
    free_cuda()
    zoo_kernels = phase("train-zoo-kernel", phase_train_zoo_kernel, device)
    phase("train-zoo-parity", phase_train_zoo_parity, device)
    phase("lm-train", phase_lm_train, device)
    rs_train = phase("rs-train", phase_rs_train, device)
    zoo_kernels[0]["launches"] = rs_train["embedding_bag"]
    zoo_kernels[1]["launches"] = rs_train["segment_sum_rows"]
    result["kernels"] += zoo_kernels
    phase("train-cli", phase_train_cli, device)
    free_cuda()
    gnn_batch, _ = gnn_minibatch(device)
    gnn_kernels = phase("gnn-kernel", phase_gnn_kernel, device, gnn_batch)
    phase("gnn-parity", phase_gnn_parity, device)
    _, gnn_launches = phase("gnn-train", phase_gnn_train, device, gnn_batch)
    for entry in gnn_kernels[:2]:
        entry["launches"] = gnn_launches["segment_sum_rows"]
    gnn_kernels[2]["launches"] = gnn_launches["mean_rows_gather"]
    result["kernels"] += gnn_kernels
    del gnn_batch
    free_cuda()
    phase("gnn-cli", phase_gnn_cli, device)
    free_cuda()
    phase("moe-parity", phase_moe_parity, device)
    moe_launches = phase("moe-full", phase_moe_full, device)
    result["kernels"].append(phase("moe-time", phase_moe_time, device,
                                   moe_launches, fa_err))
    free_cuda()
    phase("moe-ep", phase_moe_ep, device)
    phase("gnn-locality", phase_gnn_locality, device)
    free_cuda()
    phase("dryrun-meta", phase_dryrun_meta)
    phase("dryrun-card", phase_dryrun_card, device, card)
    phase("perf-variants", phase_perf_variants)
    phase("examples", phase_examples, device)
    print("[card] all times above on this card:")
    print(card)
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
