"""The port's tooling (repro_torch.launch.dryrun, dist.sharding,
launch.mesh.make_production_mesh, roofline/, perf/) against the JAX
package on the CPU.

  * `all_cells` equals JAX's list in order, with and without d3gnn-sage;
    the ArchSpec fields the dry run reads (batch_style, donate_inputs,
    the LMs' act_pspec) equal JAX's;
  * `make_production_mesh` has JAX's axes and sizes (JAX's function run
    with `jax.make_mesh` answering an AbstractMesh: no 256 devices);
  * `model_flops` equals JAX's for all 40 cells within 1e-12 relative;
  * per-device parameter and Adam-state bytes under FAMILY_PARAM_RULES
    equal JAX's, from its PartitionSpecs on eval_shape trees over an
    AbstractMesh, for every arch on both meshes; the rules give JAX's
    spec on every port leaf's shape; the inputs' shard shapes equal
    JAX's for every cell on both meshes;
  * the analyzer: a loop of K n x n matmuls counts exactly K 2 n^3 (the
    counterpart of test_system.py's scan test); one row written a step
    into an [N, d] buffer is charged per row (test_perf_machinery.py's
    DUS test), and a gather of rows per row; its dot FLOPs, with the
    causal mask's masked pairs (charged apart, in closed form) added
    back, equal JAX's `analyze_hlo` of the same reduced steps compiled
    on one CPU device (LM prefill, MoE prefill, PNA forward, the
    two-tower serve step) exactly, GatedGCN's forward but for the one
    product XLA folds into a multiply (its edge embedding contracts over
    1), and a reduced LM train step (8 microbatches, remat in both:
    equal); the kernel entries' shape functions on `meta` are charged
    their plain versions' FLOPs;
  * the bilinear extrapolation the dry run traces LMs by equals a full
    trace; `run_cell` on meta passes for a cell of each family and fails
    a shape that does not fit; roofline_terms and the report's tables
    equal JAX's for the same rows and constants;
  * the counting mesh's collective calls and bytes by kind equal a real
    gloo run's StreamMesh.calls for the locality step at S = 2; every
    variant builds and traces on meta at a small mesh.
"""
import math
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

import repro.launch.mesh as jax_mesh_mod
from repro.configs import all_cells as jax_all_cells
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import make_optimizer as jax_make_optimizer
from repro.dist import sharding as jsh
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro.roofline.hlo_analyzer import analyze_hlo
from repro.roofline.model_flops import model_flops as jax_model_flops
from repro_torch.configs import CELL_ARCH_IDS, all_cells, get_arch
from repro_torch.configs.base import lm_step, make_optimizer
from repro_torch.dist import sharding
from repro_torch.dist.dry_mesh import CountingMesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (ProductionMesh, make_production_mesh,
                                     spawn_stream_mesh)
from repro_torch.nn.module import param_tree
from repro_torch.nn.transformer import TransformerLM
from repro_torch.perf import run as perf_run
from repro_torch.perf import variants
from repro_torch.roofline import analysis, report
from repro_torch.roofline.model_flops import model_flops
from repro_torch.roofline.op_analyzer import OpCounter

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_zoo_harness import jax_graph, port_graph, random_graph  # noqa: E402

META = torch.device("meta")
ARCHS = list(CELL_ARCH_IDS) + ["d3gnn-sage"]
CELLS = all_cells(include_extra=True)


def abstract(mesh: ProductionMesh) -> AbstractMesh:
    return AbstractMesh(mesh.dims, mesh.axis_names)


def port_model(arch, shape, train=False):
    spec = get_arch(arch)
    if spec.family == "gnn":
        return spec.build(shape, device=META, train=train)
    if spec.family == "d3gnn":
        return spec.build(device=META)
    return spec.build(device=META, train=train)


def jax_model(arch, shape):
    spec = jax_get_arch(arch)
    return spec.build(shape) if spec.family != "lm" else spec.build()


# ------------------------------------------------------------ registry
@pytest.mark.parametrize("extra", [False, True])
def test_all_cells_equal_jax_in_order(extra):
    assert all_cells(include_extra=extra) == jax_all_cells(
        include_extra=extra)
    assert len(all_cells(include_extra=extra)) == 40 + extra


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_spec_dry_run_fields_equal_jax(arch):
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    assert spec.batch_style == jspec.batch_style
    assert spec.optimizer == getattr(jspec, "optimizer", "adam")
    for s in spec.shapes:
        assert spec.donate_inputs(s) == jspec.donate_inputs(s)
    if spec.family == "lm":
        mesh = make_production_mesh(multi_pod=True)
        tuned = spec.tune_for_mesh(port_model(arch, None), mesh)
        jtuned = jspec.tune_for_mesh(jax_model(arch, None), abstract(mesh))
        assert tuned.act_pspec == jtuned.cfg.act_pspec


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_matches_jax(monkeypatch, multi):
    monkeypatch.setattr(jax_mesh_mod.jax, "make_mesh",
                        lambda shape, axes: AbstractMesh(shape, axes))
    want = jax_mesh_mod.make_production_mesh(multi_pod=multi)
    got = make_production_mesh(multi_pod=multi)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == want.size
    from repro_torch.launch.mesh import all_axes, data_axes
    assert data_axes(got) == jax_mesh_mod.data_axes(want)
    assert all_axes(got) == jax_mesh_mod.all_axes(want)


# ---------------------------------------------------------- model flops
@pytest.mark.parametrize("arch,shape", jax_all_cells(),
                         ids=[f"{a}-{s}" for a, s in jax_all_cells()])
def test_model_flops_equal_jax(arch, shape):
    want = jax_model_flops(arch, shape)
    got = model_flops(arch, shape)
    assert abs(got - want) <= 1e-12 * abs(want), (got, want)


# ------------------------------------------------------- sharding rules
def _jax_bytes_per_device(tree, rule, mesh) -> int:
    am = abstract(mesh)
    return sum(math.prod(NamedSharding(am, rule(leaf, am)).shard_shape(
        leaf.shape)) * leaf.dtype.itemsize for leaf in jax.tree.leaves(tree))


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_bytes_per_device_equal_jax(arch, multi):
    """JAX's params and Adam state (eval_shape) under its rule on an
    AbstractMesh against the port's meta-built parameters and state; the
    port's rule on each port leaf's shape gives JAX's spec."""
    mesh = make_production_mesh(multi_pod=multi)
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    shape = next(iter(spec.shapes))
    jp = jax.eval_shape(jax_model(arch, shape).init, jax.random.key(0))
    jo = jax.eval_shape(jax_make_optimizer("adam").init, jp)
    params = param_tree(port_model(arch, shape, train=True))
    opt = make_optimizer(spec.optimizer).init(params)
    rule, jrule = (sharding.FAMILY_PARAM_RULES[spec.family],
                   jsh.FAMILY_PARAM_RULES[jspec.family])
    for tree, jtree in ((params, jp), (opt, jo)):
        got = sharding.tree_bytes_per_device(
            tree, sharding.spec_tree(tree, rule, mesh), mesh)
        assert got == _jax_bytes_per_device(jtree, jrule, mesh)
    am = abstract(mesh)
    for name, t in params.items():
        want = tuple(jrule(jax.ShapeDtypeStruct(t.shape, jnp.float32), am))
        assert rule(t, mesh) == want, name


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_shard_shapes_equal_jax(arch, shape):
    """Each input's shape, spec and shard shape under the input rule on
    both meshes (JAX's int32 ids are int64 in the port: dtypes are not
    compared)."""
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    kind = spec.shapes[shape].kind
    model = port_model(arch, shape)
    jm = None if arch == "d3gnn-sage" else jax_model(arch, shape)
    inputs = dryrun._alloc(spec.input_specs(model, shape), dryrun._meta)
    jin = jspec.input_specs(jm, shape)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        got = sharding.FAMILY_INPUT_RULES[spec.family](inputs, mesh, kind)
        want = jsh.FAMILY_INPUT_RULES[jspec.family](jin, abstract(mesh),
                                                    kind)
        for k in inputs:
            leaves = inputs[k] if isinstance(inputs[k], dict) else {
                None: inputs[k]}
            specs = got[k] if isinstance(got[k], dict) else {None: got[k]}
            for name, t in leaves.items():
                jl = want[k] if name is None else getattr(want[k], name)
                jt = jin[k] if name is None else getattr(jin[k], name)
                assert tuple(t.shape) == tuple(jt.shape), (k, name)
                assert specs[name] == tuple(jl.spec), (k, name)
                assert sharding.shard_shape(t.shape, specs[name], mesh) \
                    == tuple(jl.shard_shape(jt.shape)), (k, name)


# ------------------------------------------------------------- analyzer
def test_analyzer_counts_a_loop_of_matmuls_exactly():
    n, K = 64, 5
    x = torch.randn(n, n)
    ws = torch.randn(K, n, n)
    with OpCounter() as c:
        for i in range(K):
            x = x @ ws[i]
    assert c.flops == K * 2 * n ** 3


def test_analyzer_charges_a_row_write_per_row():
    """Eight steps write one [d] row into an [N, d] buffer (a slice copy
    and an index_copy_): charged per row, never per buffer."""
    N, K, d = 1024, 8, 64
    buf = torch.zeros(N, d)
    row = torch.ones(d)
    with OpCounter() as c:
        for i in range(K):
            buf[i] = row
    assert c.bytes == K * 2 * d * 4              # the row read and written
    with OpCounter() as c:
        for i in range(K):
            buf.index_copy_(0, torch.tensor([i]), row[None])
    buf_bytes = N * d * 4
    assert c.bytes < K * buf_bytes / 4
    # the index, the row read and the row written, a step
    assert c.by_op["index_copy_.default"][2] == K * (8 + 2 * d * 4)


def test_analyzer_charges_a_row_gather_per_row():
    """Gathering 8 rows of a [4096, 64] table (an index, an embedding
    lookup): the indices, the rows read and the rows written, never the
    table."""
    table = torch.randn(4096, 64)
    idx = torch.arange(8) * 7
    row_bytes = 8 * 64 * 4
    for fn in (lambda: table[idx],
               lambda: torch.nn.functional.embedding(idx, table)):
        with OpCounter() as c:
            fn()
        assert c.bytes == 8 * 8 + 2 * row_bytes


def _jax_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "moonshot-v1-16b-a3b"])
def test_dot_flops_equal_jax_on_a_reduced_prefill(arch):
    jspec, spec = jax_get_arch(arch), get_arch(arch)
    jm = jspec.build_reduced()
    tok = np.random.default_rng(0).integers(0, 512, (2, 32))
    want = _jax_flops(jspec.step(jm, "prefill_32k"),
                      jm.init(jax.random.key(0)), jnp.asarray(tok, jnp.int32))
    model = spec.build_reduced(device="cpu")
    got = analysis.analyze_step(spec.step(model, "prefill_32k"),
                                torch.as_tensor(tok))
    # the aten products ran every pair; the causal masked half is charged
    # apart, 4 B H D S (S - 1) / 2 a layer
    cfg = model.cfg
    B, S = tok.shape
    assert got["op_masked_flops"] == cfg.n_layers * 4 * B * cfg.n_heads \
        * cfg.head_dim * S * (S - 1) // 2
    assert got["op_flops"] + got["op_masked_flops"] == want


def test_dot_flops_equal_jax_on_gnn_forwards():
    """PNA's forward exactly; GatedGCN's but for its edge embedding, an
    [E, 1] x [1, d] product XLA folds into a broadcast multiply (no dot
    in its HLO): the port counts 2 E d more."""
    b = random_graph(0, d_feat=16)
    for arch, gap in (("pna", 0), ("gatedgcn", None)):
        jm = jax_get_arch(arch).build_reduced("full_graph_sm")
        jp = jm.init(jax.random.key(0))
        want = _jax_flops(lambda p, g: jm(p, g), jp, jax_graph(b))
        model = get_arch(arch).build_reduced("full_graph_sm", device="cpu")
        got = analysis.analyze_step(lambda g: model(g), port_graph(b))
        if gap is None:
            gap = 2 * len(b["senders"]) * model.d_hidden
        assert got["op_flops"] - want == gap, arch
        assert got["op_masked_flops"] == 0


def test_dot_flops_equal_jax_on_the_two_tower_serve_step():
    jspec, spec = jax_get_arch("two-tower-retrieval"), get_arch(
        "two-tower-retrieval")
    jm = jspec.build_reduced()
    ids = np.random.default_rng(0).integers(-1, 1000, (16, 2, 4))
    want = _jax_flops(jspec.step(jm, "serve_p99"), jm.init(
        jax.random.key(0)), {"user_ids": jnp.asarray(ids, jnp.int32)})
    model = spec.build_reduced(device="cpu")
    got = analysis.analyze_step(spec.step(model, "serve_p99"), {
        "user_ids": torch.as_tensor(ids, dtype=torch.int32)})
    assert got["op_flops"] == want and got["op_masked_flops"] == 0


def test_dot_flops_equal_jax_on_a_reduced_lm_train_step():
    """Eight microbatches, Adam: JAX's step rematerialises each layer
    group (nothing saveable) and each loss chunk in the backward, and the
    port's checkpoints each layer and each loss chunk: both count the
    recomputed forward, so the counts are equal, remat included. The
    port charges the causal mask's masked pairs apart: 8 products over
    them a layer (the forward's 2, the recomputed forward's 2, the
    backward's 4), 2 B H D S (S - 1) / 2 each."""
    arch = "mistral-nemo-12b"
    jspec, spec = jax_get_arch(arch), get_arch(arch)
    jm = jspec.build_reduced()
    jp = jm.init(jax.random.key(0))
    tok = np.random.default_rng(1).integers(0, 512, (256, 16))
    jt = jnp.asarray(tok, jnp.int32)
    from repro.configs.base import lm_step as jax_lm_step
    want = _jax_flops(jax_lm_step(jm, "train_4k"), jp,
                      jax.eval_shape(jax_make_optimizer("adam").init, jp),
                      jt, jt)
    model = spec.build_reduced(device="cpu", train=True)
    params = param_tree(model)
    got = analysis.analyze_step(lm_step(model, "train_4k"), params,
                                make_optimizer("adam").init(params),
                                torch.as_tensor(tok), torch.as_tensor(tok))
    cfg = model.cfg
    B, S = tok.shape
    assert got["op_masked_flops"] == cfg.n_layers * 8 * 2 * B \
        * cfg.n_heads * cfg.head_dim * S * (S - 1) // 2
    assert got["op_flops"] + got["op_masked_flops"] == want


def test_kernel_shape_functions_report_the_plain_versions_flops():
    """On `meta` a kernel entry allocates and notes its operands: flash
    attention is charged the causal pairs' products, 4 B H D S (S + 1)
    / 2, as its plain version is (counted on the CPU through its aten
    products, less their masked share), and its own bytes (q, k, v,
    out); the bag lookup no FLOPs and fewer bytes than its plain
    version's gather."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    B, S, H, Kh, D = 1, 96, 4, 2, 16
    q, k, v = (torch.randn(B, S, h, D) for h in (H, Kh, Kh))
    plain = analysis.analyze_step(fa_ref.attention_ref, q, k, v)
    qm, km, vm = (t.to(META) for t in (q, k, v))
    kern = analysis.analyze_step(fa_ops.flash_attention, qm, km, vm)
    causal = 4 * B * H * D * S * (S + 1) // 2
    assert kern["op_flops"] == plain["op_flops"] == causal
    assert plain["op_masked_flops"] == 4 * B * H * S * S * D - causal
    assert kern["op_masked_flops"] == 0
    assert kern["kernels"]["flash_attention"]["calls"] == 1
    assert kern["op_bytes"] < plain["op_bytes"]
    assert kern["_out"].shape == q.shape
    table = torch.randn(500, 32)
    ids = torch.randint(-1, 500, (64, 8))
    plain = analysis.analyze_step(eb_ops.embedding_bag, table, ids)
    kern = analysis.analyze_step(eb_ops.embedding_bag, table.to(META),
                                 ids.to(META))
    assert kern["op_flops"] == plain["op_flops"] == 0
    assert 0 < kern["op_bytes"] < plain["op_bytes"]
    assert kern["_out"].shape == (64, 32)


def test_kernel_notes_are_charged_the_rows_the_data_reads():
    """Where the data decides which rows a kernel reads, a note on a
    tensor with data is charged those rows and one on `meta` the host's
    bound: the delivery's records in runs (add) or its non-empty runs
    (set), the picks with a count > 0, the live ids, the placed rows."""
    from repro_torch.roofline.op_analyzer import NOTE_COSTS
    d = 8
    row_ptr = torch.tensor([0, 2, 2, 5])        # 5 of 9 records in runs
    out = torch.empty(3, d)
    base = dict(n_rec=9, cnt=None, order=torch.arange(9), base=None,
                base_cnt=None, out=out, cnt_out=None,
                flag=torch.empty(3, dtype=torch.bool))
    fixed = 4 * 8 + 9 * 8 + 3 * d * 4 + 3
    for mode, live, bound in (("add", 5, 9), ("set", 2, 3)):
        o = dict(base, mode=mode, row_ptr=row_ptr)
        assert NOTE_COSTS["segment_sum_rows"](o) == (0, live * d * 4
                                                     + fixed)
        o = {k: v.to(META) if isinstance(v, torch.Tensor) else v
             for k, v in o.items()}
        assert NOTE_COSTS["segment_sum_rows"](o) == (0, bound * d * 4
                                                     + fixed)
    cnt = torch.tensor([0.0, 2.0, 1.0])
    rows = torch.tensor([0, 1, 2, 0])             # 2 picks with cnt > 0
    o = dict(rows=rows, cnt=cnt, out=torch.empty(4, d))
    assert NOTE_COSTS["mean_rows_gather"](o) == (
        0, 4 * 4 + 2 * d * 4 + 4 * 8 + 4 * d * 4)
    ids = torch.tensor([[3, -1], [-1, -1], [0, 7]])
    o = dict(ids=ids, out=torch.empty(3, d))
    assert NOTE_COSTS["embedding_bag"](o) == (0, 3 * d * 4 + 6 * 8
                                              + 3 * d * 4)
    starts = torch.tensor([0, 5, 6])              # 5 rows to 0, 1 to 1
    o = dict(order=torch.arange(7), starts=starts, out=torch.empty(8, d))
    assert NOTE_COSTS["route_pack"](o) == (0, (4 + 1) * d * 4 + 7 * 8
                                           + 3 * 8 + 8 * d * 4)


def test_extrapolation_equals_a_full_trace():
    """A 4-layer LM's train step at 8 microbatches, traced whole, against
    the probes at 1 and 2 layers and microbatches, extrapolated."""
    from dataclasses import replace
    from repro_torch.configs.mistral_nemo_12b import REDUCED

    def count_at(g, k):
        model = TransformerLM(replace(REDUCED, n_layers=g), META, 0, True)
        params = param_tree(model)
        tok = torch.empty((k * 2, 64), dtype=torch.int64, device=META)
        return analysis.counts_of(analysis.analyze_step(
            lm_step(model, "train_4k", grad_accum=k), params,
            make_optimizer("adam").init(params), tok, tok))

    got, probes = analysis.extrapolate(count_at, 4, 8)
    want = count_at(4, 8)
    assert probes["to_layer_groups"] == 4 and probes["to_microbatches"] == 8
    assert got["flops"] == want["flops"] and got["bytes"] == want["bytes"]
    assert got["masked_flops"] == want["masked_flops"] > 0


# -------------------------------------------------------------- dry run
@pytest.mark.parametrize("arch,shape", [
    ("pna", "molecule"), ("two-tower-retrieval", "serve_p99"),
    ("d3gnn-sage", "stream_tick"), ("mistral-nemo-12b", "decode_32k")])
def test_run_cell_on_meta(arch, shape):
    r = dryrun.run_cell(arch, shape, multi_pod=False, save=False)
    assert r["device"] == "meta" and r["n_devices"] == 256
    assert r["op_gflops"] > 0 and r["collective_gb"] is None
    assert r["t_collective_s"] is None and r["split"] == dryrun.SPLIT
    assert r["argument_gb"] > 0 and r["peak_memory_gb"] is None
    assert r["bottleneck"] in ("compute", "memory")
    if arch == "d3gnn-sage":       # kernels 1 and 2 on the tick's path
        assert {"segment_sum_rows", "mean_rows_gather"} <= set(r["kernels"])


def test_the_card_cells_d3gnn_tick_runs_on_live_records(monkeypatch):
    """`steady_tick` at small caps: its inputs have `input_specs`' shapes
    and dtypes; the synopses are the sums of the live in-edges' values
    last sent; one tick of both layers on them emits rows from layer 1,
    where the empty tick (every record invalid) emits none."""
    from repro_torch.configs import d3gnn_sage as d3
    for name, v in (("NODE_CAP", 32), ("EDGE_CAP", 64), ("REPL_CAP", 16),
                    ("FEAT_CAP", 24), ("EDGE_TICK_CAP", 16), ("D_IN", 8),
                    ("D_HID", 8)):
        monkeypatch.setattr(d3, name, v)
    model = d3.build_reduced()
    specs = d3.input_specs(model, "stream_tick", n_parts=4)
    live = d3.steady_tick(model, specs, "cpu",
                          torch.Generator().manual_seed(0))
    for group, fields in specs.items():
        if group == "now":
            continue
        for k, (shp, dt) in fields.items():
            t = live[group][k]
            assert tuple(t.shape) == tuple(shp) and t.dtype == dt, (group, k)
    topo, st = live["topo"], live["state0"]
    P, N, d = st["x_sent"].shape
    want = torch.zeros(P * N, d)
    ok = topo["e_valid"]
    src = (torch.arange(P)[:, None] * N + topo["e_src_slot"])[ok]
    dst = (topo["e_dst_mpart"] * N + topo["e_dst_mslot"])[ok]
    want.index_add_(0, dst, st["x_sent"].reshape(P * N, d)[src])
    torch.testing.assert_close(st["agg"].reshape(P * N, d), want)
    step = d3.step(model, "stream_tick")
    args = [live[k] for k in ("topo", "state0", "state1", "inbox", "eb",
                              "rb", "now")]
    assert int(step(*args)[2].valid.sum()) > 0
    empty = {g: {k: torch.zeros_like(t) for k, t in f.items()}
             if isinstance(f, dict) else f for g, f in live.items()}
    args = [empty[k] for k in ("topo", "state0", "state1", "inbox", "eb",
                               "rb", "now")]
    assert int(step(*args)[2].valid.sum()) == 0


def test_run_cell_fails_a_shape_that_does_not_fit(monkeypatch):
    from dataclasses import replace
    spec = get_arch("pna")
    bad = dict(spec.input_specs(None, "molecule"))
    bad["x"] = ((bad["x"][0][0], 15), bad["x"][1])     # d_feat 16 -> 15
    monkeypatch.setattr(dryrun, "get_arch", lambda a: replace(
        spec, input_specs=lambda model, s: bad))
    with pytest.raises(RuntimeError):
        dryrun.run_cell("pna", "molecule", multi_pod=False, save=False)


def test_dryrun_cli_and_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(report, "RESULTS_DIR", tmp_path)
    dryrun.main(["--arch", "pna", "--shape", "molecule"])
    out = capsys.readouterr().out
    assert "[ok] pna x molecule x single: compile=" in out
    assert "[ok] pna x molecule x multi: compile=" in out
    assert (tmp_path / "pna__molecule__multi.json").exists()
    rows = report.build_rows("single")
    assert [(r["arch"], r["shape"]) for r in rows] == [("pna", "molecule")]
    assert rows[0]["useful_ratio"] > 0
    report.main(["--mesh", "single"])
    assert "| pna | molecule |" in capsys.readouterr().out


# ------------------------------------------------------- roofline text
ROWS = [
    dict(arch="a", shape="s", mesh="single", n_devices=256, compile_s=1.5,
         peak_memory_gb=3.25, gflops=12.5, bytes_gb=0.75,
         collective_gb=0.125, t_compute_s=0.01, t_memory_s=0.02,
         t_collective_s=0.001, bottleneck="memory",
         collective_counts={"all-gather": 3, "all-to-all": 2}),
    dict(arch="b", shape="t", mesh="multi", n_devices=512, compile_s=0.5,
         peak_memory_gb=1.0, gflops=1.0, bytes_gb=0.5, collective_gb=0.0,
         t_compute_s=0.3, t_memory_s=0.02, t_collective_s=0.0,
         bottleneck="compute", collective_counts={}),
]


def test_roofline_terms_equal_jax():
    """JAX's per-device branch, the one its dry run takes: one device's
    counts over one device's rates."""
    for fl, by, co, n in ((1e15, 3e12, 2e9, 256), (5e9, 1e12, 0.0, 512)):
        want = janalysis.roofline_terms(fl, by, co, n)
        got = analysis.roofline_terms(
            fl, by, co, peak_flops=janalysis.PEAK_FLOPS,
            hbm_bw=janalysis.HBM_BW, link_bw=janalysis.ICI_BW)
        assert got == want
    got = analysis.roofline_terms(1e12, 1e12, 5e9, peak_flops=1e12,
                                  hbm_bw=1e12)
    assert got["t_collective_s"] is None and got["bottleneck"] in (
        "compute", "memory")


def test_report_tables_equal_jax_text():
    """The same rows through both packages' tables: the port's text is
    JAX's with "HLO" read as "op" (its counts are the aten operations'),
    and its roofline fraction at the peak a row names is JAX's at JAX's
    constant."""
    jrows = [dict(r, hlo_gflops=r["gflops"], hlo_bytes_gb=r["bytes_gb"],
                  useful_ratio=0.5, roofline_fraction=0.25) for r in ROWS]
    prows = [dict(r, op_gflops=r["gflops"], op_bytes_gb=r["bytes_gb"],
                  useful_ratio=0.5, roofline_fraction=0.25,
                  peak_flops=janalysis.PEAK_FLOPS) for r in ROWS]
    assert report.markdown_table(prows) == jreport.markdown_table(
        jrows).replace("HLO", "op")
    assert report.dryrun_table(prows) == jreport.dryrun_table(
        jrows).replace("HLO", "op")
    for jr, pr in zip(jrows, prows):
        assert report.roofline_fraction(pr, 3e15) == \
            jreport.roofline_fraction(jr, 3e15)


# ------------------------------------------------- counting mesh, perf
N_NODES, N_EDGES, D_FEAT, N_CLS, S = 64, 300, 8, 4, 2


def _loc_case():
    from repro_torch.dist.gnn_locality import build_plan
    rng = np.random.default_rng(0)
    senders = rng.integers(0, N_NODES, N_EDGES)
    receivers = rng.integers(0, N_NODES, N_EDGES)
    x = rng.normal(size=(N_NODES, D_FEAT)).astype(np.float32)
    labels = rng.integers(0, N_CLS, N_NODES)
    return build_plan(senders, receivers, N_NODES, S), x, labels


def _loc_step(mesh, plan, x, labels, device):
    from repro_torch.dist.gnn_locality import (make_locality_train_step,
                                               rank_batch)
    from repro_torch.graph.pna import PNA
    from repro_torch.optim import adam
    batch = rank_batch(plan, max(mesh.rank, 0), x, labels,
                       np.ones(len(labels), bool))
    batch = {k: torch.empty_like(v, device=device) if device == META
             else v for k, v in batch.items()}
    model = PNA(D_FEAT, 16, 2, N_CLS, 1.5, device=device)
    params = param_tree(model)
    step = make_locality_train_step(model, N_CLS, mesh, local_update=True)
    mesh.reset_calls()
    step(params, adam().init(params), batch)
    return {k: (c[0], c[2]) for k, c in mesh.calls.items()}


def _loc_rank(mesh, plan, x, labels):
    return _loc_step(mesh, plan, x, labels, torch.device("cpu"))


def test_counting_mesh_counts_as_a_gloo_mesh():
    plan, x, labels = _loc_case()
    real = spawn_stream_mesh(S, _loc_rank, backend="gloo", device="cpu",
                             args=(plan, x, labels), timeout=300)
    dry = _loc_step(CountingMesh(S), plan, x, labels, META)
    assert dry == real[0] == real[1]
    assert {"halo", "halo backward", "grad_all_reduce"} <= set(dry)


@pytest.mark.parametrize("name", variants.VARIANTS)
def test_every_variant_builds_and_traces_on_meta(name):
    mesh = ProductionMesh(("data", "model"), (2, 2))
    build = getattr(variants, name)
    lm = name.startswith(("mistral", "moonshot"))
    built = build(mesh, 1, 1) if lm else build(mesh)      # 1 layer group
    r = analysis.analyze_step(built["step"], *built["args"],
                              mesh=built["mesh"])
    assert r["op_flops"] > 0 and r["op_bytes"] > 0
    assert built["split"] in ("rank", "ideal")
    if built["mesh"] is not None:
        assert r["collective_gb"] > 0
    if name == "moonshot_train_ep":
        assert set(r["collective_bytes_by_kind"]) == {
            "all_to_all", "all_to_all backward"}


def test_run_variant_writes_its_counts(tmp_path, monkeypatch):
    monkeypatch.setattr(perf_run, "RESULTS_DIR", tmp_path)
    r = perf_run.run_variant("pna_ogb_locality_tight")
    assert (tmp_path / "pna_ogb_locality_tight__single.json").exists()
    assert r["split"] == "rank" and r["n_devices"] == 256
    assert set(r["collective_bytes_by_kind"]) == {
        "halo", "halo backward", "all_reduce", "grad_all_reduce"}
    assert "[ok] pna_ogb_locality_tight x single" in perf_run.ok_line(r)


# ------------------------------------------ reference faults (pinned)
def test_r19_nequip_model_flops_counts_the_radial_product_twice():
    """ROADMAP R19, kept in both packages for parity: the per-edge term
    `2.0 * 64 * n_paths * mult / n_paths` (repro/roofline/
    model_flops.py:74) cancels n_paths, and times the n_paths outside
    it is the radial MLP's output product (64 -> n_paths * mult a
    edge), which `radial` counts already: each nequip cell counts that
    product twice."""
    from repro_torch.configs.gnn_common import GNN_SHAPES, pad512
    for shape in GNN_SHAPES:
        model = get_arch("nequip").build(shape, device=META)
        E = pad512(GNN_SHAPES[shape].dims["n_edges"])
        n_paths, mult = 15, model.mult
        in_radial = 2.0 * E * 64 * n_paths * mult
        in_per_edge = E * n_paths * (2.0 * 64 * n_paths * mult / n_paths)
        assert in_per_edge == in_radial
        got = model_flops("nequip", shape)
        assert got == jax_model_flops("nequip", shape)
        once = got - 3.0 * model.n_layers * in_per_edge
        assert 0 < once < got


def test_r20_the_decode_variant_builds_no_scatter_cache_update():
    """ROADMAP R20: the comment above the reference's
    mistral_decode_bf16 (repro/perf/variants.py:96-100) names a scatter
    cache update as a hypothesis; the builder returns the config's own
    decode step, and so does the port's."""
    from repro.perf import variants as jax_variants
    mesh = make_production_mesh()
    built = jax_variants.mistral_decode_bf16(abstract(mesh))
    assert built["step"].__qualname__ == "lm_step.<locals>.decode_step"
    ours = variants.mistral_decode_bf16(mesh, 1)
    assert ours["step"].__qualname__ == "lm_step.<locals>.decode_step"
