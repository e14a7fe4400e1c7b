"""A new cell, kernel entry or model on the engine is new files only: the
harness and its tests find each by name. The moved pieces keep what they
gave: the kernel byte formulas at PERF.md's kernel-table shapes and the
SAGE weights, bit for bit."""
import copy
import hashlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import compare, harness, models
from portbench.tests.cells import SMALL, copies, run, small_bench
from portbench.tests.test_portbench_harness import assert_names_resolve
from portbench.traffic.generator import load_mix
from portbench.yardstick import kernel_bytes, trace

TOY_KERNEL = '''
import torch
TARGET = ("portbench.yardstick.peaks", "nothing")
KERNELS = ("toy_kernel",)


def log(args):
    x = args["x"]
    return dict(d=x.shape[1]), (x != 0).any(1).sum().reshape(1)


def launch_bytes(static, values):
    return values[0] * static["d"] * 4
'''


def test_kernel_table_bytes_are_pinned():
    """Row 1: the add form at n 262,144, d 602, 400,000 live records, with
    order, cnt, base and base_cnt; row 2: 8,192 picks, d 602, 5,650 live."""
    e = kernel_bytes.entries()
    assert e["deliver_rows"].launch_bytes(
        dict(mode="add", n=262144, d=602, order=True, cnt=True, base=True,
             base_cnt=True), [400000, 0]) == 2234941960
    assert e["mean_rows_gather"].launch_bytes(
        dict(k=8192, d=602), [5650]) == 33429840


def _with_toy_entry(tmp_path, monkeypatch, target):
    kernels = tmp_path / "kernels"
    kernels.mkdir()
    for p in kernel_bytes.HERE.glob("*.py"):
        (kernels / p.name).write_text(p.read_text())
    (kernels / "toy.py").write_text(TOY_KERNEL.replace(
        '("portbench.yardstick.peaks", "nothing")', repr(target)))
    monkeypatch.setattr(kernel_bytes, "HERE", kernels)
    return kernel_bytes.entries()


def test_a_kernel_entry_file_is_found_logged_and_priced(tmp_path,
                                                       monkeypatch):
    entries = _with_toy_entry(tmp_path, monkeypatch,
                              ("portbench.compare", "rel_max"))
    assert set(entries) == {"deliver_rows", "mean_rows_gather", "toy"}
    assert kernel_bytes.target(entries["toy"]) is compare
    log = trace.KernelLog(entries)
    fn = log.wrap("toy")(lambda x, y=1: x.sum() * y)
    x = torch.zeros(5, 3)
    x[[0, 3]] = 1.0
    fn(x)                       # off: nothing logged
    log.on = True
    assert float(fn(x, y=2)) == 12.0
    assert log.total_bytes() == {"toy": (2 * 3 * 4, 1)}
    ctx = SimpleNamespace(kernels=log.total_bytes(), trace={"by_name_s": {
        "toy_kernel<4>": 24 / 3.35e12, "other": 1.0}})
    assert kernel_bytes.roofline_share(ctx, "toy") == \
        pytest.approx(100.0)


def test_a_traced_run_refuses_an_entry_the_program_lacks(tmp_path,
                                                        monkeypatch):
    """An entry whose function the program no longer has (renamed or
    moved) stops a traced run before set-up, so its roofline is never
    left out unseen; an untraced run does not look."""
    _with_toy_entry(tmp_path, monkeypatch,
                    ("portbench.yardstick.peaks", "nothing"))
    bench = small_bench(tmp_path)
    with pytest.raises(LookupError, match="toy.py"):
        run(bench, "small.serve", trace=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree.numpy()


# sha256 of the leaves of draw_weights([602, 64, 64], n_classes, seed
# 3100000011) on the CPU, pinned: a change to the draw changes every
# sage cell's weights
SAGE_DIGESTS = {
    0: "c7c86549042b2fc5fc7185098a1f45c55800965f87f3ca6cd33a45a6f6adce76",
    41: "42e09d78798f560fa6cee2f1d1c6f7d4aeee5728b0b4f8471aaa0b16b20e9383"}


@pytest.mark.parametrize("n_classes", sorted(SAGE_DIGESTS))
def test_sage_weights_are_bit_identical(n_classes):
    w = models.load("sage").draw_weights([602, 64, 64], n_classes,
                                         3100000011, torch.device("cpu"))
    h = hashlib.sha256()
    for a in _leaves(w):
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    assert h.hexdigest() == SAGE_DIGESTS[n_classes]


def test_a_new_cell_needs_only_its_files(tmp_path):
    """A cell, a per-layer metric that lists it and the cell's small copy,
    each a new entry or file: the name checks hold, the small copy is
    found and remapped, and it runs correct on the CPU."""
    bench = copy.deepcopy(harness.load_bench())
    mix = load_mix("ingest_serve")
    mix["queries"]["rate_per_s"] = 600
    (tmp_path / "extra_serve.json").write_text(json.dumps(mix))
    bench["workloads"].append(dict(
        name="sage.extra", config="d3gnn-sage-reddit",
        traffic=str(tmp_path / "extra_serve"), chips=1,
        why="a cell added by a test"))
    for m in bench["per_layer"]:
        if m["name"] == "tick.device_ms":
            m["workloads"].append("sage.extra")
    assert_names_resolve(bench)
    small = tmp_path / "small"
    small.mkdir()
    for p in SMALL.glob("*.json"):
        (small / p.name).write_text(p.read_text())
    extra = dict(copies()["sage.ingest"], name="small.extra")
    (small / "sage.extra.json").write_text(json.dumps(extra))
    sb = small_bench(tmp_path, bench, small)
    assert "small.extra" in {w["name"] for w in sb["workloads"]}
    listed = {m["name"] for m in harness.metrics_of(
        sb, {"name": "small.extra"}, True)}
    assert "tick.device_ms" in listed
    assert run(sb, "small.extra")["correct"]


def test_a_new_model_module_needs_only_its_file(tmp_path, monkeypatch):
    """A model module named by the configuration is found by name and
    drives the run: here one that re-exports GraphSAGE's."""
    (tmp_path / "toy.py").write_text(
        "from portbench.models.sage import (build, dims, draw_weights,\n"
        "                                   vertex_flops)  # noqa: F401\n")
    monkeypatch.setattr(models, "HERE", tmp_path)
    bench = small_bench(tmp_path)
    entry = {c["name"]: c for c in bench["configs"]}["small.serve"]
    cfg = json.loads(open(entry["file"]).read())
    cfg["model_module"] = "toy"
    open(entry["file"], "w").write(json.dumps(cfg))
    res = run(bench, "small.serve")
    assert res["correct"], res["checks"]
