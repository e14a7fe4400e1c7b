"""One run of one cell: everything a cell needs is found by name.

  BENCHMARK.json          the cells, their configurations and metrics;
  configs/<file>          a configuration: its system, its reference, its
                          sizes and the limits of its comparison;
  systems/<system>.py     how a configuration's system is built, warmed,
                          driven for the window and read back (`Run`);
  traffic/<traffic>.json  a mix, read by traffic/generator.py;
  reference/<name>.py     the plain reference a configuration names;
  metrics/<metric>.py     one reader per metric: `read(ctx)` returns the
                          number, or None where the run has nothing to read;
  yardstick/kernels/<entry>.py  a kernel entry of the program: what a
                          traced run logs of its launches, their bytes.

A later cell, mix, configuration, model, kernel or metric is new files
and new entries of BENCHMARK.json; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench.traffic.generator import load_mix
from portbench.yardstick import kernel_bytes, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_bench(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def find_cell(bench: dict, workload: str):
    """(cell, configuration file's dict, mix)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    return cell, cfg, load_mix(cell["traffic"], ROOT)


def metrics_of(bench: dict, cell: dict, trace_on: bool) -> list:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (trace 1):
    those that list the cell under `workloads`, or list none."""
    group = bench["per_layer" if trace_on else "end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def _sync_count(caught) -> int:
    """Synchronizing CUDA calls made by the program (not by this
    package)."""
    return sum(1 for w in caught
               if "synchronizing CUDA operation" in str(w.message)
               and "portbench" not in Path(w.filename).parts)


def run(workload: str, seed: int, seconds: float, trace_on: bool,
        device: torch.device, t_start: float, control: str | None = None,
        bench: dict | None = None) -> dict:
    """Set up, measure and check one cell; returns the result line's dict
    (the checks under "checks", last)."""
    bench = bench or load_bench()
    cell, cfg, mix = find_cell(bench, workload)
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    if cuda:
        torch.zeros(1, device=device)       # the allocator's first touch
        torch.cuda.reset_peak_memory_stats(device)
    if trace_on:
        # every kernel entry's program function, before set-up: one the
        # program no longer has raises here
        entries = kernel_bytes.entries()
        owners = {name: kernel_bytes.target(e) for name, e in entries.items()}
    r = system.Run(cfg, mix, seed, device, control=control)
    r.setup()
    setup_s = time.perf_counter() - t_start
    ctx = SimpleNamespace(cell=cell, cfg=cfg, mix=mix, setup_s=setup_s,
                          trace=None, kernels={}, syncs=None,
                          train_sites=None)
    if trace_on:
        klog = trace.KernelLog(entries)
        prof = trace.Profiler(1, 2, device)

        class Tracer:
            def before(self, i):
                prof.before(i)
                klog.on = prof.prof is not None

            def after(self, i):
                klog.on = False
                prof.after(i)

        with trace.Patches() as p, warnings.catch_warnings(
                record=True) as caught:
            for owner, attr, name in r.span_targets():
                p.wrap(owner, attr, trace.span(name))
            for name, owner in owners.items():
                p.wrap(owner, entries[name].TARGET[1], klog.wrap(name))
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                ctx.counts = r.window(seconds, Tracer())
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
                prof.close()
        r.after_window(ctx.counts)
        ctx.syncs = _sync_count(caught)
        ctx.trace = prof.summary
        ctx.kernels = klog.total_bytes()
        ctx.train_sites = r.train_site_profile()
    else:
        ctx.counts = r.window(seconds)
        r.after_window(ctx.counts)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx.peak_bytes = peak
    metrics = {}
    for m in metrics_of(bench, cell, trace_on):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    r.collect()
    rows = r.check(cfg["limits"], ref)
    counts = ctx.counts
    if "queries_due" in counts:
        attempted = counts["queries_due"]
        failed = counts["queries_due"] - counts["ok"]
    else:
        attempted, failed = counts["events"], 0
    result = {
        "correct": all(v <= lim for _, v, lim in rows),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}}
    if trace_on and ctx.trace:
        result["device"].update(busy_s=ctx.trace["busy_s"],
                                window_s=ctx.trace["window_s"])
        result["breakdown"] = {k: ctx.trace[k]
                               for k in ("device_ops", "idle_gaps")}
    result["counts"] = {k: v for k, v in counts.items() if k != "latency_s"}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result


def check_lines(result: dict) -> list:
    return [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
            for n, c in result["checks"].items()]

