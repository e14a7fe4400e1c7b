"""Small copies of the benchmark's cells for CPU tests: the published
widths (602, 64, 64), a few parts and small caps, the real limits.

A cell's copy is `small/<cell>.json`: its small name, the overrides of
its configuration's sizes (nested groups merged key by key) and its small
mix. A cell without one is left out of `small_bench` and fails
`test_every_cell_has_a_small_copy`.
"""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from portbench import harness

SMALL = Path(__file__).resolve().parent / "small"


def copies(root: Path = SMALL) -> dict:
    """{cell: its small copy} of every file under `root`."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted(root.glob("*.json"))}


CELLS = {cell: c["name"] for cell, c in copies().items()}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def small_bench(tmp_path, bench: dict | None = None,
                root: Path = SMALL) -> dict:
    """BENCHMARK.json (or `bench`) with each cell that has a small copy
    swapped for it (configs and mixes written under tmp_path); each
    metric's `workloads` names the copies of the cells it lists."""
    bench = copy.deepcopy(bench or harness.load_bench())
    small = copies(root)
    entries = {c["name"]: c for c in bench["configs"]}
    out, names = [], {}
    for cell in bench["workloads"]:
        if cell["name"] not in small:
            continue
        c = small[cell["name"]]
        name = names[cell["name"]] = c["name"]
        cfg = json.loads((harness.ROOT / entries[cell["config"]]["file"])
                         .read_text())
        (tmp_path / f"{name}.json").write_text(json.dumps(
            _merge(cfg, c["config"])))
        (tmp_path / f"{name}.mix.json").write_text(json.dumps(c["mix"]))
        bench["configs"].append({"name": name,
                                 "file": str(tmp_path / f"{name}.json")})
        out.append(dict(cell, name=name, config=name,
                        traffic=str(tmp_path / f"{name}.mix")))
    bench["workloads"] = out
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[w] for w in m["workloads"] if w in names]
    return bench


def mix_of(cell: str) -> dict:
    """The small mix of `cell`."""
    return copies()[cell]["mix"]


def run(bench, cell, seed=20240917, seconds=1.0, trace=False, **kw):
    return harness.run(cell, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), bench=bench, **kw)
