"""Small copies of the benchmark's cells for CPU tests: the published
widths (602, 64, 64), 8 parts and small caps, the real limits."""
from __future__ import annotations

import copy
import json
import time

import torch

from portbench import harness

SIZES = dict(n_vertices=3000, n_parts=8, node_cap=1024, edge_cap=4096,
             repl_cap=1024, feat_cap=512, edge_tick_cap=256)
MIX = {"edges": {"alpha": 1.5, "tick_edges": 128}, "super_ticks": 4,
       "warm_super_ticks": 1}
SERVE_MIX = dict(MIX, warm_super_ticks=2,
                 queries={"rate_per_s": 100, "link_every": 8},
                 check={"consistent_embed": 32, "consistent_link": 32})
TRAIN_MIX = dict(MIX, labels={"per_tick": 32},
                 check={"train_steps": 3, "labels_per_step": 32})
CELLS = {"sage.ingest": "small.serve", "sage-train.ingest": "small.train"}


def small_bench(tmp_path) -> dict:
    """BENCHMARK.json with each cell swapped for its small copy (configs
    and mixes written under tmp_path)."""
    bench = copy.deepcopy(harness.load_bench())
    cells = {w["name"]: w for w in bench["workloads"]}
    entries = {c["name"]: c for c in bench["configs"]}
    out = []
    for name, small in CELLS.items():
        cell = cells[name]
        cfg = json.loads((harness.ROOT / entries[cell["config"]]["file"])
                         .read_text())
        cfg.update(SIZES)
        if "query_cap" in cfg:
            cfg["query_tick_cap"] = 64
        if "train" in cfg:
            cfg["train"].update(train_cap=64, batch_threshold=32)
        mix = SERVE_MIX if "query_cap" in cfg else TRAIN_MIX
        (tmp_path / f"{small}.json").write_text(json.dumps(cfg))
        (tmp_path / f"{small}.mix.json").write_text(json.dumps(mix))
        bench["configs"].append({"name": small,
                                 "file": str(tmp_path / f"{small}.json")})
        out.append(dict(cell, name=small, config=small,
                        traffic=str(tmp_path / f"{small}.mix")))
    bench["workloads"] = out
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[w] for w in m["workloads"]]
    return bench


def run(bench, cell, seed=20240917, seconds=1.0, trace=False, **kw):
    return harness.run(cell, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), bench=bench, **kw)
