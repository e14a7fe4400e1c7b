"""The dry run's roofline and cell tables from results/dryrun_torch/*.json.

Counterpart of `repro/roofline/report.py`, against one H100's peak for
each cell's compute dtype (`roofline/analysis.py`); the tables keep the
reference's columns, "op" where it reads "HLO" (the counts are the aten
operations' and the kernels', `roofline/op_analyzer.py`). A dry-run cell
is per device under an ideal split of its global counts; a collective
term is "—" where the port has no count for it.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh single]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import all_cells

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

IMPROVE_HINTS = {
    "compute": "reduce redundant flops (causal-block skipping, remat policy)",
    "memory": "fuse reads / larger tiles; decode: quantize or pack the KV "
              "cache, batch more requests per step",
    "collective": "locality-aware sharding (vertex-cut edge buckets), "
                  "int8-compressed DP all-reduce, all_to_all EP dispatch",
}


def load(arch, shape, mesh):
    p = RESULTS_DIR / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def _terms(r) -> list:
    return [t for t in (r["t_compute_s"], r["t_memory_s"],
                        r.get("t_collective_s")) if t is not None]


def roofline_fraction(r, model_fl):
    """Useful-compute time / dominant-term time (per device), the useful
    time at the peak the cell's JSON names."""
    n = r["n_devices"]
    t_useful = model_fl / n / r["peak_flops"]
    t_dom = max(_terms(r))
    return t_useful / t_dom if t_dom > 0 else float("nan")


def build_rows(mesh: str, include_extra: bool = True):
    from repro_torch.roofline.model_flops import model_flops
    rows = []
    for arch, shape in all_cells(include_extra=include_extra):
        r = load(arch, shape, mesh)
        if r is None:
            continue
        mf = model_flops(arch, shape)
        n = r["n_devices"]
        op_global = r["op_gflops"] * 1e9 * n
        ratio = mf / op_global if op_global and mf == mf else float("nan")
        frac = roofline_fraction(r, mf) if mf == mf else float("nan")
        rows.append({
            "arch": arch, "shape": shape, **r,
            "model_gflops_global": mf / 1e9 if mf == mf else None,
            "useful_ratio": ratio, "roofline_fraction": frac,
        })
    return rows


def _secs(t) -> str:
    return "—" if t is None else f"{t:.4f}"


def markdown_table(rows):
    hdr = ("| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | bound | "
           "peak GB/dev | MODEL/op flops | roofline frac | next lever |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for r in rows:
        ratio = (f"{r['useful_ratio']:.2f}" if r["useful_ratio"] == r[
            "useful_ratio"] else "—")
        frac = (f"{r['roofline_fraction']:.2f}"
                if r["roofline_fraction"] == r["roofline_fraction"] else "—")
        out.append(
            f"| {r['arch']} | {r['shape']} | {_secs(r['t_compute_s'])} | "
            f"{_secs(r['t_memory_s'])} | {_secs(r.get('t_collective_s'))} | "
            f"{r['bottleneck']} | {r.get('peak_memory_gb', '?')} | {ratio} | "
            f"{frac} | {IMPROVE_HINTS[r['bottleneck']]} |")
    return "\n".join(out)


def dryrun_table(rows):
    hdr = ("| arch | shape | mesh | compile (s) | peak GB/dev | op GFLOP/dev "
           "| op GB/dev | coll GB/dev | AG/AR/RS/A2A/CP |")
    sep = "|" + "---|" * 9
    out = [hdr, sep]
    for r in rows:
        c = r.get("collective_counts") or {}
        counts = "/".join(str(c.get(k, 0)) for k in
                          ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute"))
        compile_s = r.get("compile_s", r.get("trace_s",
                                             r.get("first_call_s")))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {compile_s} | "
            f"{r.get('peak_memory_gb', '?')} | {r['op_gflops']} | "
            f"{r.get('op_bytes_gb', '?')} | {r.get('collective_gb', '?')} | "
            f"{counts} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "card"])
    args = ap.parse_args(argv)
    rows = build_rows(args.mesh)
    print(f"### Roofline ({args.mesh}, per device, one H100's peak)\n")
    print(markdown_table(rows))
    print()
    both = build_rows("single") + build_rows("multi")
    print("### Dry-run (all cells x both meshes)\n")
    print(dryrun_table(both))


if __name__ == "__main__":
    main()
