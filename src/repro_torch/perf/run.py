"""Perf-variant runner: trace one step variant on the `meta` device and
record its counts next to the baseline cell's.

Counterpart of `repro/perf/run.py` (which lowers and compiles a variant
for the TPU mesh). A variant (`perf/variants.py`) runs once under
`roofline/op_analyzer.OpCounter`; an LM variant at probes of 1 and 2
layer groups and microbatches, extrapolated to its own
(`roofline/analysis.extrapolate`). The JSON holds one rank's dot FLOPs,
bytes and collective bytes by kind (the CountingMesh's kinds, as a
StreamMesh names them) and the roofline terms at one H100's peak (no
collective term: no link rate is assumed). Written to
results/perf_torch/<variant>__<mesh>.json.

    PYTHONPATH=src python -m repro_torch.perf.run --variant pna_ogb_locality
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import (HBM_BW, analyze_step, counts_of,
                                           extrapolate, peak_flops,
                                           roofline_terms)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "perf_torch"


def _traced(build, mesh, groups=None, micro=None) -> dict:
    built = build(mesh) if groups is None else build(mesh, groups, micro)
    r = analyze_step(built["step"], *built["args"], mesh=built["mesh"])
    return counts_of(r)


def run_variant(name: str, multi_pod: bool = False, save: bool = True,
                device="meta") -> dict:
    from repro_torch.perf import variants
    if torch.device(device).type != "meta":
        raise ValueError("the variants run on the meta device at the "
                         "production sizes")
    build = getattr(variants, name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    built = build(mesh)
    repeat = built.get("repeat")
    if repeat is None:
        counts, probes = _traced(build, mesh), None
    else:
        counts, probes = extrapolate(
            lambda g, k: _traced(build, mesh, g, k),
            repeat["layer_groups"], repeat["microbatches"])
    n = mesh.size if built["split"] == "ideal" else 1
    flops, nbytes = counts["flops"] / n, counts["bytes"] / n
    coll = {k: v[1] for k, v in counts["collectives"].items()}
    result = {"variant": name, "mesh": "multi" if multi_pod else "single",
              "n_devices": int(mesh.size), "split": built["split"],
              "trace_s": time.perf_counter() - t0,
              "baseline": built["baseline"], "extrapolated": probes,
              "op_gflops": flops / 1e9, "op_bytes_gb": nbytes / 2 ** 30,
              "op_masked_gflops": counts["masked_flops"] / n / 1e9,
              "collective_gb": sum(coll.values()) / 2 ** 30,
              "collective_bytes_by_kind": coll,
              "collective_counts": {k: v[0] for k, v in
                                    counts["collectives"].items()},
              "kernels": counts["kernels"],
              "peak_flops": peak_flops(built["dtype"])}
    result.update(roofline_terms(flops, nbytes, None,
                                 peak_flops=result["peak_flops"],
                                 hbm_bw=HBM_BW))
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out = RESULTS_DIR / f"{name}__{result['mesh']}.json"
        out.write_text(json.dumps(result, indent=1))
    return result


def ok_line(r: dict) -> str:
    kinds = ", ".join(f"{k} {b / 2 ** 30:.3f}" for k, b in
                      r["collective_bytes_by_kind"].items()) or "none"
    return (f"[ok] {r['variant']} x {r['mesh']}: trace={r['trace_s']:.2f}s "
            f"flops={r['op_gflops']:.3f}G mem={r['op_bytes_gb']:.3f}GB "
            f"coll={r['collective_gb']:.3f}GB ({kinds}) "
            f"t=({r['t_compute_s']},{r['t_memory_s']}) "
            f"bound={r['bottleneck']} per {r['split']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", required=True)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for m in meshes:
        print(ok_line(run_variant(args.variant, multi_pod=m)))


if __name__ == "__main__":
    main()
