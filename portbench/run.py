"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's GPUs. The last
line of standard output is the result (JSON); the last lines of standard
error list every number the comparison read, each beside its limit.
`--control tf32` puts the reference, computed in TF32, in the program's
place, and `--control half_batch` (training cells) the reference trained
on half of each step's labels: such a run must come out not correct (the
benchmark's own runs never pass either).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / "build" / "portbench"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "half_batch"), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    bench = harness.load_bench()
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0), T_START,
                         control=args.control, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or its package: {bad}",
              file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["card"] = card_line()
    result["checks"] = checks
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
