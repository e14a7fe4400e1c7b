"""Nothing the benchmark runs loads JAX or the JAX package: checked in a
fresh interpreter by whole top-level module names."""
import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.cells import CELLS

CHECK = """
import json, runpy, sys
sys.argv = ["portbench/run.py", "--help"]
try:
    runpy.run_path("portbench/run.py", run_name="__main__")
except SystemExit:
    pass
{body}
print(json.dumps(sorted({{n for n in sys.modules
                          if n.split(".")[0] in {forbidden!r}}})))
"""

RUN_CELL = """
import pathlib, tempfile
sys.path[:0] = ["src", "."]
from portbench.tests.cells import run, small_bench
run(small_bench(pathlib.Path(tempfile.mkdtemp())), {cell!r}, seconds=0.5,
    trace=True)
"""


def _loaded(body=""):
    code = CHECK.format(body=body, forbidden=harness.FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_help_loads_no_jax():
    assert _loaded() == []


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_a_traced_small_cell_loads_no_jax(cell):
    assert _loaded(RUN_CELL.format(cell=cell)) == []
