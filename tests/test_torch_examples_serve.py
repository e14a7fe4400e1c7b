"""`repro_torch.examples.streaming_serve` against
`examples/streaming_serve.py` on one device, on the CPU: the JAX example's
GraphSAGE parameters converted, the same numpy stream and query mix, and
the printed lines agree (`assert_same_printout`): the checkpoint's tick,
emitted and answered counts, the restored step, emitted, reduce_msgs,
cross_part, queries resolved / ok / device-answered / dropped / shed,
degraded_ticks, the staleness percentiles, the embedding table's size and
read_nodes'. --edges is cut from 4000 to 1200. Each side checkpoints into
a directory of its own.

The JAX example restores its checkpoint directory's LATEST step, so a
directory that holds an earlier run's later cut gets that run's state
(ROADMAP R22); the port restores the step it saved, and both behaviours
are pinned here.
"""
import re

import pytest

from repro_torch.examples import streaming_serve as serve
from test_torch_examples_harness import (assert_same_printout, jax_main,
                                         one_torch_thread, sage_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGV = ["--edges", "1200"]


def _steps(lines):
    """(checkpointed tick, restored step) of a run's printout."""
    text = "\n".join(lines)
    return (int(re.search(r"checkpointed at tick (\d+)", text)[1]),
            int(re.search(r"recovered checkpoint step=(\d+)", text)[1]))


def test_serve_on_one_device_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    lines, _ = jax_main("streaming_serve", ARGV)
    say = serve.run(serve.parse_args(
        ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")]),
        params=sage_params((16, 32, 32)))
    assert say.lines[-1] == "serve driver OK"
    assert "single-shard relay" in say.lines[1]
    assert _steps(lines) == (8, 8)
    assert_same_printout(say.lines, lines)


def test_serve_restores_its_own_cut_where_jax_takes_the_latest(
        tmp_path, monkeypatch):
    """R22: after a longer run left its later cut (tick 16) in the
    directory, a 1200-edge run cuts at tick 8; the port restores 8, the
    JAX example the directory's latest, 16 (the format is shared, so it
    reads the port's checkpoint)."""
    monkeypatch.chdir(tmp_path)
    params = sage_params((16, 32, 32))
    ckpt = ["--device", "cpu", "--ckpt-dir", "results/serve_ckpt"]
    longer = serve.run(serve.parse_args(["--edges", "2400"] + ckpt),
                       params=params)
    assert _steps(longer.lines) == (16, 16)
    port = serve.run(serve.parse_args(ARGV + ckpt), params=params)
    assert _steps(port.lines) == (8, 8)
    assert port.lines[-1] == "serve driver OK"
    jax_lines, _ = jax_main("streaming_serve", ARGV)
    assert _steps(jax_lines) == (8, 16)
