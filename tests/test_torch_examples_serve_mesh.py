"""`repro_torch.examples.streaming_serve --ranks 4` against
`examples/streaming_serve.py` on a forced 4-device CPU backend (a
subprocess), on the CPU: four gloo ranks serve, checkpoint, lose half the
shards and reshard 4 -> 2 live, pending qids carried along, and the
printed lines agree with JAX's (`assert_same_printout`), the reshard's
moved share included. --edges is cut from 4000 to 1200. The ranks the
drill removes return after the reshard and print nothing.
"""
import pytest

from repro_torch.examples import streaming_serve as serve
from test_torch_examples_harness import (assert_same_printout, join_jax_main,
                                         one_torch_thread, sage_params,
                                         spawn_jax_main)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGV = ["--edges", "1200"]


def test_serve_on_four_ranks_reshards_like_jax(tmp_path):
    proc = spawn_jax_main(4, "streaming_serve", ARGV, tmp_path / "jax.pkl",
                          tmp_path / "jax")
    try:
        say = serve.launch(serve.run, serve.parse_args(
            ARGV + ["--ranks", "4", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path / "port")]), sage_params((16, 32, 32)))
    finally:
        lines, _ = join_jax_main(proc, tmp_path / "jax.pkl")
    assert "live reshard 4->2 shards moved 75% of logical parts" \
        in lines[1]
    assert say.values["moved_fraction"] == [0.75]
    assert say.lines[-1] == "serve driver OK"
    assert_same_printout(say.lines, lines)
