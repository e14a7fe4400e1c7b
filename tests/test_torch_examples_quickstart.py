"""`repro_torch.examples.quickstart` against `examples/quickstart.py`, on
the CPU: the JAX example's parameters (GraphSAGE from key 0, the head from
key 1) go through `repro_torch.convert` into the port's, both consume the
same numpy stream, and the printed lines agree (`assert_same_printout`:
ticks, emitted, reduce_msgs, cross_part, replication, materialized, votes
and the stage grid's bubble fraction and stage_idle); the training cycle's
losses within rtol 1e-4 of JAX's. At stage 1 both run on one device; at
stage 2 JAX runs on a forced 2-device CPU backend (a subprocess) and the
port on 2 gloo ranks.
"""
import pytest

from repro_torch.examples import quickstart
from test_torch_examples_harness import (assert_losses_close,
                                         assert_same_printout, jax_main,
                                         join_jax_main, linear_params,
                                         one_torch_thread, sage_params,
                                         spawn_jax_main)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _params(stage):
    d_in = 16 if stage == 1 else 32
    return sage_params((d_in, 32, 32)), linear_params(32, 4, 1)


def test_quickstart_stage1_matches_jax():
    lines, spied = jax_main("quickstart")
    params, head = _params(1)
    say = quickstart.run(quickstart.parse_args(["--device", "cpu"]),
                         params=params, head_params=head)
    assert say.lines[-1] == "quickstart OK"
    assert_same_printout(say.lines, lines)
    assert_losses_close(say.values["losses"], spied["train"])


def test_quickstart_stage2_on_two_ranks_matches_jax(tmp_path):
    proc = spawn_jax_main(2, "quickstart", ["--stage", "2"],
                          tmp_path / "jax.pkl", tmp_path / "jax")
    try:
        params, head = _params(2)
        say = quickstart.launch(
            quickstart.run, quickstart.parse_args(
                ["--stage", "2", "--device", "cpu"]), params, head)
    finally:
        lines, spied = join_jax_main(proc, tmp_path / "jax.pkl")
    assert lines[0] == "mesh: {'stage': 2, 'data': 1}"
    assert any(x.startswith("pipeline bubble fraction") for x in lines)
    assert say.lines[-1] == "quickstart OK"
    assert_same_printout(say.lines, lines)
    assert_losses_close(say.values["losses"], spied["train"])


def test_quickstart_cli_refuses_a_grid_its_ranks_cannot_hold():
    with pytest.raises(ValueError, match="multiple of the stage count"):
        quickstart.main(["--stage", "2", "--ranks", "3", "--device", "cpu"])
