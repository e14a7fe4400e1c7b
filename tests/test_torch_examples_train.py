"""`repro_torch.examples.train_streaming_gnn` against
`examples/train_streaming_gnn.py`, on the CPU, in both modes, with the JAX
example's parameters converted (`repro_torch.convert`) and the same numpy
stream: the printed lines agree (steps, backlog, votes, flush_ticks;
`assert_same_printout`) and every loss and gradient norm behind them is
within rtol 1e-4 of JAX's. The runs are cut to two phases of three epochs
(the defaults are three of ten); the examples' own asserts, that the
loss falls and the steps rise, hold in both.
"""
import pytest

from repro_torch.examples import train_streaming_gnn as tsg
from test_torch_examples_harness import (assert_losses_close,
                                         assert_same_printout, jax_main,
                                         linear_params, one_torch_thread,
                                         sage_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGV = ["--phases", "2", "--epochs", "3"]


def test_online_driver_matches_jax():
    lines, spied = jax_main("train_streaming_gnn", ARGV)
    say = tsg.run(tsg.parse_args(ARGV + ["--device", "cpu"]),
                  params=sage_params((16, 32, 32), n_classes=5))
    assert say.lines[-1] == "online continual-training driver OK"
    assert_same_printout(say.lines, lines)
    stats = spied["train_stats"]            # (first, last) a phase
    assert len(stats) == 2 * len(say.values["loss"])
    assert_losses_close(say.values["loss"],
                        [(a["loss"], b["loss"])
                         for a, b in zip(stats[::2], stats[1::2])])
    assert_losses_close(say.values["grad_norm"],
                        [b["grad_norm"] for b in stats[1::2]])


def test_halt_flush_driver_matches_jax():
    argv = ARGV + ["--mode", "halt-flush"]
    lines, spied = jax_main("train_streaming_gnn", argv)
    say = tsg.run(tsg.parse_args(argv + ["--device", "cpu"]),
                  params=sage_params((16, 32, 32)),
                  head_params=linear_params(32, 5, 1))
    assert say.lines[-1] == "halt-flush continual-training driver OK"
    assert_same_printout(say.lines, lines)
    assert_losses_close(say.values["losses"], spied["train"])
