"""Shared harness of the example tests (`test_torch_examples_*.py`); it
holds no test.

`jax_main` runs one of the JAX package's examples (`examples/<name>.py`,
imported from its path) with its stdout captured, and spies on the
training calls whose values the example prints rounded: each
`TrainingCoordinator.train`'s losses and each `TrainSession.train_stats`
dict. `spawn_jax_main` runs it in a subprocess with a forced n-device CPU
backend, for the multi-device forms (a JAX backend's device count is fixed
when it starts). Run as a script, this file is that subprocess.

`assert_same_printout` holds the port's printed lines to JAX's: the same
text between the numbers, every integer equal, every float within one
unit of its printed precision. Walls, rates and latencies are taken out
first (`strip_walls`), and so is the oracle's error, which both examples
assert below 1e-4 themselves.
"""
import contextlib
import importlib.util
import io
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
WALLS = [
    (re.compile(r" in [\d.]+s \([\d.]+ edges/s ingested\)"), ""),
    (re.compile(r"query latency ms: p50=\S+ p95=\S+ p99=\S+; "), ""),
    (re.compile(r"max \|err\| = \S+"), "max |err|"),
]
LOSS_RTOL = 1e-4


def strip_walls(line: str) -> str:
    for pat, rep in WALLS:
        line = pat.sub(rep, line)
    return line


def _unit(tok: str) -> float:
    """One unit in the last printed place of a float token."""
    mant, _, exp = tok.partition("e")
    places = len(mant.partition(".")[2])
    return 10.0 ** (-places + (int(exp) if exp else 0))


def assert_same_printout(port_lines, jax_lines):
    port = [strip_walls(x) for x in port_lines]
    ref = [strip_walls(x) for x in jax_lines]
    assert len(port) == len(ref), (port, ref)
    for a, b in zip(port, ref):
        assert NUM.split(a) == NUM.split(b), (a, b)
        for x, y in zip(NUM.findall(a), NUM.findall(b)):
            if not any(c in y for c in ".e"):
                assert x == y, (a, b)
            else:
                assert abs(float(x) - float(y)) <= _unit(y) * 1.0001 \
                    + LOSS_RTOL * abs(float(y)), (a, b)


def assert_losses_close(port, ref):
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=LOSS_RTOL, atol=1e-6)


@pytest.fixture
def one_torch_thread():
    """The port's runs on one intra-op thread: the suite's workers share
    the box's cores, and a thread pool as wide as the box in each of them
    oversubscribes it many times over (the examples' tensors are small)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def load_jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_main(name: str, argv=()):
    """(printed lines, spied values) of `examples/<name>.py`'s main run
    with `argv`, in this process's cwd."""
    from repro.core.training import TrainingCoordinator
    from repro.serve.train_session import TrainSession
    spied = {"train": [], "train_stats": []}
    train, stats = TrainingCoordinator.train, TrainSession.train_stats

    def spy_train(self, *a, **kw):
        res = train(self, *a, **kw)
        spied["train"].append([float(x) for x in res.losses])
        return res

    def spy_stats(self):
        out = stats(self)
        spied["train_stats"].append({k: float(v) for k, v in out.items()})
        return out

    mod = load_jax_example(name)
    buf, argv0 = io.StringIO(), sys.argv
    TrainingCoordinator.train, TrainSession.train_stats = spy_train, \
        spy_stats
    sys.argv = [mod.__file__, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        TrainingCoordinator.train, TrainSession.train_stats = train, stats
        sys.argv = argv0
    return buf.getvalue().splitlines(), spied


def spawn_jax_main(n_devices: int, name: str, argv, out: Path, cwd: Path):
    """Start `jax_main(name, argv)` in a subprocess on a forced n-device
    CPU backend, its result pickled to `out`; returns the Popen."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}"
                         " --xla_backend_optimization_level=0"
                         " --xla_cpu_multi_thread_eigen=false")
    cwd.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), name, str(out),
         *argv], env=env, cwd=str(cwd), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def join_jax_main(proc, out: Path, timeout: float = 600):
    try:
        log, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def sage_params(dims, seed=0, n_classes=0):
    """JAX GraphSAGE(dims[, n_classes]).init(key(seed)) as the port's
    `state_dict`."""
    import jax

    from repro.graph.sage import GraphSAGE as JaxSAGE
    from repro_torch.convert import params_from_numpy
    tree = jax.tree.map(np.asarray, JaxSAGE(dims, n_classes=n_classes).init(
        jax.random.key(seed)))
    return params_from_numpy(tree)


def linear_params(d_in, d_out, seed):
    """JAX Linear(d_in, d_out).init(key(seed)) as a {"w", "b"} tensor
    dict (the port's Linear `state_dict`)."""
    import jax
    import torch

    from repro.nn.layers import Linear as JaxLinear
    tree = JaxLinear(d_in, d_out).init(jax.random.key(seed))
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


if __name__ == "__main__":
    _name, _out, *_argv = sys.argv[1:]
    _res = jax_main(_name, _argv)
    with open(_out, "wb") as _f:
        pickle.dump(_res, _f)
