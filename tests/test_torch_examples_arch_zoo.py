"""`repro_torch.examples.arch_zoo --arch all` against `examples/arch_zoo.py
--arch all`, on the CPU. The test draws what the JAX example draws (each
REDUCED model's init from key 0, the tokens, the erdos graph and the
two-tower ids from keys 1 and 2, DimeNet's triplets) and hands it to the
port through `repro_torch.convert`: the printed lines agree
(`assert_same_printout`: the decode logits', forward outputs' and
retrieval scores' shapes, finite=True, the losses to their printed
places), every loss within rtol 1e-4 of JAX's and every GNN output within
1e-4 of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_arch as jax_get_arch
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.examples import arch_zoo
from repro_torch.graph.graphs import Graph
from test_torch_examples_harness import (assert_losses_close,
                                         assert_same_printout, jax_main,
                                         one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_case(arch):
    """(the port's state_dict, the port's inputs, JAX's loss or output) of
    what the JAX example computes for `arch`."""
    spec = jax_get_arch(arch)
    port_spec = get_arch(arch)
    if spec.family == "lm":
        model = spec.build_reduced()
        params = model.init(jax.random.key(0))
        toks = jax.random.randint(jax.random.key(1), (2, 16), 0,
                                  model.cfg.vocab)
        loss = float(model.loss(params, toks, jnp.roll(toks, -1, 1)))
        cfg = port_spec.build_reduced(device="cpu").cfg
        return (convert.lm_params_from_numpy(_np(params), cfg),
                {"tokens": torch.tensor(np.asarray(toks), dtype=torch.int64)},
                loss)
    if spec.family == "gnn":
        from repro.graph.graphs import erdos_graph
        model = spec.build_reduced("full_graph_sm")
        params = model.init(jax.random.key(0))
        g = erdos_graph(jax.random.key(1), 64, 256, 16, with_pos=True)
        pg = Graph(senders=torch.tensor(np.asarray(g.senders), dtype=torch.int64),
                   receivers=torch.tensor(np.asarray(g.receivers),
                                          dtype=torch.int64),
                   x=torch.tensor(np.asarray(g.x)),
                   pos=torch.tensor(np.asarray(g.pos)))
        inputs = {"graph": pg}
        if arch == "dimenet":
            from repro.graph.triplets import build_triplets
            trip = build_triplets(np.asarray(g.senders),
                                  np.asarray(g.receivers), 64, 1024)
            out = model(params, g, *(jnp.asarray(t) for t in trip))
            inputs["triplets"] = [torch.tensor(np.asarray(t)) for t in trip]
        else:
            out = model(params, g)
        return (convert.graph_params_from_numpy(_np(params)), inputs,
                np.asarray(out))
    model = spec.build_reduced()
    params = model.init(jax.random.key(0))
    c = model.cfg
    u = jax.random.randint(jax.random.key(1), (8, c.user_fields,
                                               c.max_ids_per_field), -1, 100)
    i = jax.random.randint(jax.random.key(2), (8, c.item_fields,
                                               c.max_ids_per_field), -1, 100)
    return (convert.two_tower_params_from_numpy(_np(params)),
            {"users": torch.tensor(np.asarray(u), dtype=torch.int64),
             "items": torch.tensor(np.asarray(i), dtype=torch.int64)},
            float(model.loss(params, u, i)))


def test_arch_zoo_all_matches_jax():
    lines, _ = jax_main("arch_zoo", ["--arch", "all"])
    cases = {a: jax_case(a) for a in ARCH_IDS}
    say = arch_zoo.run(arch_zoo.parse_args(["--device", "cpu"]),
                       params={a: c[0] for a, c in cases.items()},
                       inputs={a: c[1] for a, c in cases.items()})
    assert len(say.lines) == 2 * len(ARCH_IDS)
    assert_same_printout(say.lines, lines)
    fams = [jax_get_arch(a).family for a in ARCH_IDS]
    losses = [cases[a][2] for a, f in zip(ARCH_IDS, fams) if f != "gnn"]
    assert_losses_close(say.values["loss"], losses)
    outs = [cases[a][2] for a, f in zip(ARCH_IDS, fams) if f == "gnn"]
    assert len(say.values["out"]) == len(outs) == 4
    for got, want in zip(say.values["out"], outs):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_arch_zoo_draws_its_own_inputs():
    say = arch_zoo.run(arch_zoo.parse_args(["--arch", "dimenet",
                                            "--device", "cpu"]))
    assert say.lines == ["== dimenet [gnn] ==",
                         "  forward out (64, 7), finite=True"]
