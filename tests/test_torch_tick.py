"""One layer tick of the port (repro_torch.core.tick.layer_tick_body)
against the JAX `layer_tick`, for all four window policies and both JAX
delivery backends, from the same mid-stream state.

The state comes from a JAX pipeline that has streamed three ticks; the
fourth tick's batches are applied to the topology and fed to layer 0, then
layer 0's outbox to layer 1, in both packages. Each JAX backend is held
against both port backends ("kernel" runs its plain versions on the CPU).

Tolerances: integer state, flags, aggregator counts, outbox addresses and
every TickStats counter exactly equal; float state within 1e-5 (the same
bound tests/test_delivery_backend.py uses for pallas vs xla).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import state as jst
from repro.core import windowing as jwin
from repro.core.delivery import make_delivery as jax_make_delivery
from repro.core.pipeline import D3Pipeline as JaxPipeline
from repro.core.pipeline import PipelineConfig as JaxConfig
from repro.core.tick import layer_tick
from repro.graph.sage import GraphSAGE as JaxSAGE
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tev
from repro_torch.core import state as tst
from repro_torch.core import windowing as twin
from repro_torch.core.delivery import make_delivery
from repro_torch.core.tick import SCALAR_FIELDS, layer_tick_body
from repro_torch.graph.sage import GraphSAGE

N_NODES, D_IN, DIMS = 32, 8, (8, 12, 12)
POLICIES = ["streaming", "tumbling", "session", "adaptive"]
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _window(kind, mod):
    return mod.WindowConfig(kind=kind) if kind in ("streaming", "adaptive") \
        else mod.WindowConfig(kind=kind, interval=3)


def _stream(seed=0, n_edges=100):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N_NODES, n_edges),
                      rng.integers(0, N_NODES, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D_IN).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


def _to_torch(obj, cls):
    """JAX dataclass -> the port's dataclass (fields the port carries)."""
    from dataclasses import fields
    out = {}
    for f in fields(cls):
        a = np.array(getattr(obj, f.name))
        out[f.name] = torch.as_tensor(
            a.astype(np.int64) if a.dtype == np.int32 else a)
    return cls(**out)


def _assert_state_equal(got, want):
    for name in ("feat", "x_sent", "agg", "cms"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   **FLOAT_TOL, err_msg=name)
    for name in ("has_feat", "has_sent", "agg_cnt", "red_pending",
                 "red_deadline", "fwd_pending", "fwd_deadline",
                 "last_touch"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _assert_tick_equal(got, want):
    (g_ls, g_out, g_st, g_x), (w_ls, w_out, w_st, _) = got, want
    assert g_x is None
    _assert_state_equal(g_ls, w_ls)
    valid = np.asarray(w_out.valid)
    np.testing.assert_array_equal(g_out.valid.numpy(), valid)
    np.testing.assert_array_equal(g_out.part.numpy(), np.asarray(w_out.part))
    np.testing.assert_array_equal(g_out.slot.numpy(), np.asarray(w_out.slot))
    np.testing.assert_allclose(g_out.feat.numpy()[valid],
                               np.asarray(w_out.feat)[valid], **FLOAT_TOL)
    for name in SCALAR_FIELDS:
        assert int(getattr(g_st, name)) == int(getattr(w_st, name)), name
    np.testing.assert_array_equal(g_st.busy.numpy(), np.asarray(w_st.busy))


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("kind", POLICIES)
def test_layer_tick_matches_jax(kind, jax_backend):
    jmodel = JaxSAGE(DIMS)
    jparams = jmodel.init(jax.random.key(0))
    cfg = JaxConfig(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                    feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
                    window=_window(kind, jwin))
    pipe = JaxPipeline(jmodel, jparams, cfg)
    edges, feats = _stream()
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    for i in range(3):
        pipe.tick(e_chunks[i], f_chunks[i])
    eb, rb, vb, fb, _, _ = pipe._build_batches(e_chunks[3], f_chunks[3])
    topo = jst.apply_edge_batch(jst.apply_repl_batch(
        jst.apply_vertex_batch(pipe.topo, vb), rb), eb)
    now = jnp.int32(pipe.now)
    wconf = _window(kind, jwin)
    outbox_cap = cfg.capacities().outbox

    model = GraphSAGE(DIMS)
    model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    t_topo = _to_torch(topo, tst.TopoState)
    t_eb, t_rb = _to_torch(eb, tev.EdgeBatch), _to_torch(rb, tev.ReplBatch)
    t_now = torch.tensor(pipe.now, dtype=torch.int64)
    t_wconf = _window(kind, twin)

    jdel = jax_make_delivery(jax_backend)
    inbox = fb
    want = []
    for li, layer in enumerate(jmodel.layers):
        out = layer_tick(layer, jparams[f"l{li}"], topo, pipe.states[li],
                         inbox, eb, rb, now, wconf, outbox_cap,
                         delivery=jdel)
        want.append(out)
        inbox = out[1]
    # a tick with traffic in both rounds
    assert sum(int(w[2].reduce_msgs) + int(w[2].broadcast_msgs)
               for w in want) > 0

    for port_backend in ("kernel", "scatter"):
        inbox = _to_torch(fb, tev.FeatBatch)
        for li, layer in enumerate(model.layers):
            got = layer_tick_body(
                layer, t_topo, _to_torch(pipe.states[li], tst.LayerState),
                inbox, t_eb, t_rb, t_now, t_wconf, outbox_cap,
                delivery=make_delivery(port_backend))
            _assert_tick_equal(got, want[li])
            inbox = got[1]


def test_cms_hash_bit_exact():
    rng = np.random.default_rng(1)
    keys = np.concatenate([rng.integers(0, 2 ** 31 - 1, 4000),
                           [0, 1, 2 ** 31 - 1, 65535, 65536]])
    for depth, width in ((4, 2048), (6, 1000), (7, 97)):
        want = np.asarray(jwin.cms_hash(jnp.asarray(keys, jnp.int32),
                                        depth, width))
        got = twin.cms_hash(torch.as_tensor(keys), depth, width).numpy()
        np.testing.assert_array_equal(got, want)


def test_adaptive_deadline_rounds_up():
    """Fractional alpha / freq intervals round UP (ceil), as in JAX."""
    wc = twin.WindowConfig(kind="adaptive", adaptive_alpha=8.0)
    freq = torch.tensor([16.0, 3.0, 0.0, 1000.0])
    got = twin.next_deadline(wc, torch.tensor(5),
                             torch.zeros(4, dtype=torch.int64),
                             torch.zeros(4, dtype=torch.bool), freq)
    want = jwin.next_deadline(jwin.WindowConfig(kind="adaptive"),
                              jnp.int32(5), jnp.zeros(4, jnp.int32),
                              jnp.zeros(4, bool), jnp.asarray(freq.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [6, 8, 21, 6]
