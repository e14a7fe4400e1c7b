"""The halt-flush `TrainingCoordinator` on a mesh pipeline (`MeshView`):
every rank gathers the global state, trains on it and writes its own
block of the rebuilt layers and sink back. On 2 gloo CPU ranks, a 1-D
mesh and a 2-stage grid, the losses, the trained parameters and the
rebuilt embeddings equal the one-device coordinator's on the same stream
(within 1e-5)."""
import numpy as np
import pytest
import torch

from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.core.train_plane import TrainConfig
from repro_torch.core.training import TrainingCoordinator
from repro_torch.graph.sage import GraphSAGE, linear_tree
from repro_torch.launch.mesh import spawn_stream_mesh
from repro_torch.nn.layers import Linear
from repro_torch.optim import sgd

N_NODES, N_EDGES, D_IN = 50, 150, 8


def _train(mesh, dims, stage):
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, N_NODES, N_EDGES),
                      rng.integers(0, N_NODES, N_EDGES)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D_IN).astype(np.float32)
             for v in range(N_NODES)}
    labels = {v: int(rng.integers(0, 4)) for v in range(N_NODES)}
    pipe = D3Pipeline(GraphSAGE(dims, seed=0), PipelineConfig(
        n_parts=4, node_cap=64, edge_cap=256, repl_cap=256, feat_cap=512,
        edge_tick_cap=64, max_nodes=N_NODES, n_stages=stage,
        window=win.WindowConfig(kind=win.SESSION, interval=3)),
        mesh=mesh, device="cpu" if mesh is None else None)
    pipe.run_stream(edges, feats, tick_edges=32)
    head = Linear(dims[-1], 4, generator=torch.Generator().manual_seed(1))
    coord = TrainingCoordinator(pipe, head, linear_tree(head), TrainConfig(
        optimizer=sgd(), lr=0.1, batch_threshold=2))
    coord.observe_labels(labels)
    res = coord.train(epochs=3)
    return {"losses": res.losses, "votes": res.votes,
            "head": {k: v.clone() for k, v in coord.head_params.items()},
            "params": {k: v.clone() for k, v in pipe.model.state_dict()
                       .items()},
            "emb": pipe.embeddings()}


@pytest.mark.parametrize("dims,stage", [((D_IN, 16, 16), 1),
                                        ((D_IN, D_IN, D_IN), 2)])
def test_coordinator_on_two_ranks_equals_one_device(dims, stage):
    want = _train(None, dims, stage=1)
    got = spawn_stream_mesh(2, _train, backend="gloo", device="cpu",
                            stage=stage, args=(dims, stage), timeout=300)
    assert want["emb"] and want["votes"] > 2
    for r in got:
        assert r["votes"] == want["votes"]
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        for tree in ("head", "params"):
            for k, v in want[tree].items():
                np.testing.assert_allclose(r[tree][k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-6)
        assert set(r["emb"]) == set(want["emb"])
        for vid, vec in want["emb"].items():
            np.testing.assert_allclose(r["emb"][vid], vec, rtol=1e-5,
                                       atol=1e-5)
