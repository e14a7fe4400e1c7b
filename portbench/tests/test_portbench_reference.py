"""The float64 reference against a two-layer GraphSAGE worked out by hand
on a 5-vertex graph, and its training step against torch.autograd."""
import numpy as np
import torch

from portbench.reference import sage

# 5 vertices, 2-d features; edges (src -> dst), vertex 4 has no in-edge
X = [[1.0, 0.0], [0.0, 2.0], [1.0, 1.0], [-1.0, 3.0], [2.0, -1.0]]
EDGES = [(0, 1), (2, 1), (1, 0), (3, 0), (3, 0), (4, 2), (0, 3)]
W = {"l0": {"self": {"w": [[1.0, 0.0], [0.0, 1.0]], "b": [0.0, -1.0]},
            "neigh": {"w": [[0.5, 0.0], [0.0, 0.5]]}},
     "l1": {"self": {"w": [[1.0, 1.0], [0.0, 1.0]], "b": [0.5, 0.0]},
            "neigh": {"w": [[1.0, 0.0], [-1.0, 1.0]]}}}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(tree, dtype=torch.float32)


def _by_hand(last_act):
    """Each vertex's layers from the definition, loop by loop."""
    def step(h, p, act):
        out = []
        for v in range(5):
            ins = [h[u] for u, w in EDGES if w == v]
            mean = [sum(x[i] for x in ins) / len(ins) if ins else 0.0
                    for i in range(2)]
            z = [sum(h[v][i] * p["self"]["w"][i][j] for i in range(2))
                 + p["self"]["b"][j]
                 + sum(mean[i] * p["neigh"]["w"][i][j] for i in range(2))
                 for j in range(2)]
            out.append([max(x, 0.0) for x in z] if act else z)
        return out
    h1 = step(X, W["l0"], True)
    return h1, step(h1, W["l1"], last_act)


def _graph():
    e = torch.tensor(EDGES)
    return torch.tensor(X), e[:, 0], e[:, 1]


def test_forward_matches_hand_computation():
    x, src, dst = _graph()
    outs, caches = sage.forward(x, src, dst, _tensors(W))
    h1, h2 = _by_hand(last_act=False)
    assert outs[0].dtype == torch.float64
    np.testing.assert_allclose(outs[0].numpy(), h1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(outs[1].numpy(), h2, rtol=0, atol=1e-12)
    # vertex 0's layer-0 neighbour mean: (x1 + 2 x3) / 3
    np.testing.assert_allclose(caches[0][1][0].numpy(), [-2 / 3, 8 / 3])
    # with a head after it the last layer keeps its relu
    w = dict(_tensors(W), head={"w": torch.ones(2, 3), "b": torch.zeros(3)})
    outs, _ = sage.forward(x, src, dst, w)
    np.testing.assert_allclose(outs[1].numpy(), _by_hand(last_act=True)[1],
                               atol=1e-12)


def test_training_step_gradients_match_autograd():
    """The first step's loss and per-part gradients against autograd of
    the model at its initial weights (where the caches are fresh), every
    part with its own copy of each layer leaf."""
    torch.manual_seed(0)
    x, src, dst = _graph()
    w = dict(_tensors(W), head={"w": torch.randn(2, 3),
                                "b": torch.randn(3)})
    outs, caches = sage.forward(x, src, dst, w)
    part = torch.tensor([0, 1, 1, 0, 1])
    rows, labels = torch.tensor([0, 2, 3]), torch.tensor([2, 0, 1])
    pr = sage.Precision("float64")
    w64 = pr.cast(w)
    loss, pg, hg = sage.grads(pr, w64, caches, outs[-1], src, dst, part, 2,
                              rows, labels)
    copies = {}

    def leaf(l, k, n, p):
        if (l, k, n, p) not in copies:
            copies[(l, k, n, p)] = w64[l][k][n].clone().requires_grad_()
        return copies[(l, k, n, p)]

    def layer(l, h):
        agg = torch.zeros_like(h).index_add(0, dst, h[src])
        cnt = torch.zeros(5, dtype=h.dtype).index_add(
            0, dst, torch.ones(len(dst), dtype=h.dtype))
        mean = agg / cnt.clamp(min=1)[:, None]
        return torch.relu(torch.stack([
            h[v] @ leaf(l, "self", "w", int(part[v]))
            + leaf(l, "self", "b", int(part[v]))
            + mean[v] @ leaf(l, "neigh", "w", int(part[v]))
            for v in range(5)]))

    head = {k: v.clone().requires_grad_() for k, v in w64["head"].items()}
    h2 = layer("l1", layer("l0", x.double()))
    want = torch.nn.functional.cross_entropy(
        h2[rows] @ head["w"] + head["b"], labels)
    want.backward()
    assert abs(float(loss) - float(want.detach())) < 1e-12
    for (l, k, n, p), t in copies.items():
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(pg[l][k][n][p].numpy(), g.numpy(),
                                   atol=1e-12)
    for k in ("w", "b"):
        np.testing.assert_allclose(hg[k].numpy(), head[k].grad.numpy(),
                                   atol=1e-12)


def test_compress_keeps_top_quarter_in_int8():
    acc = torch.tensor([[4.0, -1.0, 0.5, 3.0, 0.0, -8.0, 2.0, 1.0]],
                       dtype=torch.float64)
    sent, res = sage.compress(acc, 0.25)
    scale = 8.0 / 127
    want = [0.0] * 8
    want[0], want[5] = round(4.0 / scale) * scale, -8.0
    np.testing.assert_allclose(sent[0].numpy(), want, atol=1e-12)
    np.testing.assert_allclose((sent + res).numpy(), acc.numpy())


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    got = sage.tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
