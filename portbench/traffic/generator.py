"""The one traffic generator: every mix under `portbench/traffic/` is a JSON
file of parameters that this module reads.

A mix describes a stream of graph events and the clients beside it:

  edges      {"alpha", "tick_edges"}: a power-law edge stream over the
             configuration's vertex ids, cut into ticks of `tick_edges`;
  super_ticks  ticks a device launch carries (T);
  warm_super_ticks  launches run in set-up before the window;
  queries    {"rate_per_s", "link_every"}: open-loop point reads, a
             fixed number (rate x window) of arrival times drawn
             uniformly over the window (a Poisson process given its
             count), one in `link_every` a link score, the rest embedding
             reads, each endpoint drawn uniformly over the vertices that
             set-up's warm launches ingested (set-up ends with a drain,
             which materialises each of them, so every read names a
             vertex that has an embedding, whatever the window's timing);
  labels     {"per_tick"}: label events on ingested vertices, drawn
             uniformly without repeats within a tick;
  check      how much the correctness comparison reads: consistent reads
             after the window, training steps driven in set-up;
  origin     where the parameters come from (read by no code).

Each vertex's feature arrives with its first edge. Every draw comes from
`--seed` through its own numpy stream (one per purpose, so the edge
stream is the same whatever the clients draw); features and the label
projection are drawn on the device with a `torch.Generator`.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# draw streams, one per purpose, all spawned from the run's seed
_EDGES, _QUERIES, _LABELS, _CHECK, _FEATURES, WEIGHTS = range(6)


def load_mix(name: str, root: Path = HERE) -> dict:
    """The mix `traffic/<name>.json`; a name with a slash is a path from
    `root` (the tests' small mixes)."""
    path = root / f"{name}.json" if "/" in name else HERE / f"{name}.json"
    return json.loads(path.read_text())


def powerlaw_edges(rng: np.random.Generator, n_nodes: int, n_edges: int,
                   alpha: float = 1.5) -> np.ndarray:
    """Frozen copy of `src/repro_torch/graph/graphs.py:powerlaw_edges`
    (the stream behind the port's chip figures): hub-skewed [E, 2]
    int32 (src, dst), no self loops."""
    w = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w)
    dst = rng.choice(n_nodes, size=n_edges, p=w)
    # avoid self loops by bumping dst
    dst = np.where(dst == src, (dst + 1) % n_nodes, dst)
    return np.stack([src, dst], axis=1).astype(np.int32)


def _rng(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), purpose]))


def torch_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for a `torch.Generator`, spawned like `_rng`'s."""
    state = np.random.SeedSequence([int(seed), purpose]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class Traffic:
    """The mix's events for one run, drawn from `seed`.

    Host state: which vertices have been ingested, in the order of their
    first tick, updated as launches are handed out."""

    def __init__(self, mix: dict, n_vertices: int, d_in: int, seed: int,
                 device, n_classes: int = 0):
        self.mix, self.n, self.d_in = mix, int(n_vertices), int(d_in)
        self.T = int(mix["super_ticks"])
        self.tick_edges = int(mix["edges"]["tick_edges"])
        self.alpha = float(mix["edges"]["alpha"])
        self.seed = int(seed)
        self._edge_rng = _rng(seed, _EDGES)
        self._label_rng = _rng(seed, _LABELS)
        gen = torch.Generator(device=device).manual_seed(
            torch_seed(seed, _FEATURES))
        # every vertex's feature row, drawn in one call on the device
        feats = torch.randn(self.n, self.d_in, generator=gen, device=device)
        self.classes = None
        if n_classes:
            proj = torch.randn(self.d_in, n_classes, generator=gen,
                               device=device)
            self.classes = (feats @ proj).argmax(1).cpu().numpy()
        self.feats = feats.cpu().numpy()
        del feats
        self.warm_ticks = int(mix.get("warm_super_ticks", 0)) * self.T
        self.seen = np.zeros(self.n, bool)      # feature sent
        self.order = np.zeros(self.n, np.int64)  # vids by first tick
        self.seen_at: list = []                  # vertices seen after tick i
        self.edges_out: list = []                # every edge handed out

    # --------------------------------------------------------------- stream
    def next_launch(self):
        """One launch: T edge chunks and, per tick, the feature events of
        vertices first seen in it, as [(vid, row)] in order of first
        appearance (src before dst, edge by edge)."""
        edges = powerlaw_edges(self._edge_rng, self.n,
                               self.T * self.tick_edges, self.alpha)
        e_chunks, f_chunks = [], []
        for t in range(self.T):
            chunk = edges[t * self.tick_edges:(t + 1) * self.tick_edges]
            flat = chunk.reshape(-1)
            vids, first = np.unique(flat, return_index=True)
            new = ~self.seen[vids]
            order = np.argsort(first[new], kind="stable")
            fresh = vids[new][order]
            self.seen[fresh] = True
            n0 = self.seen_at[-1] if self.seen_at else 0
            self.order[n0:n0 + len(fresh)] = fresh
            self.seen_at.append(n0 + len(fresh))
            e_chunks.append(chunk)
            f_chunks.append([(int(v), self.feats[v]) for v in fresh])
        self.edges_out.append(edges)
        return e_chunks, f_chunks

    def all_edges(self) -> np.ndarray:
        return (np.concatenate(self.edges_out) if self.edges_out
                else np.zeros((0, 2), np.int32))

    def ingested(self) -> np.ndarray:
        return np.flatnonzero(self.seen)

    # -------------------------------------------------------------- clients
    def pick(self, u: np.ndarray) -> np.ndarray:
        """Vertices for uniforms `u` in [0, 1): uniform over those that the
        warm launches ingested, a set fixed by the seed alone."""
        if self.warm_ticks == 0 or len(self.seen_at) < self.warm_ticks:
            raise ValueError("reads need the warm launches handed out")
        m = self.seen_at[self.warm_ticks - 1]
        return self.order[np.minimum((u * m).astype(np.int64), m - 1)]

    def query_schedule(self, seconds: float):
        """(due offsets [Q] in s, sorted; is_link [Q] bool; uniforms [Q, 2])
        of the window's point reads."""
        q = self.mix["queries"]
        rng = _rng(self.seed, _QUERIES)
        n = int(round(q["rate_per_s"] * seconds))
        due = np.sort(rng.uniform(0.0, seconds, n))
        is_link = np.zeros(n, bool)
        is_link[:n // int(q["link_every"])] = True
        is_link = rng.permutation(is_link)
        return due, is_link, rng.uniform(0.0, 1.0, (n, 2))

    def labels_for_launch(self, per_tick: int):
        """T label chunks [(vid, class)] over the vertices ingested so far,
        `per_tick` distinct ones a tick (fewer while fewer exist)."""
        pool = self.ingested()
        out = []
        for _ in range(self.T):
            k = min(per_tick, len(pool))
            vids = self._label_rng.choice(pool, k, replace=False)
            out.append([(int(v), int(self.classes[v])) for v in vids])
        return out

    def check_rng(self) -> np.random.Generator:
        """The stream the correctness comparison draws its samples from."""
        return _rng(self.seed, _CHECK)
