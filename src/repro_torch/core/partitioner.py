"""Streaming vertex-cut partitioners (paper §4.4): HDRF, CLDA-like, Random.

Counterpart of `repro/core/partitioner.py` (pure numpy, host side). It
assigns:
  * a logical part to every edge (vertex-cut: edges are atomic, vertices
    replicate),
  * master parts (first placement) and per-part local slots for vertices,
  * replication records used for master->replica feature broadcast.

Edges are scored in vectorized chunks against a frozen table snapshot, with
tables updated between chunks — the same mild staleness the paper accepts
when distributing the partitioner across threads (§4.4.1, vertex-locking).

HDRF (Petroni et al., CIKM'15) score for edge (u,v) and part p:
    C_REP = g(u,p) + g(v,p),  g(u,p) = [u in p] * (1 + (1 - theta_u))
      with theta_u = d(u) / (d(u) + d(v))  (normalized partial degree)
    C_BAL = bal * (maxsize - size_p) / (eps + maxsize - minsize)

Capacity check: given `node_cap`/`edge_cap`/`repl_cap`, a vertex, edge or
replication slot that would reach its cap raises ValueError naming the
cap. The device tables are [P, cap] blocks addressed as part * cap + slot,
so an over-cap slot would otherwise land in the NEXT part's rows (or, in
the last part, in the drop sentinel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class PartitionTables:
    n_parts: int
    max_nodes: int
    degree: np.ndarray                  # [V] partial degrees
    replicas: np.ndarray                # [V, P] bool membership
    load: np.ndarray                    # [P] edge counts
    master: np.ndarray                  # [V] int32, -1 = unseen
    master_slot: np.ndarray             # [V] int32
    slot_of: dict                       # (part, vid) -> slot
    next_vslot: np.ndarray              # [P] next free vertex slot
    next_eslot: np.ndarray              # [P] next free edge slot


class StreamingPartitioner:
    def __init__(self, n_parts: int, max_nodes: int, method: str = "hdrf",
                 bal: float = 2.0, eps: float = 1.0, seed: int = 0,
                 chunk: int = 1024, node_cap: Optional[int] = None,
                 edge_cap: Optional[int] = None,
                 repl_cap: Optional[int] = None):
        self.method = method
        self.bal = bal
        self.eps = eps
        self.chunk = chunk
        self.caps = {"node_cap": node_cap, "edge_cap": edge_cap,
                     "repl_cap": repl_cap}
        self.rng = np.random.default_rng(seed)
        self.t = PartitionTables(
            n_parts=n_parts, max_nodes=max_nodes,
            degree=np.zeros(max_nodes, np.int64),
            replicas=np.zeros((max_nodes, n_parts), bool),
            load=np.zeros(n_parts, np.int64),
            master=np.full(max_nodes, -1, np.int32),
            master_slot=np.full(max_nodes, -1, np.int32),
            slot_of={}, next_vslot=np.zeros(n_parts, np.int64),
            next_eslot=np.zeros(n_parts, np.int64))
        self._repl_counters = np.zeros(n_parts, np.int64)
        self._v_rows = {k: [] for k in ("part", "slot", "is_master")}
        self._r_rows = {k: [] for k in ("part", "repl_slot", "master_slot",
                                        "rep_part", "rep_slot")}

    def _check_cap(self, name: str, slot: int, part: int) -> None:
        cap = self.caps[name]
        if cap is not None and slot >= cap:
            raise ValueError(
                f"PipelineConfig.{name}={cap} exceeded: part {part} needs "
                f"slot {slot}; raise {name} (an over-cap slot would "
                "overwrite the next part's rows)")

    # ------------------------------------------------------------- scoring
    def _affinity_chunk(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Replication-affinity term per (edge, part); degree/replica
        tables are frozen per chunk, the balance term is applied per edge
        with live loads in _pick_part."""
        t = self.t
        du = t.degree[src] + 1.0
        dv = t.degree[dst] + 1.0
        theta_u = (du / (du + dv))[:, None]                    # [C,1]
        theta_v = 1.0 - theta_u
        in_u = t.replicas[src]                                 # [C,P]
        in_v = t.replicas[dst]
        if self.method == "hdrf":
            return in_u * (1 + (1 - theta_u)) + in_v * (1 + (1 - theta_v))
        if self.method == "clda":
            # CLDA-like: degree-attenuated replication affinity
            return in_u * (1 + (1.0 / np.sqrt(du))[:, None]) + \
                in_v * (1 + (1.0 / np.sqrt(dv))[:, None])
        raise ValueError(self.method)

    def _pick_part(self, g_row: np.ndarray) -> int:
        t = self.t
        mx, mn = t.load.max(), t.load.min()
        c_bal = self.bal * (mx - t.load) / (self.eps + mx - mn)
        return int(np.argmax(g_row + c_bal))

    # ------------------------------------------------------------- ingest
    def ingest_edges(self, edges: np.ndarray):
        """edges: [n,2] int (src, dst) global ids.

        Returns (edge_rows, repl_rows, vertex_rows) dicts of numpy columns
        for the events.*_batch_from_numpy builders. Repl/vertex rows include
        any allocations made via locate_master since the last call.
        """
        t = self.t
        e_rows = {k: [] for k in ("part", "edge_slot", "src_slot", "dst_slot",
                                  "dst_master_part", "dst_master_slot")}
        for lo in range(0, len(edges), self.chunk):
            chunk = edges[lo: lo + self.chunk]
            if self.method == "random":
                parts = self.rng.integers(0, t.n_parts, size=len(chunk))
                aff = None
            else:
                aff = self._affinity_chunk(chunk[:, 0], chunk[:, 1])
            for ci, (u, v) in enumerate(chunk):
                p = int(parts[ci]) if aff is None else self._pick_part(aff[ci])
                u, v = int(u), int(v)
                su = self._ensure_vertex(u, p)
                sv = self._ensure_vertex(v, p)
                es = int(t.next_eslot[p])
                self._check_cap("edge_cap", es, p)
                t.next_eslot[p] += 1
                e_rows["part"].append(p)
                e_rows["edge_slot"].append(es)
                e_rows["src_slot"].append(su)
                e_rows["dst_slot"].append(sv)
                e_rows["dst_master_part"].append(t.master[v])
                e_rows["dst_master_slot"].append(t.master_slot[v])
                t.load[p] += 1
                t.degree[u] += 1
                t.degree[v] += 1
        e_rows = {k: np.asarray(v, np.int64) for k, v in e_rows.items()}
        r_rows, v_rows = self.drain_allocations()
        return e_rows, r_rows, v_rows

    def drain_allocations(self):
        """Pop accumulated replica + vertex rows (numpy columns)."""
        r = {k: np.asarray(v, np.int64) for k, v in self._r_rows.items()}
        vr = {k: np.asarray(v) for k, v in self._v_rows.items()}
        self._r_rows = {k: [] for k in self._r_rows}
        self._v_rows = {k: [] for k in self._v_rows}
        return r, vr

    def _ensure_vertex(self, vid: int, part: int) -> int:
        """Make sure vid has a slot in `part`; allocate master/replica."""
        t = self.t
        key = (part, vid)
        slot = t.slot_of.get(key)
        if slot is not None:
            return slot
        slot = int(t.next_vslot[part])
        self._check_cap("node_cap", slot, part)
        first = t.master[vid] < 0
        if not first:
            m_part = int(t.master[vid])
            self._check_cap("repl_cap", int(self._repl_counters[m_part]),
                            m_part)
        t.next_vslot[part] += 1
        t.slot_of[key] = slot
        t.replicas[vid, part] = True
        if first:
            t.master[vid] = part
            t.master_slot[vid] = slot
        else:
            # new replica: record master -> replica broadcast edge
            self._r_rows["part"].append(m_part)
            self._r_rows["repl_slot"].append(self._alloc_repl(m_part))
            self._r_rows["master_slot"].append(int(t.master_slot[vid]))
            self._r_rows["rep_part"].append(part)
            self._r_rows["rep_slot"].append(slot)
        self._v_rows["part"].append(part)
        self._v_rows["slot"].append(slot)
        self._v_rows["is_master"].append(bool(first))
        return slot

    def _alloc_repl(self, master_part: int) -> int:
        c = int(self._repl_counters[master_part])
        self._repl_counters[master_part] += 1
        return c

    # --------------------------------------------------------- feature path
    def locate_master(self, vid: int, create: bool = True):
        """(part, slot) of vid's master; optionally create on least-loaded."""
        t = self.t
        if t.master[vid] < 0:
            if not create:
                return None
            p = int(np.argmin(t.load))
            self._ensure_vertex(vid, p)
        return int(t.master[vid]), int(t.master_slot[vid])

    # ------------------------------------------------------------- metrics
    def replication_factor(self) -> float:
        seen = self.t.master >= 0
        if not seen.any():
            return 0.0
        return float(self.t.replicas[seen].sum() / seen.sum())

    def load_imbalance(self) -> float:
        ld = self.t.load
        return float(ld.max() / max(ld.mean(), 1e-9))

    @property
    def n_parts(self):
        return self.t.n_parts
