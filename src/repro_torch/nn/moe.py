"""Token-choice top-k Mixture-of-Experts with capacity-sorted dispatch.

Counterpart of `repro/nn/moe.py`. Two execution paths:
  * `MoELayer.dense_oracle`: every token through every expert, exact; the
    tests' reference (equal to the sorted dispatch when nothing drops).
  * sorted dispatch (`MoELayer.forward`): the (token, expert) pairs
    stably sorted by expert id, packed into a static [E, C, d] buffer
    (capacity C; pairs past it go to a trash slot E * C whose rows are
    discarded), batched expert GEMMs, and the weighted rows added back
    per token. Overflowing pairs drop (capacity-factor semantics).

Expert parallelism (`cfg.ep_axis` set) runs `dist/moe_ep.py:moe_ep_apply`
over a `StreamMesh`, one process a rank; this module is the single-rank
compute. JAX computes all of it outside any Pallas kernel, and so does
the port: plain PyTorch (`torch.bmm`, `index_add_`).

Parameters are stored [in, out] as JAX holds them: router [d, E], wg / wu
[E, d, h], wd [E, h, d], and with n_shared a SwiGLU `shared` of hidden
n_shared * h. Each is drawn in f32 on the layer's device (the expert
slabs by lecun_normal over one expert's fans, `batch_axes=(0,)`) and
stored in `dtype`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.initializers import fans, lecun_normal_
from repro_torch.nn.layers import SwiGLU, init_param


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden
    every: int = 1            # MoE layer every `every` layers (rest dense)
    n_shared: int = 0         # shared experts always applied
    capacity_factor: float = 1.25
    # explicit expert parallelism over a StreamMesh's ranks (non-empty:
    # on; the mesh is passed to the call, and each rank holds its own
    # tokens, so JAX's dp_axes has no counterpart)
    ep_axis: tuple = ()


def capacity(T: int, K: int, cf: float, n_buckets: int, E: int) -> int:
    """Slots a bucket (an expert, or an EP rank) takes: dropless T * K
    for decode-sized T <= 4 E, else max(1, int(T K cf / n_buckets)) in
    Python float arithmetic, as JAX computes it."""
    if T <= 4 * E:
        return T * K
    return max(1, int(T * K * cf / n_buckets))


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim, ties broken
    toward the lower index (jax.lax.top_k's order; torch.topk leaves it
    open): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router, x, k: int):
    """x [T, d] -> (expert ids [T, k] int64, weights [T, k] in x's dtype,
    router probs [T, E] f32): logits in x's dtype, softmax in f32, the
    top-k weights renormalised to sum 1."""
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = top_k(probs, k)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return ids, w.to(x.dtype), probs


def _counts(ids, n: int):
    """How often each of 0..n-1 occurs in ids (int64): `bincount`'s
    answer without its device-to-host read of the output size."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def segment_positions(sorted_ids, num_segments: int):
    """Rank of each element within its (sorted) segment: 0, 1, 2, ... per
    id."""
    counts = _counts(sorted_ids, num_segments)
    starts = torch.cumsum(counts, 0) - counts
    return torch.arange(sorted_ids.shape[0],
                        device=sorted_ids.device) - starts[sorted_ids]


def load_balance_loss(probs, ids, E: int):
    """Switch-style aux loss: E * <f_e . p_e> over experts (f the share
    of routed pairs, p the mean router probability), f32."""
    T = probs.shape[0]
    f = _counts(ids.reshape(-1), E).float() / (T * ids.shape[-1])
    return E * torch.sum(f * probs.mean(dim=0))


def pack_rows(x, tok, keep, slot, n_slots: int):
    """[n_slots, d]: row slot[i] holds x[tok[i]] where keep[i]; the pairs
    that do not keep go to a trash row n_slots, which is cut off."""
    rows = torch.where(keep[:, None], x[tok], 0)
    buf = x.new_zeros((n_slots + 1,) + tuple(x.shape[1:]))
    return buf.index_copy_(0, slot, rows)[:n_slots]


def combine_rows(y, tok, keep, slot, w, like):
    """out[t] = sum of w[i] * y[slot[i]] over the kept pairs i of token t
    (`index_add_`); `like` gives out's shape and dtype."""
    n = y.shape[0]
    contrib = torch.where(keep[:, None],
                          y[torch.clamp(slot, max=n - 1)] * w[:, None], 0)
    return torch.zeros_like(like).index_add_(0, tok, contrib)


def _expert_lecun(t, generator):
    """lecun_normal of a stack of experts [E, in, out] (JAX's
    `batch_axes=(0,)`): fan_in is one expert's `in`."""
    lecun_normal_(t, fans(tuple(t.shape[1:]))[0], generator)


class MoELayer(nn.Module):
    """The MoE FFN of d_model-wide tokens. forward(x [T, d], mesh=None)
    -> (out [T, d], aux load-balance loss f32)."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model, self.cfg = d_model, cfg
        E, d, h = cfg.num_experts, d_model, cfg.d_ff
        self.router = init_param(
            (d, E), lambda t, g: t.normal_(0.0, 0.006, generator=g), dtype,
            device, generator)
        self.wg = init_param((E, d, h), _expert_lecun, dtype, device,
                             generator)
        self.wu = init_param((E, d, h), _expert_lecun, dtype, device,
                             generator)
        self.wd = init_param((E, h, d), _expert_lecun, dtype, device,
                             generator)
        self.shared = SwiGLU(d, h * cfg.n_shared, dtype=dtype, device=device,
                             generator=generator) if cfg.n_shared else None
        self.ep_mesh = None       # the EP dispatch's mesh in a model

    def route(self, x):
        """x [T, d] -> (expert ids [T, k], weights [T, k], probs [T, E])."""
        return route(self.router, x, self.cfg.top_k)

    def _shared(self, out, x):
        return out + self.shared(x) if self.shared is not None else out

    def forward(self, x, mesh=None):
        """x [T, d] (the caller flattens batch x seq). With cfg.ep_axis the
        expert-parallel dispatch over `mesh` (a StreamMesh, required), or
        over `self.ep_mesh` when none is passed: a model's blocks call
        the layer without one, so whoever builds an EP model sets it
        (`perf/variants.py:moonshot_train_ep`)."""
        if self.cfg.ep_axis:
            return self._ep_call(x, self.ep_mesh if mesh is None else mesh)
        T, d = x.shape
        cfg = self.cfg
        E, K = cfg.num_experts, cfg.top_k
        ids, w, probs = self.route(x)
        # decode-sized T gets dropless capacity: the buffer is tiny there
        # and capacity drops would corrupt decoding
        C = capacity(T, K, cfg.capacity_factor, E, E)
        e_flat = ids.reshape(-1)
        order = torch.argsort(e_flat, stable=True)
        e_sorted = e_flat[order]
        tok_sorted = torch.arange(T, device=x.device).repeat_interleave(
            K)[order]
        w_sorted = w.reshape(-1)[order]
        seg_pos = segment_positions(e_sorted, E)
        keep = seg_pos < C
        slot = torch.where(keep, e_sorted * C + seg_pos, E * C)
        xe = pack_rows(x, tok_sorted, keep, slot, E * C).reshape(E, C, d)
        # the experts' SwiGLU as batched GEMMs
        g = F.silu(torch.bmm(xe, self.wg.to(x.dtype)))
        u = torch.bmm(xe, self.wu.to(x.dtype))
        ye = torch.bmm(g * u, self.wd.to(x.dtype))
        out = combine_rows(ye.reshape(E * C, d), tok_sorted, keep, slot,
                           w_sorted, x)
        return self._shared(out, x), load_balance_loss(probs, ids, E)

    def _ep_call(self, x, mesh):
        """Expert parallelism over `mesh`'s ranks: this rank's tokens x,
        its slab of E / mesh.size experts. The aux loss is 0, as JAX's
        `_ep_call` returns it (ROADMAP R18: an EP model trains without
        its load-balance term)."""
        from repro_torch.dist.moe_ep import moe_ep_apply
        if mesh is None:
            raise ValueError(
                "MoELayer: cfg.ep_axis is set, so the expert-parallel "
                "dispatch runs over a StreamMesh; pass mesh=")
        e_loc = self.cfg.num_experts // mesh.size
        lo = mesh.rank * e_loc
        params = {"router": self.router,
                  **{n: getattr(self, n)[lo:lo + e_loc]
                     for n in ("wg", "wu", "wd")}}
        return (moe_ep_apply(self, params, x, mesh),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def dense_oracle(self, x):
        """Exact MoE (no capacity drops): all experts, weighted combine."""
        ids, w, probs = self.route(x)
        dt = x.dtype
        g = F.silu(torch.einsum("td,edh->teh", x, self.wg.to(dt)))
        u = torch.einsum("td,edh->teh", x, self.wu.to(dt))
        y = torch.einsum("teh,ehd->ted", g * u, self.wd.to(dt))
        E = self.cfg.num_experts
        mask = F.one_hot(ids, E).to(dt)                          # [T,K,E]
        comb = torch.einsum("tke,tk->te", mask, w)
        out = torch.einsum("ted,te->td", y, comb)
        return self._shared(out, x), load_balance_loss(probs, ids, E)
