"""Explicit expert parallelism: the all_to_all dispatch over a StreamMesh.

Counterpart of `repro/dist/moe_ep.py`. Each rank groups its (token,
expert) pairs by the rank that holds the expert, exchanges the packed
slots (`StreamMesh.exchange`, a tiled all_to_all), runs its LOCAL
experts, and exchanges the results back: wire bytes are 2 x routed
tokens x d, where an all-gather of the token buffer would move every
token to every rank.

`moe_ep_apply` is the per-rank body (JAX's runs inside shard_map; here
one process a rank calls it) with
  x       : [T_loc, d]   this rank's tokens (every rank the same T_loc)
  router  : replicated
  wg/wu/wd: [E_loc, d, h] / [E_loc, h, d] this rank's expert slab, the
            experts [rank * E_loc, (rank + 1) * E_loc)
as `nn/moe.py:MoELayer._ep_call` calls it. It is differentiable: the
exchange's backward is the same exchange of the cotangent.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.moe import (capacity, combine_rows, pack_rows, route,
                                segment_positions)


def moe_ep_apply(layer, params: dict, x, mesh):
    """Per-rank MoE forward with expert-parallel dispatch over `mesh`.
    params: "router" and this rank's "wg" / "wu" / "wd" slab; the shared
    experts are the layer's own. Equals `layer.dense_oracle` whenever the
    capacity is ample (nothing dropped)."""
    cfg = layer.cfg
    S = mesh.size
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    if E % S:
        raise ValueError(f"experts {E} not divisible by {S} ranks")
    E_loc = E // S
    if params["wg"].shape[0] != E_loc:
        raise ValueError(f"the expert slab holds {params['wg'].shape[0]} "
                         f"experts; {S} ranks hold {E_loc} each")

    ids, w, _ = route(params["router"], x, K)        # router replicated
    e_flat = ids.reshape(-1)                         # [T*K]
    dest = e_flat // E_loc                           # destination rank
    # pack (token, expert) pairs into per-destination slots
    order = torch.argsort(dest, stable=True)
    dest_s, e_s = dest[order], e_flat[order]
    tok_s = torch.arange(T, device=x.device).repeat_interleave(K)[order]
    w_s = w.reshape(-1)[order]
    C = capacity(T, K, cfg.capacity_factor, S, E)
    pos = segment_positions(dest_s, S)
    keep = pos < C
    slot = torch.where(keep, dest_s * C + pos, S * C)  # S*C = trash row

    send_x = pack_rows(x, tok_s, keep, slot, S * C)
    send_e = torch.full((S * C + 1,), E_loc, dtype=torch.int64,
                        device=x.device).index_copy_(
        0, slot, torch.where(keep, e_s % E_loc, E_loc))[:S * C]
    recv_x = mesh.exchange(send_x)                   # tokens for my experts
    recv_e = mesh.exchange(send_e)                   # local id (E_loc: pad)

    # local experts: a masked dense sweep, as JAX's static shapes run it
    dt = x.dtype
    y = torch.zeros_like(recv_x)
    for e in range(E_loc):
        g = F.silu(recv_x @ params["wg"][e].to(dt))
        u = recv_x @ params["wu"][e].to(dt)
        ye = (g * u) @ params["wd"][e].to(dt)
        y = torch.where((recv_e == e)[:, None], ye, y)

    back = mesh.exchange(y)                          # in send-slot order
    out = combine_rows(back, tok_s, keep, slot, w_s, x)
    return layer._shared(out, x)
