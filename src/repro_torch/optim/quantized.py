"""8-bit-state Adam: blockwise-quantized m and v (counterpart of
`repro/optim/quantized.py`).

The int8 codes keep the parameter's shape (blocks run along the last
dim), so a stacked per-part state quantizes each part's rows on their own,
as JAX's vmap does. m is symmetric int8; v is stored in sqrt-space.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.optimizers import (Optimizer, _f32, _lead,
                                          tree_leaves, tree_map)

BLOCK = 256


def _block_len(last_dim: int) -> int:
    """256 when it divides the last dim, else one block per row."""
    return BLOCK if last_dim % BLOCK == 0 else last_dim


def quantize_blockwise(x):
    """x [..., L] -> (int8 codes [..., L], scales [..., L / block])."""
    xb = x.reshape(tuple(x.shape[:-1]) + (-1,)) if x.ndim else x.reshape(1)
    blk = _block_len(xb.shape[-1])
    blocks = xb.reshape(tuple(xb.shape[:-1]) + (xb.shape[-1] // blk, blk))
    amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def dequantize_blockwise(q, scale):
    blk = _block_len(q.shape[-1] if q.ndim else 1)
    qb = q.reshape(tuple(q.shape[:-1]) + (q.shape[-1] // blk, blk))
    out = qb.to(torch.float32) * scale[..., None]
    return out.reshape(q.shape)


class QState(NamedTuple):
    q: torch.Tensor          # int8, the parameter's shape
    scale: torch.Tensor      # f32 [..., last / block]


def adam8bit(b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8) -> Optimizer:
    def init(params):
        def z(p):
            last = p.shape[-1] if p.ndim else 1
            sshape = (tuple(p.shape[:-1]) + (max(1, last // _block_len(last)),)
                      if p.ndim else (1,))
            fill = lambda: torch.full(sshape, 1e-12, device=p.device)
            zq = lambda: torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device)
            return {"m": QState(zq(), fill()), "v": QState(zq(), fill())}

        dev = tree_leaves(params)[0].device
        return {"per_param": tree_map(z, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(state, grads, params, lr):
        g = _f32(grads)
        t = state["t"] + 1
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def upd(gi, pi, s):
            m = dequantize_blockwise(s["m"].q, s["m"].scale)
            u = dequantize_blockwise(s["v"].q, s["v"].scale)
            v = u * u
            m = b1 * m + (1 - b1) * gi
            v = b2 * v + (1 - b2) * gi * gi
            step = (-lr * (m / _lead(bc1, m))
                    / (torch.sqrt(v / _lead(bc2, v)) + eps)).to(pi.dtype)
            mq, ms = quantize_blockwise(m)
            vq, vs = quantize_blockwise(torch.sqrt(v))
            return step, {"m": QState(mq, ms), "v": QState(vq, vs)}

        # the param tree's structure: a leaf's state (a dict of QStates)
        # and its (step, state) result are taken whole
        outs = tree_map(upd, g, params, state["per_param"])
        steps = tree_map(lambda _, o: o[0], g, outs)
        new_s = tree_map(lambda _, o: o[1], g, outs)
        return steps, {"per_param": new_s, "t": t}

    return Optimizer(init, update)
