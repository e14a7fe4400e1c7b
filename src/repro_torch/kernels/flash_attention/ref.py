"""Plain PyTorch version of the flash-attention kernel.

The wrapper in `ops.py` runs it for CPU tensors; `chip_smoke.py` holds the
CUDA kernel against it on the card. It computes what the Pallas kernel
(`repro/kernels/flash_attention/kernel.py`) computes, in one pass over each
query chunk instead of an online softmax over kv blocks: f32 scores, masked
to -1e30, p = exp(s - max) cast to v's type before p @ v (kernel.py:61),
and acc / max(sum p, 1e-30) in q's type. Its products run over every
(query, key) pair; a causal call notes its operands
(`repro_torch.work.note`) so that an operation counter charges the
masked pairs' products as masked work.
"""
from __future__ import annotations

import torch

from repro_torch import work

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True, q_chunk: int = 256):
    """q [B,S,H,D]; k/v [B,T,Kh,D] with H % Kh == 0 -> [B,S,H,D] in q.dtype.

    Loops over chunks of `q_chunk` queries (like nn/attention.py's
    chunked path), so the f32 scores of one chunk, [B, H, q_chunk, T], are
    the largest temporary."""
    B, S, H, D = q.shape
    T, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = 1.0 / D ** 0.5
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(T, device=q.device)
    out = torch.empty_like(q)
    for s0 in range(0, S, q_chunk):
        c = min(q_chunk, S - s0)
        qc = q[:, s0:s0 + c].float().reshape(B, c, Kh, G, D)
        s = torch.einsum("bqkgd,btkd->bkgqt", qc, kf) * scale
        if causal:
            q_pos = s0 + torch.arange(c, device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(), vf)
        out[:, s0:s0 + c] = (acc / denom).permute(0, 3, 1, 2, 4).reshape(
            B, c, H, D).to(q.dtype)
    if causal:
        work.note("masked_attention", q=q, k=k, v=v, out=out)
    return out
