"""Grouped-query attention with RoPE and KV-cache decode.

Counterpart of `repro/nn/attention.py`. Prefill attention (grad mode
off) goes through `kernels/flash_attention`: on a CUDA tensor that is the
hand-written kernel (the port's counterpart of both `use_flash=True` and
the `q_chunk` path, which compute the same function), on a CPU tensor
its plain version. With grad mode on, attention is JAX's training route:
`mha_chunked` at `q_chunk` when S > q_chunk > 0, else `mha` under the
causal mask (the kernel has no backward). Decode attends one new token against the cache in plain PyTorch, as the
JAX package leaves it to XLA; so does the sequence-sharded decode
(`decode_attend_partial` on each shard of the cache, then
`combine_partial_decodes`, the flash-decoding log-sum-exp merge).

The plain causal paths (`mha_chunked`, and `mha` under the causal mask
in `GQAAttention.forward`) compute every (query, key) pair and note
their operands (`repro_torch.work.note`), so that an operation counter
charges the masked pairs' products as masked work, as the kernel
charges none.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import work
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.nn.layers import init_param, lecun
from repro_torch.nn.rotary import apply_rope

NEG_INF = -1e30


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask; True = attend."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def mha(q, k, v, mask=None, scale=None):
    """Reference attention. q: [B,S,H,D]; k/v: [B,T,Kh,D] with H % Kh == 0.
    Scores are taken in the input dtype and softmaxed in f32, as JAX's
    `mha` does."""
    B, S, H, D = q.shape
    Kh = k.shape[2]
    G = H // Kh
    scale = scale if scale is not None else 1.0 / D ** 0.5
    qg = q.reshape(B, S, Kh, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if mask is not None:
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, S, H, D)


def mha_chunked(q, k, v, q_chunk: int = 256, causal: bool = True,
                q_offset: int = 0):
    """Query-chunked attention: a loop over q blocks, each with a full
    softmax over the keys, so the scores live [B, Kh, G, q_chunk, T] at a
    time instead of [B, Kh, G, S, T]. Counterpart of JAX's `mha_chunked`
    (a scan over the same blocks, the same f32 scores and masking).

    q [B,S,H,D]; k/v [B,T,Kh,D]; S a multiple of q_chunk. -> [B,S,H,D]."""
    B, S, H, D = q.shape
    T, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    nq = S // q_chunk
    if nq * q_chunk != S:
        raise ValueError(f"mha_chunked: S = {S} is not a multiple of "
                         f"q_chunk = {q_chunk}")
    scale = 1.0 / D ** 0.5
    qs = q.reshape(B, nq, q_chunk, Kh, G, D)
    kv_pos = torch.arange(T, device=q.device)[None, :]
    outs = []
    for i in range(nq):
        logits = torch.einsum("bqkgd,btkd->bkgqt", qs[:, i], k).float()
        logits = logits * scale
        if causal:
            q_pos = (i * q_chunk + q_offset + torch.arange(
                q_chunk, device=q.device))[:, None]
            logits = torch.where(kv_pos <= q_pos, logits, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", w, v))
    out = torch.cat(outs, dim=1).reshape(B, S, H, D)
    if causal:
        work.note("masked_attention", q=q, k=k, v=v, out=out,
                  q_offset=q_offset)
    return out


def decode_attend(q, cache_k, cache_v, valid):
    """Attend q [B,1,H,D] over cache [B,T,Kh,D] with validity mask [B,T]."""
    B, _, H, D = q.shape
    Kh = cache_k.shape[2]
    G = H // Kh
    qg = q.reshape(B, Kh, G, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, cache_k).float()
    logits = logits / D ** 0.5
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(cache_v.dtype)
    return torch.einsum("bkgt,btkd->bkgd", w, cache_v).reshape(B, 1, H, D)


def decode_attend_partial(q, cache_k, cache_v, valid):
    """Partial decode attention over one sequence shard of the cache.

    Returns (unnormalized out [B,1,H,D] f32, the shard's running max and
    sum of exponentials, each [B,1,H,1]) so shards combine with a global
    log-sum-exp reduction (`combine_partial_decodes`)."""
    B, _, H, D = q.shape
    Kh = cache_k.shape[2]
    G = H // Kh
    qg = q.reshape(B, Kh, G, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, cache_k).float()
    logits = logits / D ** 0.5
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)                       # [B,Kh,G,1]
    m_safe = torch.clamp(m, min=NEG_INF / 2)   # a fully masked shard
    p = torch.exp(logits - m_safe)
    s = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p, cache_v.float())
    return (out.reshape(B, 1, H, D), m_safe.reshape(B, 1, H, 1),
            s.reshape(B, 1, H, 1))


def combine_partial_decodes(outs, ms, ss):
    """Combine per-shard partial attention, stacked on a leading shard
    axis: rescale each shard's sums to the global max and normalize."""
    m_all = ms.amax(dim=0)                                      # [B,1,H,1]
    corr = torch.exp(ms - m_all)
    s_all = (ss * corr).sum(dim=0)
    o_all = (outs * corr).sum(dim=0)
    return o_all / torch.clamp(s_all, min=1e-30)


class GQAAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 rope_theta: float = 10000.0, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None,
                 q_chunk: int = 0):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.rope_theta, self.q_chunk = rope_theta, q_chunk
        hd, kd = n_heads * head_dim, n_kv * head_dim
        self.wq = init_param((d_model, hd), lecun, dtype, device, generator)
        self.wk = init_param((d_model, kd), lecun, dtype, device, generator)
        self.wv = init_param((d_model, kd), lecun, dtype, device, generator)
        self.wo = init_param((hd, d_model), lecun, dtype, device, generator)

    def _qkv(self, x, positions):
        B, S, _ = x.shape
        q = (x @ self.wq.to(x.dtype)).reshape(B, S, self.n_heads,
                                              self.head_dim)
        k = (x @ self.wk.to(x.dtype)).reshape(B, S, self.n_kv, self.head_dim)
        v = (x @ self.wv.to(x.dtype)).reshape(B, S, self.n_kv, self.head_dim)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(k, positions, self.rope_theta)
        return q, k, v

    def forward(self, x, positions=None):
        """Full causal self-attention. x: [B,S,d_model]. A call that
        differentiates (grad mode on and q, k or v requiring grad, the
        flash kernel's own refusal test) takes JAX's training route
        (`mha_chunked`, or `mha` when S <= q_chunk); every other call
        the flash kernel (prefill)."""
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        q, k, v = self._qkv(x, positions)
        if not (torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad)):
            out = flash_attention(q, k, v, causal=True)
        elif self.q_chunk and S > self.q_chunk:
            out = mha_chunked(q, k, v, q_chunk=self.q_chunk, causal=True)
        else:
            out = mha(q, k, v, mask=causal_mask(S, S, device=x.device))
            work.note("masked_attention", q=q, k=k, v=v, out=out)
        return out.reshape(B, S, -1) @ self.wo.to(x.dtype)

    def decode(self, x, cache_k, cache_v, cache_len):
        """One-token decode. x: [B,1,d]; cache_k/v: [B,T,Kh,D]; cache_len:
        [B] int64 on x's device. Writes the new k/v at cache_len IN PLACE
        (the JAX package returns updated copies) and returns
        (out [B,1,d], cache_k, cache_v)."""
        B, S, _ = x.shape
        if S != 1:
            raise ValueError(f"decode takes one token per row, got {S}")
        q, k, v = self._qkv(x, cache_len[:, None])
        rows = torch.arange(B, device=x.device)
        cache_k[rows, cache_len] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, cache_len] = v[:, 0].to(cache_v.dtype)
        valid = torch.arange(cache_k.shape[1],
                             device=x.device)[None, :] <= cache_len[:, None]
        out = decode_attend(q, cache_k, cache_v, valid).reshape(B, 1, -1)
        return out @ self.wo.to(x.dtype), cache_k, cache_v
