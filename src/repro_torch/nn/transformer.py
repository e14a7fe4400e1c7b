"""Decoder-only transformer (dense + MoE): prefill, KV-cache decode and
the training loss.

Counterpart of `repro/nn/transformer.py`. The JAX model scans over stacked
layer groups; here the layers are an `nn.ModuleList` run in a Python loop
(`convert.lm_params_from_numpy` splits JAX's stacked groups into layers).
Every parameter is drawn in f32 on the model's device from one
`torch.Generator` seeded with `seed`, tensor by tensor. A serving model
stores it in `cfg.dtype`, so a full-width model never exists in f32 or
on the host; a model built for training (`train=True`) keeps the f32
parameters, as the JAX package holds them, and every layer casts at use.

Ported: prefill (`hidden_states`, `logits`), decode (`init_cache`,
`decode_step`) and `loss` (the chunked, rematerialised next-token CE,
plus 0.01 x the MoE layers' summed load-balance loss when `cfg.moe` is
set); with `cfg.remat` each layer is checkpointed under grad (JAX's
`jax.checkpoint` of a group). A group of `cfg.pattern` holds dense
blocks and, with `cfg.moe`, one MoE block last (`nn/moe.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.nn.attention import GQAAttention
from repro_torch.nn.layers import Embedding, RMSNorm, SwiGLU, init_param, lecun
from repro_torch.nn.moe import MoEConfig, MoELayer


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    moe: Optional[MoEConfig] = None
    rope_theta: float = 500000.0
    dtype: str = "bfloat16"
    loss_chunks: int = 8          # sequence chunks for the CE loss head
    remat: bool = True            # checkpoint each layer under grad
    q_chunk: int = 256            # chunked-attention block when training

    @property
    def pattern(self) -> tuple:
        """Block pattern within one layer group (JAX's scan unit)."""
        if self.moe is None:
            return ("dense",)
        every = self.moe.every
        return tuple(["dense"] * (every - 1) + ["moe"])

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class Block(nn.Module):
    """Pre-norm block: x += attn(norm(x)); x += ffn(norm(x)). kind "moe"
    runs the FFN as an MoELayer over the [B * S, d] tokens."""

    def __init__(self, cfg: TransformerConfig, kind: str, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kind not in ("dense", "moe"):
            raise ValueError(f"block kind {kind!r}: dense or moe")
        self.kind = kind
        c, dt = cfg, dtype or cfg.torch_dtype
        self.norm1 = RMSNorm(c.d_model, dtype=dt, device=device)
        self.attn = GQAAttention(c.d_model, c.n_heads, c.n_kv, c.head_dim,
                                 c.rope_theta, dtype=dt, device=device,
                                 generator=generator, q_chunk=c.q_chunk)
        self.norm2 = RMSNorm(c.d_model, dtype=dt, device=device)
        self.ffn = MoELayer(c.d_model, c.moe, dtype=dt, device=device,
                            generator=generator) if kind == "moe" else \
            SwiGLU(c.d_model, c.d_ff, dtype=dt, device=device,
                   generator=generator)

    def _ffn(self, h):
        """(ffn(h), aux): an MoE block's over the flattened tokens, a
        dense block's with aux None (no aux loss)."""
        if self.kind == "dense":
            return self.ffn(h), None
        B, S, d = h.shape
        y, aux = self.ffn(h.reshape(B * S, d))
        return y.reshape(B, S, d), aux

    def forward(self, x, positions):
        """-> (x, aux: None for a dense block)."""
        x = x + self.attn(self.norm1(x), positions)
        h, aux = self._ffn(self.norm2(x))
        return x + h, aux

    def decode(self, x, ck, cv, cache_len):
        h, ck, cv = self.attn.decode(self.norm1(x), ck, cv, cache_len)
        x = x + h
        return x + self._ffn(self.norm2(x))[0], ck, cv


class TransformerLM(nn.Module):
    """`device=None` is CUDA (raises without it); pass "cpu" for the CPU.
    `train=True` stores the parameters in f32 (the JAX package's
    discipline), else in cfg.dtype; the values drawn are the same."""

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0,
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = seeded_generator(self.device, seed)
        dt = torch.float32 if train else cfg.torch_dtype
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=dt,
                               device=self.device, generator=gen)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.pattern[i % len(cfg.pattern)], self.device, gen,
                  dt)
            for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype=dt, device=self.device)
        self.lm_head = init_param((cfg.d_model, cfg.vocab), lecun, dt,
                                  self.device, gen)

    # ---- forward ----
    def _hidden(self, tokens):
        """tokens [B,S] -> (final hidden [B,S,d] in cfg.dtype, the blocks'
        aux losses summed, f32): JAX's `hidden_states`. Under grad each
        block is checkpointed when cfg.remat (nothing saved but its
        input, as JAX's nothing_saveable policy)."""
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        x = self.embed(tokens.to(self.device)).to(self.cfg.torch_dtype)
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for blk in self.blocks:
            x, a = checkpoint(blk, x, positions, use_reentrant=False) \
                if remat else blk(x, positions)
            if a is not None:
                aux = aux + a
        return self.final_norm(x), aux

    @torch.no_grad()
    def hidden_states(self, tokens):
        """tokens [B,S] -> final hidden [B,S,d] (after the final norm)."""
        return self._hidden(tokens)[0]

    def loss(self, tokens, labels):
        """Mean next-token CE (labels = tokens shifted by the caller; -100
        = padding), differentiable. Counterpart of JAX's `loss`: the
        hidden states in cfg.loss_chunks sequence chunks (fewer where S
        does not divide), each chunk's logits and CE recomputed in the
        backward (checkpointed), so no [tokens, vocab] logits tensor ever
        lives whole; the CE sums and valid counts add up in f32. An MoE
        model adds 0.01 x the summed load-balance loss (JAX's `loss`)."""
        x, aux = self._hidden(tokens)
        labels = labels.to(self.device)
        B, S, d = x.shape
        n_chunks = min(self.cfg.loss_chunks, S)
        while S % n_chunks:
            n_chunks -= 1
        c = S // n_chunks
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(n_chunks):
            ce, n = checkpoint(_chunk_ce, x[:, i * c:(i + 1) * c],
                               labels[:, i * c:(i + 1) * c], self.lm_head,
                               use_reentrant=False)
            tot, cnt = tot + ce, cnt + n
        loss = tot / torch.clamp(cnt, min=1)
        return loss + 0.01 * aux if self.cfg.moe is not None else loss

    @torch.no_grad()
    def logits(self, tokens):
        x = self.hidden_states(tokens)
        return (x @ self.lm_head.to(x.dtype)).float()

    # ---- decode ----
    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """JAX's cache layout: k/v [n_groups, blocks per group, B, T, Kh,
        D] and the per-row length; "pos" is the same length as a host
        integer (every row advances one a step), which lets `decode_step`
        refuse a write past the end without reading "len" back."""
        c = self.cfg
        shape = (c.n_groups, len(c.pattern), batch, max_len, c.n_kv,
                 c.head_dim)
        dtype = dtype or c.torch_dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "len": torch.zeros(batch, dtype=torch.int64,
                                   device=self.device),
                "pos": 0}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens):
        """tokens [B,1] -> (logits [B,1,vocab] f32, cache). The new k/v are
        written into cache["k"]/cache["v"] in place; "len" is a new
        tensor.

        A full cache raises ValueError before anything is written: the
        check reads the host position cache["pos"], never "len", so it
        costs no host sync; a cache without "pos" is refused, since its
        position is unknown. The JAX model instead overwrites the last
        row (its dynamic_update_slice clamps the start index) and attends
        over a wrong cache."""
        pos, max_len = cache.get("pos"), cache["k"].shape[3]
        if pos is None:
            raise ValueError(
                "decode_step: the cache has no host position \"pos\", so a "
                f"write past max_len={max_len} cannot be refused; build it "
                "with init_cache(batch, max_len) or set \"pos\" to the "
                "number of tokens it holds")
        if pos >= max_len:
            raise ValueError(
                f"decode_step: the cache is full ({pos} tokens written, "
                f"max_len={max_len}); build it with init_cache(batch, "
                "max_len) for at least as many tokens as will be decoded")
        x = self.embed(tokens.to(self.device)).to(self.cfg.torch_dtype)
        n_b = len(self.cfg.pattern)
        for i, blk in enumerate(self.blocks):
            g, j = divmod(i, n_b)
            x, _, _ = blk.decode(x, cache["k"][g, j], cache["v"][g, j],
                                 cache["len"])
        x = self.final_norm(x)
        logits = (x @ self.lm_head.to(x.dtype)).float()
        return logits, {"k": cache["k"], "v": cache["v"],
                        "len": cache["len"] + 1,
                        "pos": pos + 1}


def _chunk_ce(x, labels, head):
    """(sum of CE over the valid labels, their count) of one chunk:
    logits in f32 from x @ head in x's dtype."""
    logits = (x @ head.to(x.dtype)).float()
    valid = labels >= 0
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    ce = torch.where(valid, torch.logsumexp(logits, dim=-1) - gold, 0.0)
    return ce.sum(), valid.sum()
