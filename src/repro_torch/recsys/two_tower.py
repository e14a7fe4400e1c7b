"""Two-tower retrieval (YouTube/RecSys'19): the serve path.

Counterpart of `repro/recsys/two_tower.py`. Config: embed_dim 256, tower
MLP 1024-512-256, dot interaction. Each tower is a multi-field
EmbeddingBag (one kernel launch over all of a batch's fields), an MLP,
and an L2 normalisation.

Shapes (configs/two_tower_retrieval.py):
  serve_p99     : batch=512 online user-tower inference
  serve_bulk    : batch=262,144 offline scoring (paired dot)
  retrieval_cand: 1 query x 1,000,000 candidates, one batched matmul

Every parameter is drawn in f32 on the model's device from one
`torch.Generator` seeded with `seed`, so the full-width tables never exist
on the host. Ported: the towers and the scores. `loss` (in-batch sampled
softmax) and the train step belong to the training slice (ROADMAP Queue 1
item 10).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.nn.layers import MLP
from repro_torch.recsys.embedding_bag import EmbeddingBag


@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: tuple = (1024, 512, 256)
    user_vocab: int = 10_000_000
    item_vocab: int = 10_000_000
    user_fields: int = 4            # multi-hot feature fields per user
    item_fields: int = 2
    max_ids_per_field: int = 8      # padded multi-hot width
    temperature: float = 0.05


class TwoTower(nn.Module):
    """`device=None` is CUDA (raises without it); pass "cpu" for the CPU.
    Parameter names follow the JAX pytree: user_emb.table,
    user_mlp.layers.<i>.{w, b}, and the same for the item side."""

    def __init__(self, cfg: TwoTowerConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = c = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.user_emb = EmbeddingBag(c.user_vocab, c.embed_dim,
                                     device=self.device, generator=gen)
        self.item_emb = EmbeddingBag(c.item_vocab, c.embed_dim,
                                     device=self.device, generator=gen)
        self.user_mlp = MLP((c.embed_dim * c.user_fields,) + tuple(
            c.tower_mlp), device=self.device, generator=gen)
        self.item_mlp = MLP((c.embed_dim * c.item_fields,) + tuple(
            c.tower_mlp), device=self.device, generator=gen)

    @torch.no_grad()
    def user_tower(self, user_ids):
        """user_ids [B, fields, max_ids] -> normalised [B, d]."""
        e = embedding_fields(self.user_emb, user_ids.to(self.device))
        return l2_normalize(self.user_mlp(e))

    @torch.no_grad()
    def item_tower(self, item_ids):
        e = embedding_fields(self.item_emb, item_ids.to(self.device))
        return l2_normalize(self.item_mlp(e))

    def score(self, user_ids, item_ids):
        """Dot-product scores [B] for paired users/items."""
        u = self.user_tower(user_ids)
        v = self.item_tower(item_ids)
        return (u * v).sum(dim=-1) / self.cfg.temperature

    def retrieval_scores(self, user_ids, cand_item_ids):
        """Few queries vs many candidates: [Bq, Nc], one batched matmul."""
        u = self.user_tower(user_ids)                  # [Bq, d]
        v = self.item_tower(cand_item_ids)             # [Nc, d]
        return (u @ v.T) / self.cfg.temperature


def embedding_fields(bag: EmbeddingBag, ids):
    """ids [B, fields, max_ids] -> concat of per-field bags [B, fields*d]."""
    B, F, W = ids.shape
    e = bag(ids.reshape(B * F, W))
    return e.reshape(B, F * bag.dim)


def l2_normalize(x, eps: float = 1e-6):
    n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps).to(x.dtype)
