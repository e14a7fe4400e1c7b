"""Two-tower retrieval (YouTube/RecSys'19): sampled softmax over in-batch
negatives with logQ correction, and the serve path.

Counterpart of `repro/recsys/two_tower.py`. Config: embed_dim 256, tower
MLP 1024-512-256, dot interaction. Each tower is a multi-field
EmbeddingBag (one kernel launch over all of a batch's fields), an MLP,
and an L2 normalisation.

Shapes (configs/two_tower_retrieval.py):
  train_batch   : batch=65,536 in-batch sampled-softmax training step
  serve_p99     : batch=512 online user-tower inference
  serve_bulk    : batch=262,144 offline scoring (paired dot)
  retrieval_cand: 1 query x 1,000,000 candidates, one batched matmul

Every parameter is drawn in f32 on the model's device from one
`torch.Generator` seeded with `seed`, so the full-width tables never exist
on the host. The serve towers run without a graph; `loss` runs them
under autograd (the bag lookups through `kernels/embedding_bag`'s
autograd.Function: kernel 4 forward, kernel 1 backward on the card).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.nn.layers import MLP
from repro_torch.recsys.embedding_bag import EmbeddingBag

# the in-batch logits [B, B] are taken LOSS_ROWS rows at a time (at most
# 2^28 f32 scores a block): at B = 65,536 a whole [B, B] f32 tensor is
# 17.2 GB, and autograd would keep three of them
LOSS_SCORES = 1 << 28


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
        gen = seeded_generator(self.device, seed)
        self.user_emb = EmbeddingBag(c.user_vocab, c.embed_dim,
                                     device=self.device, generator=gen)
        self.item_emb = EmbeddingBag(c.item_vocab, c.embed_dim,
                                     device=self.device, generator=gen)
        self.user_mlp = MLP((c.embed_dim * c.user_fields,) + tuple(
            c.tower_mlp), device=self.device, generator=gen)
        self.item_mlp = MLP((c.embed_dim * c.item_fields,) + tuple(
            c.tower_mlp), device=self.device, generator=gen)

    def _tower(self, bag, mlp, ids):
        return l2_normalize(mlp(embedding_fields(bag, ids.to(self.device))))

    @torch.no_grad()
    def user_tower(self, user_ids):
        """user_ids [B, fields, max_ids] -> normalised [B, d]."""
        return self._tower(self.user_emb, self.user_mlp, user_ids)

    @torch.no_grad()
    def item_tower(self, item_ids):
        return self._tower(self.item_emb, self.item_mlp, item_ids)

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

    def loss(self, user_ids, item_ids, item_logq=None):
        """In-batch sampled softmax with logQ correction, differentiable.

        user_ids [B, uf, w]; item_ids [B, if, w]; item_logq [B] the items'
        sampling log-probabilities (frequency correction), optional.
        Row i's logits are u_i . v_j / temperature - logq_j over the
        batch's items j, its label j = i; the loss is the mean NLL. The
        logits are taken in blocks of rows, each checkpointed (recomputed
        in the backward), so at most one [rows, B] block and its softmax
        live at a time."""
        u = self._tower(self.user_emb, self.user_mlp, user_ids)
        v = self._tower(self.item_emb, self.item_mlp, item_ids)
        logq = None if item_logq is None else item_logq.to(self.device)
        B = u.shape[0]
        rows = max(1, LOSS_SCORES // max(B, 1))
        nll = torch.zeros((), dtype=torch.float32, device=self.device)
        for r0 in range(0, B, rows):
            nll = nll + checkpoint(_block_nll, u[r0:r0 + rows], v, logq,
                                   r0, self.cfg.temperature,
                                   use_reentrant=False)
        return nll / B


def _block_nll(u, v, logq, r0: int, temperature: float):
    """Sum over rows r0 + i of -log_softmax(logits)[i, r0 + i]."""
    logits = (u @ v.T).float() / temperature
    if logq is not None:
        logits = logits - logq[None, :]
    logp = torch.log_softmax(logits, dim=-1)
    diag = torch.arange(u.shape[0], device=u.device)
    return -logp[diag, r0 + diag].sum()


def embedding_fields(bag: EmbeddingBag, ids):
    """ids [B, fields, max_ids] -> concat of per-field bags [B, fields*d]."""
    B, F, W = ids.shape
    e = bag(ids.reshape(B * F, W))
    return e.reshape(B, F * bag.dim)


def l2_normalize(x, eps: float = 1e-6):
    n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps).to(x.dtype)
