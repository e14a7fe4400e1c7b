"""two-tower-retrieval [recsys]
embed_dim=256 tower_mlp=1024-512-256 interaction=dot — sampled-softmax
retrieval. [RecSys'19 (YouTube); unverified]

Counterpart of `repro/configs/two_tower_retrieval.py`. Embedding tables:
user 10^8 rows, item 10^7 rows x dim 256, f32. `CONFIG` is the published
config verbatim; `build()` cuts the user table to fit one card
(ONE_CARD_USER_VOCAB), and `build(train=True)` both tables, to leave room
for their gradients and Adam's moments (TRAIN_USER_VOCAB,
TRAIN_ITEM_VOCAB); on the `meta` device it builds CONFIG whole.
`input_specs` gives (shape, dtype) pairs without
allocating; `step` returns the train and serve steps.

Shapes:
  train_batch    batch=65,536  in-batch sampled softmax (+logQ correction)
  serve_p99      batch=512     online user-tower inference
  serve_bulk     batch=262,144 offline scoring (paired dot)
  retrieval_cand batch=1, n_candidates=1,000,000 — one batched matmul
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs.base import (ArchSpec, ShapeSpec, clipped_update,
                                      value_and_grad)
from repro_torch.optim import adam
from repro_torch.recsys.two_tower import TwoTower, TwoTowerConfig

# vocabs padded to multiples of 512 so the tables row-shard evenly on both
# production meshes (10^8 / 10^7 rows semantically)
CONFIG = TwoTowerConfig(embed_dim=256, tower_mlp=(1024, 512, 256),
                        user_vocab=100_000_256, item_vocab=10_000_384,
                        user_fields=4, item_fields=2, max_ids_per_field=8)

REDUCED = TwoTowerConfig(embed_dim=32, tower_mlp=(64, 32),
                         user_vocab=1000, item_vocab=1000,
                         user_fields=2, item_fields=2, max_ids_per_field=4)

# The published user table, 100,000,256 x 256 f32, is 102.4 GB; one H100
# holds 80 GB. build() keeps 50,000,384 rows (51.2 GB, still a multiple of
# 512): with the 10.24 GB item table that is 61.44 GB of tables, and the
# rest of the card holds retrieval_cand's item tower over 1,000,448
# candidates (2.05 GB of bags, [1M, 1024] f32 hidden layers of 4.1 GB).
# Widths, fields, ids per field, the item table and f32 stay as published.
ONE_CARD_USER_VOCAB = 50_000_384
# Training holds each table four times more (its dense gradient, the
# clipped gradient, Adam's m and v) and twice over at the update's peak
# (the new m, v and parameters beside the old), about 8 x the tables. The
# published tables alone are 112.6 GB; train_batch keeps 5,000,192 user
# and 500,224 item rows (multiples of 512, the published 10:1 ratio):
# 5.63 GB of tables, ~45 GB at the update's peak. Widths, fields, ids per
# field, the batch of 65,536, the temperature and f32 stay as published.
TRAIN_USER_VOCAB, TRAIN_ITEM_VOCAB = 5_000_192, 500_224

SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "serve",
                                {"batch": 1, "n_candidates": 1_000_000}),
}


def input_specs(model, shape_name: str) -> dict:
    c = model.cfg
    d = SHAPES[shape_name].dims
    B = d["batch"]
    u = ((B, c.user_fields, c.max_ids_per_field), torch.int32)
    i = ((B, c.item_fields, c.max_ids_per_field), torch.int32)
    if shape_name == "train_batch":
        return {"user_ids": u, "item_ids": i,
                "item_logq": ((B,), torch.float32)}
    if shape_name == "serve_p99":
        return {"user_ids": u}
    if shape_name == "serve_bulk":
        return {"user_ids": u, "item_ids": i}
    nc = -(-d["n_candidates"] // 512) * 512   # pad for even mesh sharding
    return {"user_ids": u,
            "cand_ids": ((nc, c.item_fields, c.max_ids_per_field),
                         torch.int32)}


def step(model, shape_name: str, optimizer=None):
    """The train or serve step of `model` (a TwoTower) for one of SHAPES:
    a callable of the batch dict. The serve steps use the model's own
    parameters; train_step(params, opt_state, batch) -> (params,
    opt_state, loss) takes them as an argument (JAX's `step`): the
    sampled-softmax loss's gradient, clipped to global norm 1, then
    `optimizer` (Adam unless given) at 1e-3."""
    if shape_name == "train_batch":
        opt = optimizer or adam()

        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(
                model, model.loss, params, batch["user_ids"],
                batch["item_ids"], batch["item_logq"])
            params, opt_state = clipped_update(opt, opt_state, grads,
                                               params, 1e-3)
            return params, opt_state, loss

        return train_step
    if shape_name == "serve_p99":
        return lambda batch: model.user_tower(batch["user_ids"])
    if shape_name == "serve_bulk":
        return lambda batch: model.score(batch["user_ids"],
                                         batch["item_ids"])
    return lambda batch: model.retrieval_scores(batch["user_ids"],
                                                batch["cand_ids"])


def build(device=None, seed: int = 0, train: bool = False) -> TwoTower:
    """The model at one card's cut of the tables (ONE_CARD_USER_VOCAB to
    serve; TRAIN_USER_VOCAB / TRAIN_ITEM_VOCAB to train), or, on the
    `meta` device, where nothing is allocated, the published CONFIG
    whole (the dry run's)."""
    if device is not None and torch.device(device).type == "meta":
        cfg = CONFIG
    elif train:
        cfg = replace(CONFIG, user_vocab=TRAIN_USER_VOCAB,
                      item_vocab=TRAIN_ITEM_VOCAB)
    else:
        cfg = replace(CONFIG, user_vocab=ONE_CARD_USER_VOCAB)
    return TwoTower(cfg, device, seed)


SPEC = ArchSpec(
    name="two-tower-retrieval", family="recsys",
    build=build,
    build_reduced=lambda device=None, seed=0, train=False: TwoTower(
        REDUCED, device, seed),
    shapes=SHAPES,
    input_specs=input_specs,
    step=step,
    batch_style="dict",
    notes="embedding lookup is the hot path; build() cuts the user table "
          "to 50,000,384 rows for one 80 GB card, build(train=True) the "
          "tables to 5,000,192 and 500,224 rows.")
