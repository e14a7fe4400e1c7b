"""two-tower-retrieval [recsys]
embed_dim=256 tower_mlp=1024-512-256 interaction=dot — sampled-softmax
retrieval. [RecSys'19 (YouTube); unverified]

Counterpart of `repro/configs/two_tower_retrieval.py`. Embedding tables:
user 10^8 rows, item 10^7 rows x dim 256, f32. `CONFIG` is the published
config verbatim; `build()` cuts the user table to fit one card
(ONE_CARD_USER_VOCAB). `input_specs` gives (shape, dtype) pairs without
allocating; `step` returns the serve steps (the train step belongs to the
training slice).

Shapes:
  train_batch    batch=65,536  in-batch sampled softmax (+logQ correction)
  serve_p99      batch=512     online user-tower inference
  serve_bulk     batch=262,144 offline scoring (paired dot)
  retrieval_cand batch=1, n_candidates=1,000,000 — one batched matmul
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
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


def step(model, shape_name: str):
    """The serve step of `model` (a TwoTower) for one of SHAPES: a
    callable of the batch dict; the model's parameters are its own."""
    if shape_name == "train_batch":
        raise NotImplementedError("the two-tower train step belongs to the "
                                  "training slice (ROADMAP Queue 1 item 10)")
    if shape_name == "serve_p99":
        return lambda batch: model.user_tower(batch["user_ids"])
    if shape_name == "serve_bulk":
        return lambda batch: model.score(batch["user_ids"],
                                         batch["item_ids"])
    return lambda batch: model.retrieval_scores(batch["user_ids"],
                                                batch["cand_ids"])


SPEC = ArchSpec(
    name="two-tower-retrieval", family="recsys",
    build=lambda device=None, seed=0: TwoTower(
        replace(CONFIG, user_vocab=ONE_CARD_USER_VOCAB), device, seed),
    build_reduced=lambda device=None, seed=0: TwoTower(REDUCED, device, seed),
    shapes=SHAPES,
    input_specs=input_specs,
    step=step,
    notes="embedding lookup is the hot path; build() cuts the user table "
          "to 50,000,384 rows for one 80 GB card.")
