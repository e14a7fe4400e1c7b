"""ArchSpec: the contract between configs and the launchers.

Counterpart of `repro/configs/base.py`. An ArchSpec bundles:
  * build(device=None, seed=0):         the published config, verbatim,
    except where one card cannot hold it: the recsys family's build()
    cuts the two-tower user table to ONE_CARD_USER_VOCAB rows
    (configs/two_tower_retrieval.py), while its CONFIG keeps the
    published value
  * build_reduced(device=None, seed=0): a tiny model of the same family
  * shapes:        {shape_name: ShapeSpec}, the assigned input shapes
  * input_specs(model, shape) -> {name: (shape tuple, torch dtype)}
  * step(model, shape) -> the serve step callable

Families: "lm", "recsys" (two-tower-retrieval), "d3gnn". An LM's and a
two-tower's build and build_reduced run on CUDA unless given a device
(and raise without CUDA); GraphSAGE is moved to its device by D3Pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                     # "train" | "prefill" | "decode" | "serve"
    dims: Dict[str, int] = field(default_factory=dict)
    note: str = ""


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                   # "lm" | "recsys" | "d3gnn"
    build: Callable[..., Any]
    build_reduced: Callable[..., Any]
    shapes: Dict[str, ShapeSpec]
    input_specs: Callable[[Any, str], dict]     # (model, shape_name) -> specs
    step: Callable[[Any, str], Callable]        # (model, shape_name) -> fn
    notes: str = ""


# ----------------------------------------------------------- LM helpers
LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            {"seq": 32768, "batch": 128}),
    "long_500k": ShapeSpec(
        "long_500k", "decode", {"seq": 524288, "batch": 1},
        note="decode vs a 512k KV cache is O(S) per token, so it runs for "
             "full-attention archs too; a 500k prefill would be quadratic "
             "and is not an assigned shape."),
}


def lm_input_specs(model, shape_name: str) -> dict:
    c = model.cfg
    sh = LM_SHAPES[shape_name]
    B, S = sh.dims["batch"], sh.dims["seq"]
    if sh.kind == "train":
        return {"tokens": ((B, S), torch.int64),
                "labels": ((B, S), torch.int64)}
    if sh.kind == "prefill":
        return {"tokens": ((B, S), torch.int64)}
    # decode: one new token against an S-token cache
    cache_kv = ((c.n_groups, len(c.pattern), B, S, c.n_kv, c.head_dim),
                c.torch_dtype)
    return {"tokens": ((B, 1), torch.int64),
            "cache_k": cache_kv, "cache_v": cache_kv,
            "cache_len": ((B,), torch.int64)}


def lm_step(model, shape_name: str):
    """The prefill or decode step of `model` (a TransformerLM) for one of
    LM_SHAPES; the model's parameters are its own, not an argument."""
    kind = LM_SHAPES[shape_name].kind
    if kind == "train":
        raise NotImplementedError("the LM train step belongs to the "
                                  "training slice (ROADMAP Queue 1 item 10)")
    if kind == "prefill":
        @torch.no_grad()
        def prefill_step(tokens):
            x = model.hidden_states(tokens)
            # next-token logits only
            return (x[:, -1] @ model.lm_head.to(x.dtype)).float()

        return prefill_step

    def decode_step(tokens, cache_k, cache_v, cache_len, pos):
        """`pos` is the host count of tokens the cache holds (cache_len's
        value, known to the caller's loop), so a full cache is refused
        without reading cache_len back from the device."""
        cache = {"k": cache_k, "v": cache_v, "len": cache_len, "pos": pos}
        logits, new = model.decode_step(cache, tokens)
        return logits, new["k"], new["v"], new["len"]

    return decode_step
