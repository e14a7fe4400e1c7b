"""ArchSpec: the contract between configs and the launchers.

Counterpart of `repro/configs/base.py`. An ArchSpec bundles:
  * build(device=None, seed=0, train=False): the published config,
    verbatim, except where one card cannot hold it: the recsys family's
    build() cuts the two-tower tables (ONE_CARD_USER_VOCAB rows to serve,
    TRAIN_USER_VOCAB / TRAIN_ITEM_VOCAB to train, in
    configs/two_tower_retrieval.py), while its CONFIG keeps the
    published values. `train=True` builds the model a train step takes
    (an LM then keeps f32 parameters, as the JAX package does)
  * build_reduced(device=None, seed=0, train=False): a tiny model of the
    same family
  * shapes:        {shape_name: ShapeSpec}, the assigned input shapes
  * input_specs(model, shape) -> {name: (shape tuple, torch dtype)}
  * step(model, shape) -> the train or serve step callable
  * optimizer:     "adam" | "adam8bit", what `make_optimizer` builds
  * tune_for_mesh(model, mesh) -> model, donate_inputs(shape) -> input
    names, batch_style "positional" | "dict": what the dry run
    (`launch/dryrun.py`) reads, as JAX's does

A train step is functional, as JAX's: train_step(params, opt_state,
...) -> (params, opt_state, loss), params a flat {state_dict name:
tensor} dict (`nn.module.param_tree(model)`) that the step binds to the
model for its forward and backward (`nn.module.bound_params`); the
gradient is `torch.autograd.grad` over those leaves.

Families: "lm", "recsys" (two-tower-retrieval), "gnn" (pna, gatedgcn,
dimenet, nequip), "d3gnn". An LM's, a two-tower's and a GNN's build and
build_reduced run on CUDA unless given a device (and raise without
CUDA); GraphSAGE is moved to its device by D3Pipeline. A GNN's build
and build_reduced take the shape name first, as the reference's do
(the input width and classes follow the shape): build(shape_name,
device=None, seed=0, train=False).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch

from repro_torch.nn.module import bound_params
from repro_torch.optim import apply_updates, clip_by_global_norm


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                     # "train" | "prefill" | "decode" | "serve"
    dims: Dict[str, int] = field(default_factory=dict)
    note: str = ""


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                   # "lm" | "recsys" | "gnn" | "d3gnn"
    build: Callable[..., Any]
    build_reduced: Callable[..., Any]
    shapes: Dict[str, ShapeSpec]
    input_specs: Callable[[Any, str], dict]     # (model, shape_name) -> specs
    step: Callable[[Any, str], Callable]        # (model, shape_name) -> fn
    notes: str = ""
    tune_for_mesh: Callable[[Any, Any], Any] = lambda model, mesh: model
    donate_inputs: Callable[[str], tuple] = lambda shape_name: ()
    batch_style: str = "positional"   # "positional" | "dict" (one batch arg)
    optimizer: str = "adam"           # "adam" | "adam8bit" (state-quantized)


def make_optimizer(name: str):
    if name == "adam8bit":
        from repro_torch.optim.quantized import adam8bit
        return adam8bit()
    from repro_torch.optim import adam
    return adam()


def value_and_grad(model, loss_fn, params: dict, *args):
    """(loss, {name: gradient}) of loss_fn(*args) with `params` bound to
    `model`: `torch.autograd.grad` over leaves that share the tensors'
    storage; a parameter the loss does not read gets zeros, as under
    `jax.grad`. The loss comes back detached."""
    leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
    with torch.enable_grad(), bound_params(model, leaves):
        loss = loss_fn(*args)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(leaves.items(), grads)}


def clipped_update(opt, opt_state, grads: dict, params: dict, lr: float):
    """clip_by_global_norm(1.0), the optimizer's update at `lr`, and
    params + updates, as the JAX train steps end. Consumes `grads` (the
    dict is emptied as soon as the clipped copy exists, to hold one
    gradient tree at a time). Returns (params, opt_state)."""
    clipped, _ = clip_by_global_norm(grads, 1.0)
    grads.clear()
    updates, opt_state = opt.update(opt_state, clipped, params, lr)
    del clipped
    return apply_updates(params, updates), opt_state


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


def lm_tune_for_mesh(model, mesh):
    """JAX's `lm_tune_for_mesh` sets the residual stream's activation
    spec, ((data axes), None, "model"), which only GSPMD reads: the port
    has no partitioner, so this records the spec on the model as
    `act_pspec` for the dry run's report and changes no computation."""
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    model.act_pspec = (dp, None, "model")
    return model


def lm_donate(shape_name: str) -> tuple:
    """Input names donated to outputs (decode caches alias in place)."""
    if LM_SHAPES[shape_name].kind == "decode":
        return ("cache_k", "cache_v")
    return ()


# microbatches a train_4k step sums (JAX's `lm_step` default)
GRAD_ACCUM = 8


def lm_step(model, shape_name: str, optimizer=None,
            grad_accum: int = GRAD_ACCUM, opt_name: str = "adam"):
    """The train, prefill or decode step of `model` (a TransformerLM) for
    one of LM_SHAPES. The serve steps use the model's own parameters;
    the train step takes them as an argument (JAX's `lm_step`) and
    updates them with `optimizer`, or else `make_optimizer(opt_name)`
    (the launcher passes `make_optimizer(spec.optimizer)`)."""
    sh = LM_SHAPES[shape_name]
    kind = sh.kind
    if kind == "train":
        opt = optimizer or make_optimizer(opt_name)
        B = sh.dims["batch"]
        k = grad_accum if B % grad_accum == 0 else 1

        def train_step(params, opt_state, tokens, labels):
            """tokens, labels [B, S] (the shape's batch; any batch k
            divides) -> (params, opt_state, mean loss): k microbatches,
            their f32 gradients summed, then / k, clipped to global norm
            1, the optimizer's update at 3e-4."""
            S = tokens.shape[1]
            tok_mb = tokens.reshape(k, -1, S)
            lab_mb = labels.reshape(k, -1, S)
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            for i in range(k):
                loss, g = value_and_grad(model, model.loss, params,
                                         tok_mb[i], lab_mb[i])
                for n, gi in g.items():
                    gsum[n].add_(gi)
                del g
                lsum = lsum + loss
            for s in gsum.values():
                s.div_(k)
            params, opt_state = clipped_update(opt, opt_state, gsum, params,
                                               3e-4)
            return params, opt_state, lsum / k

        return train_step
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
