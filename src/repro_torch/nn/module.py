"""Parameter counts of a module (counterparts of `repro/nn/module.py`'s
`param_count` / `param_bytes`, over an `nn.Module`'s parameters), and
the binding of a parameter tree to a module for the functional train
steps (JAX's `params` argument).

A train step takes its parameters as a flat dict {state_dict name:
tensor} and computes with them in place of the module's own
(`bound_params`), for the forward and the backward alike: a layer
rematerialised in the backward reads the bound tensors too, which
`torch.func.functional_call` (restored on return) would not give.
"""
from __future__ import annotations

from contextlib import contextmanager

from torch import nn


def param_count(module: nn.Module) -> int:
    """Total number of scalar parameters."""
    return sum(p.numel() for p in module.parameters())


def param_bytes(module: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def param_tree(module: nn.Module) -> dict:
    """{name: tensor}: the module's parameters, detached (no copy)."""
    return {name: p.detach() for name, p in module.named_parameters()}


def _slots(module: nn.Module, names):
    for name in names:
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner)
        if leaf not in mod._parameters:
            raise KeyError(f"{name!r} is not a parameter of the module")
        yield mod, leaf


@contextmanager
def bound_params(module: nn.Module, params: dict):
    """Within the block, each parameter named in `params` reads as the
    given tensor (autograd leaves, say); the module's own come back on
    exit."""
    slots = list(_slots(module, params))
    saved = [mod._parameters[leaf] for mod, leaf in slots]
    try:
        for (mod, leaf), t in zip(slots, params.values()):
            mod._parameters[leaf] = t
        yield module
    finally:
        for (mod, leaf), old in zip(slots, saved):
            mod._parameters[leaf] = old


def bind_params(module: nn.Module, params: dict) -> None:
    """Make the module hold `params` (no copy; the tensors it held are
    released): how a launcher keeps a model current after a train step."""
    for (mod, leaf), t in zip(list(_slots(module, params)),
                              params.values()):
        mod._parameters[leaf] = nn.Parameter(t.detach(), requires_grad=False)
