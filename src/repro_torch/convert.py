"""Parameter conversion from the JAX package's pytree.

Torch cannot reproduce `jax.random`, so the parity tests initialise a
model with the JAX `GraphSAGE.init`, convert the pytree to numpy, and load
it here; both packages then compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree: dict) -> dict:
    """JAX `GraphSAGE.init` pytree (leaves already numpy arrays) -> a
    `state_dict` for `repro_torch.graph.sage.GraphSAGE`.

    {"l0": {"self": {"w", "b"}, "neigh": {"w"}}, ...} maps to
    "layers.0.w_self.w", "layers.0.w_self.b", "layers.0.w_neigh.w", ...
    Weights keep JAX's [in, out] layout (nn/layers.py), so nothing is
    transposed."""
    out = {}
    for key, layer in tree.items():
        if not key.startswith("l"):
            raise NotImplementedError(
                f"parameter group {key!r}: only SAGE layer groups l<i> are "
                "ported (the output head belongs to the training plane, "
                "ROADMAP Queue 1 item 10)")
        i = int(key[1:])
        for jax_name, port_name in (("self", "w_self"), ("neigh", "w_neigh")):
            for leaf, arr in layer[jax_name].items():
                out[f"layers.{i}.{port_name}.{leaf}"] = torch.tensor(
                    np.asarray(arr, np.float32))
    return out
