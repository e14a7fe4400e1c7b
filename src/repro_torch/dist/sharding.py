"""Per-family sharding rules for the production mesh (the dry run's).

Counterpart of `repro/dist/sharding.py`. The rules are the reference's
heuristics, keyed by the ArchSpec family:

  lm     : tensor parallel: shard the largest axis divisible by the
           "model" axis; replicated over the data axes.
  gnn    : replicated parameters (graphs shard over the data axes).
  d3gnn  : replicated parameters; the engine shards its part axis itself.
  recsys : embedding tables row-sharded over the model axis, dense
           parameters replicated.

Inputs: the leading (batch / part) axis over the data axes when it
divides, else replicated.

A spec mirrors a `PartitionSpec`: a tuple with one entry per leading
dimension, None (not sharded), an axis name, or a tuple of axis names (a
group); () is replicated. PyTorch has no partitioner, so a spec here
only sizes a device's share: `shard_shape` and `tree_bytes_per_device`.
Where the port's leaf is the reference's leaf transposed or unstacked
(`convert.LMLayout`, `convert.GraphLayout`), the rule still picks the
largest divisible axis; the tests hold the two packages to the same
bytes a device. The reference's carry specs (`carry_pspecs`,
`stage_carry_*`) have no counterpart: each rank of the port's stream
mesh holds its own block of parts.
"""
from __future__ import annotations

import math

from repro_torch.launch.mesh import data_axes
from repro_torch.optim.optimizers import tree_map


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape[name]) if name in mesh.axis_names else 1


def _model_spec(leaf, mesh) -> tuple:
    """Shard the largest divisible axis over "model"; else replicate."""
    m = _axis_size(mesh, "model")
    if m <= 1 or not hasattr(leaf, "shape") or len(leaf.shape) == 0:
        return ()
    dims = list(leaf.shape)
    for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
        if dims[i] % m == 0 and dims[i] >= m:
            spec = [None] * len(dims)
            spec[i] = "model"
            return tuple(spec)
    return ()


def _replicated(leaf, mesh) -> tuple:
    return ()


def _recsys_spec(leaf, mesh) -> tuple:
    # row-shard anything that looks like an embedding table (2D and tall)
    if (hasattr(leaf, "shape") and len(leaf.shape) == 2
            and leaf.shape[0] >= 16 * max(1, leaf.shape[1])
            and leaf.shape[0] % max(1, _axis_size(mesh, "model")) == 0):
        return ("model",)
    return ()


FAMILY_PARAM_RULES = {
    "lm": _model_spec,
    "gnn": _replicated,
    "d3gnn": _replicated,
    "recsys": _recsys_spec,
}


def spec_tree(tree, rule, mesh):
    """Map a (leaf, mesh) -> spec rule over a tree (dicts, tuples)."""
    return tree_map(lambda leaf: rule(leaf, mesh), tree)


def _batch_sharding(leaf, mesh) -> tuple:
    axes = data_axes(mesh)
    n = math.prod(_axis_size(mesh, a) for a in axes)
    if (n > 1 and hasattr(leaf, "shape") and len(leaf.shape) >= 1
            and leaf.shape[0] % n == 0 and leaf.shape[0] >= n):
        # a group of one axis is that axis, as PartitionSpec reads it
        return (axes if len(axes) > 1 else axes[0],)
    return ()


def _input_rule(in_specs: dict, mesh, kind: str) -> dict:
    return {k: tree_map(lambda leaf: _batch_sharding(leaf, mesh), v)
            for k, v in in_specs.items()}


FAMILY_INPUT_RULES = {
    "lm": _input_rule,
    "gnn": _input_rule,
    "d3gnn": _input_rule,
    "recsys": _input_rule,
}


def shard_shape(shape, spec: tuple, mesh) -> tuple:
    """One device's block of a `shape` array under `spec`: each sharded
    dimension divided by its axes' extent (rounded up, as a padded
    uneven shard holds)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(_axis_size(mesh, a) for a in axes)
        out[i] = -(-out[i] // n)
    return tuple(out)


def tree_bytes_per_device(tree, specs, mesh) -> int:
    """Bytes one device holds of a tree of tensors under a same-shaped
    tree of specs (`spec_tree`)."""
    pairs = []
    tree_map(lambda leaf, spec: pairs.append((leaf, spec)), tree, specs)
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in pairs)
