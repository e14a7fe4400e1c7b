"""Explosion factor (paper §4.2.3) + logical->physical mapping (Alg. 5).

Counterpart of `repro/core/explosion.py` (numpy only, its own copy).
Layer i of L gets parallelism p_i = p * lambda^(i-1): deeper GraphStorage
operators get more sub-operators to absorb neighborhood explosion. Logical
parts are fixed at max_parallelism; the physical sub-operator of a logical
part under parallelism `par` is Alg. 5:

    key_group     = logical_part % max_parallelism
    physical_part = key_group * par // max_parallelism

which keeps every sub-operator non-idle (contiguous key ranges) and makes
re-scaling a pure remap: state moves with its logical part.
"""
from __future__ import annotations

import numpy as np


def physical_part(logical_part, parallelism: int, max_parallelism: int):
    """Algorithm 5 (vectorized: works on ints or numpy arrays)."""
    key_group = logical_part % max_parallelism
    return key_group * parallelism // max_parallelism


def layer_parallelisms(p: int, lam: float, n_layers: int,
                       max_parallelism: int) -> list[int]:
    """p_i = p * lam^(i-1), capped at max_parallelism."""
    return [max(1, min(max_parallelism, int(round(p * lam ** i))))
            for i in range(n_layers)]


def physical_busy(logical_busy: np.ndarray, parallelism: int,
                  max_parallelism: int) -> np.ndarray:
    """Aggregate a [P_logical] busy vector onto physical sub-operators."""
    phys = physical_part(np.arange(len(logical_busy)), parallelism,
                         max_parallelism)
    out = np.zeros(parallelism)
    np.add.at(out, phys, logical_busy)
    return out


def imbalance_factor(busy: np.ndarray) -> float:
    """Paper's metric: max(busy) / mean(busy)."""
    m = busy.mean()
    return float(busy.max() / m) if m > 0 else 0.0
