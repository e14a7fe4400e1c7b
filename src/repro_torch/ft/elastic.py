"""Elastic re-scaling of physical sub-operators (paper §4.4.2).

Counterpart of `repro/ft/elastic.py`. Logical parts are fixed at
max_parallelism; the physical placement of a logical part under
`parallelism` is Algorithm 5 (`core/explosion.py:physical_part`). A
re-scale (node failure, scale-up) therefore never re-partitions the
graph: keyed state moves with its logical part to its new physical
owner, and Alg. 5's fixed mapping makes recovery deterministic.

The helpers below re-block the packed row buffers whose LAYOUT (not
content) depends on the device count, as functions on tensors:

  * defer rings are [D*K, W] row-compacted FIFOs whose rows are
    destination-addressed (the router recomputes dst = part // p_loc at
    exchange time), so under a new D they only compact into the new
    global capacity (`repack_defer_ring`);
  * the inter-stage ring's [D*C, W] slabs hold rows already routed to
    their owning data shard, so rows re-block by part ownership under the
    new p_loc (`repack_stage_slab`).

`simulate_failure_and_recover` restores a checkpoint and live-reshards
the recovered carry onto a survivor mesh (`D3Pipeline.reshard`), or, on
a LOCAL pipeline, installs the config at the new parallelism.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.explosion import physical_part


@dataclass
class RescalePlan:
    old_parallelism: int
    new_parallelism: int
    max_parallelism: int
    moves: list          # (logical_part, old_phys, new_phys)

    @property
    def moved_fraction(self) -> float:
        return len(self.moves) / self.max_parallelism


def rescale_parts(old_parallelism: int, new_parallelism: int,
                  max_parallelism: int) -> RescalePlan:
    logical = np.arange(max_parallelism)
    old = physical_part(logical, old_parallelism, max_parallelism)
    new = physical_part(logical, new_parallelism, max_parallelism)
    moves = [(int(l), int(o), int(n))
             for l, o, n in zip(logical, old, new) if o != n]
    return RescalePlan(old_parallelism, new_parallelism, max_parallelism,
                       moves)


def shard_views(state_leading_parts: int, parallelism: int,
                max_parallelism: int):
    """Which logical parts each physical sub-operator owns."""
    if state_leading_parts != max_parallelism:
        raise ValueError(f"state has {state_leading_parts} leading parts, "
                         f"max_parallelism is {max_parallelism}")
    phys = physical_part(np.arange(max_parallelism), parallelism,
                         max_parallelism)
    return [np.nonzero(phys == p)[0] for p in range(parallelism)]


# ------------------------------------------------- packed-row re-blocking
def repack_defer_ring(rows, ok, new_rows: int):
    """Re-capacity a [K, W] defer ring to [new_rows, W].

    Valid rows compact to the front with a STABLE sort (FIFO order, and
    therefore delivery order after the move, is kept), then the buffer is
    padded or truncated to the new capacity. Returns (rows', ok', n_lost),
    n_lost a 0-d int64 tensor counting valid rows that did not fit (the
    caller raises: a reshard never drops in-flight work silently)."""
    order = torch.sort((~ok).to(torch.uint8), stable=True).indices
    rows_s, ok_s = rows[order], ok[order]
    k, w = rows_s.shape
    if new_rows >= k:
        pad = new_rows - k
        return (torch.cat([rows_s, rows_s.new_zeros((pad, w))]),
                torch.cat([ok_s, ok_s.new_zeros(pad)]),
                torch.zeros((), dtype=torch.int64, device=rows.device))
    lost = ok_s[new_rows:].sum()
    return rows_s[:new_rows], ok_s[:new_rows], lost


def repack_stage_slab(rows, part_col: int, valid_col: int,
                      p_loc_new: int, d_new: int, cap_new: int):
    """Re-block one inter-stage ring slab [K, W] -> [d_new * cap_new, W]:
    every valid row moves into the block of the data shard that owns its
    part under the NEW p_loc (row order within a block does not matter:
    ring rows deliver to unique (part, slot) targets). Returns (slab',
    n_lost), n_lost the valid rows that overflowed a block."""
    dev = rows.device
    valid = rows[:, valid_col] > 0.5
    part = rows[:, part_col].to(torch.int64)
    dst = torch.where(valid, torch.div(part, p_loc_new,
                                       rounding_mode="floor"),
                      torch.full_like(part, d_new))
    dst_s, order = torch.sort(dst, stable=True)
    rows_s = rows[order]
    # rank of each row within its destination run of the sorted array
    starts = torch.searchsorted(dst_s, torch.arange(d_new + 1, device=dev))
    rank = (torch.arange(dst_s.shape[0], device=dev)
            - starts[torch.clamp(dst_s, 0, d_new)])
    in_cap = (dst_s < d_new) & (rank < cap_new)
    slot = torch.where(in_cap, dst_s * cap_new + rank,
                       torch.full_like(dst_s, d_new * cap_new))
    out = rows.new_zeros((d_new * cap_new + 1, rows.shape[1]))
    out[slot] = torch.where(in_cap[:, None], rows_s, 0.0)
    lost = ((dst_s < d_new) & ~in_cap).sum()
    return out[:-1], lost


def simulate_failure_and_recover(pipe, ckpt_mgr, step: int,
                                 new_parallelism: int, new_mesh=None):
    """Fail-stop drill: restore the checkpoint into `pipe`, then LIVE
    reshard the recovered carry onto the survivor mesh. Returns
    (restored_step, RescalePlan, new_cfg).

    The engine state is keyed by logical part, so no graph data is
    touched. `new_mesh=None` on a meshed pipeline builds the grid of the
    world's first new_parallelism * S ranks (`make_stream_mesh(stage=S,
    ranks=...)`, the reference's `make_stream_mesh(new_parallelism * S,
    stage=S)`); on a local pipeline it installs the config at the new
    parallelism without moving anything. On a mesh this is collective
    over the world, as `reshard` is. The caller's config object is never
    mutated: the new validated config is installed and returned."""
    restored = ckpt_mgr.restore_pipeline(pipe, step)
    plan = rescale_parts(pipe.cfg.base_parallelism, new_parallelism,
                         pipe.cfg.n_parts)
    if new_mesh is None and pipe.mesh is not None:
        from repro_torch.launch.mesh import make_stream_mesh
        new_mesh = make_stream_mesh(
            pipe.device, stage=pipe.n_stages,
            ranks=range(new_parallelism * pipe.n_stages))
    new_cfg = replace(pipe.cfg, base_parallelism=new_parallelism)
    pipe.reshard(new_mesh, cfg=new_cfg)
    return restored, plan, pipe.cfg
