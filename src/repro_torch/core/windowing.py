"""Windowed forward-pass policies (paper §4.2.4) + CountMinSketch.

Counterpart of `repro/core/windowing.py`. Per-vertex eviction deadlines,
tick-granular:

  Streaming        : deadline = now                  (evict immediately)
  Tumbling         : deadline = (now // W + 1) * W   (fixed buckets)
  Session          : deadline = now + W              (touch extends)
  AdaptiveSession  : deadline = now + clip(ceil(alpha / freq_v)), freq_v a
                     decayed CountMinSketch estimate of update frequency.

`now` is a 0-d int64 tensor on the state's device, so the super-tick
driver never reads the clock back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

STREAMING = "streaming"
TUMBLING = "tumbling"
SESSION = "session"
ADAPTIVE = "adaptive"


@dataclass(frozen=True)
class WindowConfig:
    kind: str = STREAMING
    interval: int = 4              # W, in ticks
    adaptive_min: int = 1
    adaptive_max: int = 16
    adaptive_alpha: float = 8.0    # deadline ~= alpha / freq
    cms_decay: float = 0.9         # exponential decay applied per tick


def next_deadline(cfg: WindowConfig, now, cur_deadline, pending, freq):
    """Deadline for vertices touched at tick `now` (pending: already had a
    scheduled eviction; freq: CMS estimate, ADAPTIVE only)."""
    if cfg.kind == STREAMING:
        return torch.zeros_like(cur_deadline) + now
    if cfg.kind == TUMBLING:
        bucket = (torch.div(now, cfg.interval, rounding_mode="floor")
                  + 1) * cfg.interval
        # an existing earlier deadline stays (tumbling buckets don't move)
        return torch.where(pending, torch.minimum(cur_deadline, bucket),
                           torch.zeros_like(cur_deadline) + bucket)
    if cfg.kind == SESSION:
        return torch.zeros_like(cur_deadline) + (now + cfg.interval)
    if cfg.kind == ADAPTIVE:
        # ceil, not truncation: a hot vertex with alpha/freq in (0, 1)
        # rounds UP to a 1-tick interval (fractional intervals round up)
        interval = torch.clamp(
            torch.ceil(cfg.adaptive_alpha / torch.clamp(freq, min=1e-3)
                       ).to(torch.int32),
            cfg.adaptive_min, cfg.adaptive_max)
        return (now + interval).to(cur_deadline.dtype)
    raise ValueError(cfg.kind)


# ---------------------------------------------------------------- sketch
_CMS_PRIMES = (1000003, 1000033, 1000037, 1000039, 1000081, 1000099)
_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """(h * c) mod 2**32 for 0 <= h < 2**32 in int64 without overflow:
    the constant is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def cms_hash(keys, depth: int, width: int):
    """[depth, n] bucket indices via multiply-shift hashing — bit-exact
    with the JAX package's uint32 arithmetic, computed in int64 with a
    32-bit mask after every multiply and add."""
    ks = keys.to(torch.int64) & _M32
    rows = []
    for d in range(depth):
        h = (_mul32(ks, _CMS_PRIMES[d % len(_CMS_PRIMES)])
             + ((d * 0x9E3779B9) & _M32)) & _M32
        h = h ^ (h >> 16)
        h = _mul32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        rows.append(h % width)
    return torch.stack(rows)


def cms_delta(shape, keys, weights):
    """The [depth, width] additive table for one update batch (one
    batched scatter-add over all depth rows; exact small counts, so the
    scatter order is irrelevant)."""
    depth, width = shape
    idx = cms_hash(keys, depth, width)                       # [depth, n]
    flat = idx + width * torch.arange(depth, device=idx.device)[:, None]
    w = torch.broadcast_to(weights, idx.shape)
    return torch.zeros(depth * width, dtype=weights.dtype,
                       device=weights.device).index_add_(
        0, flat.reshape(-1), w.reshape(-1)).reshape(depth, width)


def cms_update(cms, keys, weights, decay: float = 1.0):
    """Add `weights` at `keys`; optionally decay the whole sketch first."""
    return cms * decay + cms_delta(cms.shape, keys, weights)


def cms_query(cms, keys):
    idx = cms_hash(keys, *cms.shape)
    return torch.gather(cms, 1, idx).min(dim=0).values
