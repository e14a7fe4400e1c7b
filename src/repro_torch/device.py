"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no device given and no CUDA present this raises — the
    port never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' to run it on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def seeded_generator(device, seed: int):
    """A `torch.Generator` on `device` seeded with `seed`, or None on the
    `meta` device: a meta build (the dry run's) allocates shapes only and
    draws nothing, and torch has no generator there."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)
