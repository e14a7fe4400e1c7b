"""Device time by call site from a `torch.profiler` run with stacks.
Frozen copy of `chip_smoke.py:call_site` and `device_ms_by_site`."""
from __future__ import annotations

import bisect
from collections import Counter


def call_site(event):
    """Where a profiler event was launched from: its innermost repro_torch
    frame and, below that, the tick stage (core/tick.py) it ran in, as
    'kernels/segment_reduce/ops.py(86): sort_runs < core/tick.py(241):
    apply_rmis'. Walks up from the event (a kernel's launch) through its
    enclosing events: the first one with a recorded stack gives the
    frames; where stacks are recorded as Python-function events instead
    (with_stack=True in newer PyTorch), those events' names do."""
    frames, node = [], event
    while node is not None:
        stack = [f.split("repro_torch/", 1)[1]
                 for f in (getattr(node, "stack", None) or [])
                 if "repro_torch/" in f]
        if stack:
            frames += stack
            break
        if "repro_torch/" in node.name:
            frames.append(node.name.split("repro_torch/", 1)[1])
        node = node.cpu_parent
    if not frames:
        return None
    stage = next((f for f in frames[1:] if f.startswith("core/tick.py")),
                 frames[1] if len(frames) > 1 else None)
    return frames[0] + (f" < {stage}" if stage else "")


def device_ms_by_site(prof):
    """(device ms by call site, launches by call site, launches linked to
    an event) of a torch.profiler run with stacks: each kernel's time goes
    to the call site (`call_site`) of the event that launched it or, where
    its own chain names none (ctypes launches), of the innermost event
    with a stack that encloses it in time on the same thread."""
    by_site, n_site, n_kernels = Counter(), Counter(), 0
    all_events = list(prof.events())
    # events with a repro_torch stack, by thread and start
    stacked = {}
    for x in all_events:
        if call_site(x) is not None:
            stacked.setdefault(x.thread, []).append(x)
    for xs in stacked.values():
        xs.sort(key=lambda x: x.time_range.start)

    def enclosing_site(e):
        xs = stacked.get(e.thread, [])
        starts = [x.time_range.start for x in xs]
        i = bisect.bisect_right(starts, e.time_range.start)
        for x in reversed(xs[max(0, i - 64):i]):
            if x.time_range.end >= e.time_range.end:
                return call_site(x)
        return None

    for e in all_events:
        kernels = [k for k in getattr(e, "kernels", [])
                   if k.name != "Command Buffer Full"]
        n_kernels += len(kernels)
        site = (call_site(e) or enclosing_site(e)) if kernels else None
        if site:
            by_site[site] += sum(k.duration for k in kernels) / 1e3
            n_site[site] += len(kernels)
    return by_site, n_site, n_kernels
