"""What a traced run reads: spans around the program's entries, the launch
arguments of kernels 1 and 2, and one `torch.profiler` window reduced to
busy time, idle gaps and time by kernel.

All of it is set up by the benchmark around the program's own functions
and undone when the run is done; the program is not edited.
"""
from __future__ import annotations

import inspect
import json
import os
import tempfile
from collections import Counter

import torch
from torch.autograd.profiler import record_function

from portbench.yardstick import kernel_bytes

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench:"
WINDOW_SPAN = "portbench.traced"


class Patches:
    """Replace attributes for the life of the context, restore them after
    (in reverse order, so wrappers of one attribute nest)."""

    def __init__(self):
        self._saved = []

    def wrap(self, owner, name: str, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


def span(name: str):
    """A wrapper maker: the call runs inside record_function(name)."""
    def make(orig):
        def wrapped(*a, **k):
            with record_function(SPAN_PREFIX + name):
                return orig(*a, **k)
        return wrapped
    return make


class KernelLog:
    """The live counts of each launch of kernels 1 and 2 while `on`, kept as
    device scalars (no host read inside the window)."""

    def __init__(self):
        self.on = False
        self.launches = []          # (entry, static dict, device scalars)

    def deliver_rows(self, orig):
        sig = inspect.signature(orig)

        def wrapped(*a, **k):
            if self.on:
                b = sig.bind(*a, **k)
                b.apply_defaults()
                v = b.arguments
                rp = v["row_ptr"]
                if rp.is_cuda and rp.numel() > 1:
                    self.launches.append(("deliver_rows", dict(
                        mode=v["mode"], n=rp.numel() - 1,
                        d=v["vec"].shape[1],
                        order=v["order"] is not None,
                        cnt=v["cnt"] is not None,
                        base=v["base"] is not None,
                        base_cnt=v["base_cnt"] is not None),
                        torch.stack([rp[-1], (rp[1:] > rp[:-1]).sum()])))
            return orig(*a, **k)
        return wrapped

    def mean_rows_gather(self, orig):
        def wrapped(agg, cnt, rows):
            if self.on and rows.is_cuda and rows.numel() and agg.shape[1]:
                self.launches.append(("mean_rows_gather", dict(
                    k=rows.numel(), d=agg.shape[1]),
                    (cnt[rows] > 0).sum().reshape(1)))
            return orig(agg, cnt, rows)
        return wrapped

    def total_bytes(self) -> dict:
        """{entry: (bytes, launches)} over the logged launches."""
        out = Counter(), Counter()
        if not self.launches:
            return {}
        vals = torch.cat([x for _, _, x in self.launches]).cpu().tolist()
        i = 0
        for entry, st, x in self.launches:
            if entry == "deliver_rows":
                live, touched = vals[i], vals[i + 1]
                b = kernel_bytes.deliver_bytes(live=live, touched=touched,
                                               **st)
            else:
                b = kernel_bytes.mean_rows_bytes(live=vals[i], **st)
            i += x.numel()
            out[0][entry] += b
            out[1][entry] += 1
        return {e: (out[0][e], out[1][e]) for e in out[0]}


class Profiler:
    """torch.profiler over the launches `first`..`last` of the window:
    started before `first`, stopped after `last` (or by `close`, where
    the window ends sooner), each edge behind a device synchronise, inside
    a `WINDOW_SPAN` range. `launches` counts the launches it saw."""

    def __init__(self, first: int, last: int, device):
        self.first, self.last, self.device = first, last, device
        self.prof = self._rf = None
        self.summary = None
        self.launches = 0

    def before(self, i: int):
        if i != self.first:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        _sync(self.device)
        self._rf = record_function(WINDOW_SPAN)
        self._rf.__enter__()

    def after(self, i: int):
        if self.prof is not None:
            self.launches += 1
            if i == self.last:
                self.close()

    def close(self):
        if self.prof is None:
            return
        _sync(self.device)
        self._rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = summarize(events)
        if self.summary:
            self.summary["launches"] = self.launches
        self.prof = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str, width: int = 100) -> str:
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width]


def summarize(events: list) -> dict:
    """Reduce a chrome trace (µs) to the traced window: its seconds, the
    device's busy seconds (union of kernels, copies and fills), device time
    by kernel name, and the idle gaps named by the innermost benchmark span
    open on the host halfway through each."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], Counter()
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                dev.append((s0, s1))
                by_name[short_name(e["name"])] += s1 - s0
    busy = _union(dev)
    busy_us = sum(e - s for s, e in busy)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][len(SPAN_PREFIX):]) for e in xs
                    if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(SPAN_PREFIX)))
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)

    def host_at(t):
        open_ = [(s, e, n) for s, e, n in spans if s <= t < e]
        return max(open_)[2] if open_ else "no benchmark span"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": [[n, us / 1e6] for n, us in
                           by_name.most_common(10)],
            "idle_gaps": [[host_at((s + e) / 2), (e - s) / 1e6]
                          for s, e in gaps[:10]],
            "by_name_s": {n: us / 1e6 for n, us in by_name.items()}}
