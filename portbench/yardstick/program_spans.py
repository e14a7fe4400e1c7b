"""The program's launch log (`repro_torch.telemetry.spans`), as the
per-layer metrics read it.

The readers keep the newest pipeline's loaded, unprofiled launches: a
launch that staged stream edges and ran with torch's profiler off (the
window's launches and set-up's warm ones). That leaves out the traced
run's profiled launches, the drains, the train cell's label-only check
steps and its call-site profile launch. A program without the launch
log reads as no launches, so every reader returns None there.
"""
from __future__ import annotations

import statistics


def _records() -> list:
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return []
    return spans.records()


def launches() -> list:
    """The newest pipeline's loaded, unprofiled launch records."""
    loaded = [r for r in _records() if r["kind"] == "launch"]
    if not loaded:
        return []
    newest = max(r["pipeline"] for r in loaded)
    return [r for r in loaded if r["pipeline"] == newest
            and r["counts"]["edges"] > 0 and not r["profiled"]]


def median_of(fn):
    """The median of fn(record) over the kept launches, or None."""
    kept = launches()
    return statistics.median(fn(r) for r in kept) if kept else None


def build_seconds():
    """The newest pipeline build's seconds, or None."""
    builds = [r for r in _records() if r["kind"] == "build"]
    return builds[-1]["spans"]["pipeline.build"] if builds else None
