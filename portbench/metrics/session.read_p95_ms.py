"""The 95th percentile (nearest rank) of the latency of every point read
due in the window, from its due time on the open-loop schedule to the
host's sight of its answer; a read that did not come back ok (answered
not ok, dropped, never answered) counts as infinitely late. It swings
with the host's speed from run to run, so it stands beside
`events_per_s` as a per-layer reading of the serve session."""
from portbench.compare import nearest_rank


def read(ctx):
    lat = ctx.counts.get("latency_s")
    if not lat:
        return None
    return nearest_rank(lat, 0.95) * 1e3
