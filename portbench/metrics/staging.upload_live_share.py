"""Bytes of valid rows among the bytes staged to the device, in %: the
program's `upload.live_bytes` over `upload.bytes` counters, each summed
over the newest pipeline's loaded, unprofiled launches before the
division."""
from portbench.yardstick import program_spans


def read(ctx):
    kept = program_spans.launches()
    total = sum(r["counts"]["upload.bytes"] for r in kept)
    if not total:
        return None
    return 100.0 * sum(r["counts"]["upload.live_bytes"]
                       for r in kept) / total
