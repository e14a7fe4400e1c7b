"""Plain PyTorch versions of the segment-reduce kernels.

The wrappers in `ops.py` run these for CPU tensors; the card tests and
`chip_smoke.py` hold the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregators import mean_read


def deliver_rows_ref(vec, row_ptr, order=None, cnt=None, base=None,
                     base_cnt=None, mode="add"):
    """ops.deliver_rows in plain PyTorch: record j of run r (j in
    [row_ptr[r], row_ptr[r + 1])) is vec row order[j] (order None: row j).
    add: f32 index_add_ of each run's records into zeros, then the base
    added; set: each non-empty run's last record, else the base row.
    Returns (out [n, d], cnt_out [n] or None, flag [n] bool)."""
    n, d = row_ptr.numel() - 1, vec.shape[1]
    dev = vec.device
    lens = row_ptr[1:] - row_ptr[:-1]
    flag = lens > 0
    if mode == "add":
        rec = torch.arange(int(row_ptr[0]), int(row_ptr[-1]), device=dev)
        src = rec if order is None else order[rec]
        seg = torch.repeat_interleave(torch.arange(n, device=dev), lens)
        out = torch.zeros((n, d), dtype=torch.float32,
                          device=dev).index_add_(0, seg, vec[src])
        if base is not None:
            out = base + out
        cnt_out = None
        if cnt is not None:
            cnt_out = torch.zeros(n, dtype=torch.float32,
                                  device=dev).index_add_(0, seg, cnt[src])
            if base_cnt is not None:
                cnt_out = base_cnt + cnt_out
        return out, cnt_out, flag
    hit = torch.nonzero(flag).squeeze(1)
    last = row_ptr[hit + 1] - 1
    src = last if order is None else order[last]
    out = torch.zeros((n, d), dtype=torch.float32, device=dev) \
        if base is None else base.clone()
    out[hit] = vec[src]
    cnt_out = None
    if cnt is not None:
        cnt_out = torch.zeros(n, dtype=torch.float32, device=dev) \
            if base_cnt is None else base_cnt.clone()
        cnt_out[hit] = cnt[src]
    return out, cnt_out, flag


def segment_sum_rows_ref(rows, seg, row_ptr):
    """out[r] = sum(rows[row_ptr[r]:row_ptr[r + 1]]) for destination-sorted
    rows [E, W] with sorted segment ids seg [E] and run offsets row_ptr
    [n + 1]; empty runs read zero and rows at or past row_ptr[n] are
    padding."""
    n = row_ptr.numel() - 1
    live = int(row_ptr[-1])
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, seg[:live], rows[:live])


def mean_rows_gather_ref(agg, cnt, rows):
    """out[k] = agg[rows[k]] / max(cnt[rows[k]], 1), zero where cnt <= 0."""
    return mean_read(agg[rows], cnt[rows])


def gather_segment_sum_ref(x, senders, receivers, n_nodes, edge_mask=None):
    """out[v] = sum of x[senders[e]] over the edges e with receivers[e] = v
    that are valid (edge_mask, and receivers[e] in [0, n_nodes)): f32
    index_add_ of the gathered rows."""
    valid = (receivers >= 0) & (receivers < n_nodes)
    if edge_mask is not None:
        valid = valid & edge_mask
    keep = torch.nonzero(valid).squeeze(1)
    out = torch.zeros((n_nodes, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, receivers[keep], x[senders[keep]])


def rmi_apply_read_ref(agg, cnt, idx, vec, dcnt, read_idx):
    """ops.rmi_apply_read unfused: the records' sums by destination (idx
    outside [0, R) dropped) added to the synopsis, the full mean table
    (cnt <= 0 reading zero), then its rows at read_idx. Returns (agg',
    cnt', dirty, reads)."""
    R = agg.shape[0]
    valid = (idx >= 0) & (idx < R)
    keep = torch.nonzero(valid).squeeze(1)
    dest = idx[keep]
    d_vec = torch.zeros_like(agg).index_add_(0, dest, vec[keep])
    d_cnt = torch.zeros_like(cnt).index_add_(0, dest, dcnt[keep])
    dirty = torch.zeros(R, dtype=torch.bool, device=agg.device)
    dirty[dest] = True
    agg2, cnt2 = agg + d_vec, cnt + d_cnt
    return agg2, cnt2, dirty, mean_read(agg2, cnt2)[read_idx]
