"""Operation counts of one call of a step: dot FLOPs, memory traffic and
the hand-written kernels' own work.

Counterpart of `repro/roofline/hlo_analyzer.py`. The JAX package parses
the optimised HLO of a compiled step; PyTorch has no HLO, so `OpCounter`
is a `TorchDispatchMode` that sees every aten operation the step runs
(after autograd and the composite operators' decomposition: `einsum`
and `@` arrive as `mm` / `bmm`), on the card, the CPU or the `meta`
device alike:

  * dot FLOPs: 2 x prod(out) x contracted for `mm`, `addmm`, `bmm`,
    `baddbmm`, `mv`, `dot` and `convolution`, as `_dot_flops` counts a
    `dot` (hlo_analyzer.py:117); a loop runs its body's operations as
    many times as it turns, so a scan's trip count needs no rule;
  * memory traffic: operand + result bytes of each operation. A view
    moves nothing; a broadcast operand counts its distinct elements. An
    in-place write into a slice (`copy_` into a view) is charged for the
    slice, and an indexed write into a buffer (`index_put_`,
    `index_copy_`, `index_add_`, `scatter_` and their kind) for the rows
    written (twice where it adds into them) beside its index and value
    operands, never for the buffer: the counterpart of the
    dynamic-update-slice rule (hlo_analyzer.py:255-275). A gather
    (`index`, `index_select`, `gather`, `embedding`) is charged alike
    for the elements it reads (its result's size), its indices and its
    result, never for the table it reads from.

Work no dispatch mode can price arrives as a note (`repro_torch/work.py`)
and is priced here, from one table (`NOTE_COSTS`), by entry name:

  * a hand-written kernel is a ctypes launch that the dispatch mode
    cannot see. Each kernel entry (`kernels/*/ops.py`) notes its
    operands where it launches, and is charged its FLOPs as its plain
    version's aten products count them (over the visible pairs, for
    causal attention: see below) and its own bytes (what it reads once
    and writes once: where the data decides which rows it reads, on a
    device with data the rows this data makes it read, one value read
    back while counting, and on `meta` the host's bound on them). So a
    roofline share reads the same work whichever implements it;
  * causal attention's products over masked (query, key) pairs are work
    the function does not need. A plain causal attention
    (`nn/attention.py`, `kernels/flash_attention/ref.py`) notes its
    operands after its products, and the counter moves their masked
    share out of `flops` into `masked_flops`, in the forward and, when
    a gradient flows back through it, in the backward's products too.
    So `flops` counts 4 B H D x (visible pairs) for a causal attention
    whichever implements it (`attention_flops`), and `flops +
    masked_flops` is what the aten products ran, the count JAX's HLO
    analyzer reads.

With no counter active a note costs one check.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves

from repro_torch import work

aten = torch.ops.aten

# allocations write nothing the step reads, and `_unsafe_view` is a view
# its schema does not mark (`is_view` False): no traffic
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten._unsafe_view.default,
               aten._local_scalar_dense.default}
# indexed writes into their first operand: charged for the rows written
# (x1) or read, added to and written (x2), not for the buffer
_INDEXED_WRITES = {
    aten.index_put_.default: None,          # x2 with accumulate=True
    aten._index_put_impl_.default: None,
    aten.index_copy_.default: 1, aten.index_add_.default: 2,
    aten.scatter_.src: 1, aten.scatter_.value: 1,
    aten.scatter_add_.default: 2, aten.scatter_reduce_.two: 2,
}

# gathers from their first operand: charged for the elements read (the
# result's size) beside the indices, not for the source buffer
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of t's distinct elements (a broadcast dimension, stride 0,
    counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) \
        if t.ndim else 1
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def dot_flops(func, args, out) -> int:
    """2 x prod(out) x contracted of a product, 0 for anything else."""
    if func in (aten.mm.default, aten.bmm.default, aten.mv.default,
                aten.dot.default):
        a = args[0]
    elif func in (aten.addmm.default, aten.baddbmm.default,
                  aten.addmv.default):
        a = args[1]
    elif func is aten.convolution.default:
        x, w, transposed = args[0], args[1], args[6]
        # weight [C_out, C_in / g, *k] (transposed: [C_in, C_out / g, *k])
        per = w.shape[1] * math.prod(w.shape[2:])
        return 2 * (x.numel() if transposed else out.numel()) * per
    else:
        return 0
    return 2 * out.numel() * a.shape[-1]


def op_bytes(func, args, kwargs, out) -> int:
    """Operand + result bytes of one operation, under the rules above."""
    if func in _NO_TRAFFIC or getattr(func, "is_view", False):
        return 0
    if func is aten.copy_.default:
        return tensor_bytes(args[0]) + tensor_bytes(args[1])
    if func in _INDEXED_WRITES:
        times = _INDEXED_WRITES[func]
        if times is None:
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                           False)
            times = 2 if acc else 1
        rest = _tensors((args[1:], kwargs))
        values = rest[-1] if rest else args[0]
        return sum(tensor_bytes(t) for t in rest) \
            + times * values.numel() * args[0].element_size()
    if func in _GATHERS:
        out_b = sum(tensor_bytes(t) for t in _tensors(out))
        return sum(tensor_bytes(t) for t in _tensors((args[1:], kwargs))) \
            + 2 * out_b
    ins = {id(t): t for t in _tensors((args, kwargs))}
    return sum(tensor_bytes(t) for t in ins.values()) \
        + sum(tensor_bytes(t) for t in _tensors(out))


def visible_pairs(S: int, T: int, causal: bool = True,
                  q_offset: int = 0) -> int:
    """The (query, key) pairs attention computes on: all S x T, or under
    the causal mask the keys t <= q_offset + i of each query i (t < T)."""
    if not causal:
        return S * T
    lo, hi = q_offset + 1, q_offset + S    # keys queries 0 and S-1 see
    a, b = max(lo, 1), min(hi, T)
    ramp = (a + b) * (b - a + 1) // 2 if b >= a else 0
    flat = T * (hi - max(lo, T + 1) + 1) if hi > T else 0
    return ramp + flat


def attention_flops(q, k, causal: bool = True, q_offset: int = 0) -> int:
    """Dot FLOPs of attention on q [B,S,H,D], k [B,T,Kh,D] over the
    visible pairs: scores and p @ v, 2 x 2 x B x H x D a pair."""
    B, S, H, D = q.shape
    return 4 * B * H * D * visible_pairs(S, k.shape[1], causal, q_offset)


def kernel_bytes(*tensors) -> int:
    """Bytes of the tensors a kernel reads once or writes once (None
    skipped)."""
    return sum(tensor_bytes(t) for t in tensors if t is not None)


def _rows_bytes(n: int, like) -> int:
    """n f32 rows as wide as `like`'s last dim."""
    return n * like.shape[-1] * 4


def _live(count, t: torch.Tensor, bound: int) -> int:
    """How many rows a kernel reads, where that depends on the data: on
    a device with data, `count()` (one value read back, under counting
    only); on `meta`, the host's bound."""
    return bound if t.device.type == "meta" else int(count())


def _flash_cost(o):
    # q, k, v read once and the output written; no scores
    return (attention_flops(o["q"], o["k"], o["causal"]),
            kernel_bytes(o["q"], o["k"], o["v"], o["out"]))


def _bag_cost(o):
    # each live (>= 0) id's row read once, the ids, the bags written
    ids = o["ids"]
    n = _live(lambda: (ids >= 0).sum(), ids, ids.numel())
    return 0, _rows_bytes(n, o["out"]) + kernel_bytes(ids, o["out"])


def _deliver_cost(o):
    # each record in a run read once (add: row_ptr[n] records; set: the
    # last of each non-empty run) with its count, the plan's inputs, the
    # outputs written (the base, when fused, read whole)
    rp = o["row_ptr"]
    if o["mode"] == "add":
        n = _live(lambda: rp[-1], rp, o["n_rec"])
    else:
        n = _live(lambda: (rp[1:] > rp[:-1]).sum(), rp,
                  min(o["n_rec"], o["out"].shape[0]))
    return 0, (_rows_bytes(n, o["out"])
               + (0 if o["cnt"] is None else 4 * n)
               + kernel_bytes(rp, o["order"], o["base"], o["base_cnt"],
                              o["out"], o["cnt_out"], o["flag"]))


def _mean_rows_cost(o):
    # each pick's index and count read, its row where the count is > 0,
    # the output written
    rows, cnt = o["rows"], o["cnt"]
    n = _live(lambda: (cnt[rows] > 0).sum(), rows, rows.numel())
    return 0, rows.numel() * 4 + _rows_bytes(n, o["out"]) \
        + kernel_bytes(rows, o["out"])


def _route_pack_cost(o):
    # each placed row (min(live, cap) a destination) read once, the
    # plan, the send buffer written
    starts, out = o["starts"], o["out"]
    cap = out.shape[0] // (starts.numel() - 1)
    n = _live(lambda: (starts[1:] - starts[:-1]).clamp(max=cap).sum(),
              starts, o["order"].numel())
    return 0, _rows_bytes(n, out) + kernel_bytes(o["order"], starts, out)


def _route_lane_cost(o):
    # each live source row (ring or lane, placed or overflowed) read
    # once, the plan, both outputs written
    starts, send = o["starts"], o["send"]
    n = _live(lambda: starts[-1], starts, o["order"].numel())
    return 0, _rows_bytes(n, send) + kernel_bytes(
        o["order"], starts, send, o["new_ring"])


# the kernel entries' costs: name -> fn(operands) -> (FLOPs, bytes). No
# dot FLOPs but flash attention's, as the other plain versions have none
NOTE_COSTS = {"flash_attention": _flash_cost, "embedding_bag": _bag_cost,
              "segment_sum_rows": _deliver_cost,
              "mean_rows_gather": _mean_rows_cost,
              "route_pack": _route_pack_cost,
              "route_lane": _route_lane_cost}


class OpCounter(TorchDispatchMode):
    """`with OpCounter() as c: step(...)` counts every aten operation of
    the step and prices the notes it receives. Totals: `flops` (dot
    FLOPs, causal attention over its visible pairs), `masked_flops` (the
    masked pairs' products the plain attention ran), `bytes`; by name:
    `by_op` and `kernels`, each {name: [calls, flops, bytes]}."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.masked_flops = 0
        self.bytes = 0
        self.by_op: dict = {}
        self.kernels: dict = {}

    def __enter__(self):
        work.OBSERVERS.append(self._note)
        return super().__enter__()

    def __exit__(self, *exc):
        work.OBSERVERS.remove(self._note)
        return super().__exit__(*exc)

    def _add(self, table: dict, name: str, flops: int, nbytes: int):
        row = table.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._add(self.by_op, func.__name__, dot_flops(func, args, out),
                  op_bytes(func, args, kwargs, out))
        return out

    def _mask(self, flops: int) -> None:
        self.flops -= flops
        self.masked_flops += flops

    def _note(self, name: str, o: dict) -> None:
        if name != "masked_attention":
            with _disable_current_modes():     # a live count: not the step's
                flops, nbytes = NOTE_COSTS[name](o)
            self._add(self.kernels, name, int(flops), int(nbytes))
            return
        # one product's FLOPs over the masked pairs; the forward ran two
        q, k, v, out = o["q"], o["k"], o["v"], o["out"]
        B, S, H, D = q.shape
        T = k.shape[1]
        per = 2 * B * H * D * (S * T - visible_pairs(S, T, True,
                                                     o.get("q_offset", 0)))
        self._mask(2 * per)
        if out.requires_grad:
            # the backward's products: dq and dk (scores), dp and dv
            n = (q.requires_grad + k.requires_grad
                 + (q.requires_grad or k.requires_grad) + v.requires_grad)
            out.register_hook(lambda g: self._mask(n * per))
