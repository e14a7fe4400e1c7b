"""Consistent-cut checkpointing (paper §3.2 / §5.1).

Counterpart of `repro/ft/checkpoint.py`, in the same format, so each
package restores the other's checkpoints of the same configuration.

A tick boundary IS a consistent cut: every channel is empty between
ticks, and what the paper stores as "in-queue messages" lives in the
window-pending state (red_pending / fwd_pending and their deadlines), the
held query table and the defer rings, so checkpointing the operator state
between ticks captures the same information.

Format: one compressed msgpack blob per checkpoint with raw array buffers
(no pickle), plus the host partitioner tables in a second blob. Every blob
starts with a codec tag: \\x03 (zstd) or \\x04 (zlib), then the CRC32 of
the compressed payload (4 bytes, little-endian), then the payload; the
CRC-less \\x01 / \\x02 and a bare zstd frame restore too. zstd is used
when the optional `zstandard` package imports, zlib otherwise; a zstd
blob without the package raises. The msgpack subset the payload uses
(map, str, bin, int, array) is encoded and decoded here, byte for byte
as `msgpack.packb(payload, use_bin_type=True)` would, so the port needs
no msgpack package.

The payload is {"treedef": str, "leaves": [{"dtype", "shape", "data"}]}
with the leaves in the reference's `jax.tree` flatten order: dict keys
sorted, dataclass fields in order, None as zero leaves. Restores read the
leaves only and cast each to the template's dtype, so the port's int64
index tables and the reference's int32 ones restore into each other.

Writes go to <step>.ckpt.tmp, then an atomic rename. `save` snapshots the
tree on the caller's thread (one copy of every tensor to the host) before
the optional writer thread starts (`async_write`, the paper's
non-blocking snapshots).

On a mesh every rank calls `save_pipeline` / `restore_pipeline`: rank 0
writes the reference's GLOBAL layout (`gather_tree`: part-leading tables
gathered over the data axis; on a 2-D mesh the round states stacked over
the stages, [S, P, ...], and the inter-stage ring as [S, R, D * C, W]),
and each rank restores its own block (`local_block`). The live reshard
(`D3Pipeline.reshard`) relays state through the same two functions.

Garbage collection keeps the newest `keep` generations: a collected
generation loses its blob, its meta and its host-table pair
(`.aux` / `.auxnames.json`). The reference's `_gc` leaves the pair
behind, so its directory grows one host-table blob a save.
"""
from __future__ import annotations

import json
import threading
import warnings
import zlib
from dataclasses import dataclass, fields, is_dataclass, replace
from pathlib import Path

import numpy as np
import torch

try:                                    # optional: zstd when installed
    import zstandard
except ImportError:                     # clean env: stdlib fallback
    zstandard = None

# codec tags (format header), as in the reference
_CODEC_ZSTD = b"\x01"
_CODEC_ZLIB = b"\x02"
_CODEC_ZSTD_CRC = b"\x03"
_CODEC_ZLIB_CRC = b"\x04"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint blob failed its integrity check (CRC mismatch,
    truncation, or undecodable payload). `CheckpointManager.restore`
    raises it annotated with step + path; step=None restores fall back to
    the previous kept generation with a warning."""


# ------------------------------------------------------- msgpack subset
def _pack(obj, out: list) -> None:
    """Append the msgpack encoding of obj (dict with str keys, str,
    bytes-like, int, list/tuple) to `out` as byte chunks; bytes-like
    payloads are appended without a copy."""
    if isinstance(obj, dict):
        n = len(obj)
        out.append(bytes([0x80 | n]) if n < 16 else
                   b"\xde" + n.to_bytes(2, "big") if n < 1 << 16 else
                   b"\xdf" + n.to_bytes(4, "big"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        out.append(bytes([0xa0 | n]) if n < 32 else
                   b"\xd9" + bytes([n]) if n < 1 << 8 else
                   b"\xda" + n.to_bytes(2, "big") if n < 1 << 16 else
                   b"\xdb" + n.to_bytes(4, "big"))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out.append(b"\xc4" + bytes([n]) if n < 1 << 8 else
                   b"\xc5" + n.to_bytes(2, "big") if n < 1 << 16 else
                   b"\xc6" + n.to_bytes(4, "big"))
        out.append(obj)
    elif isinstance(obj, bool):
        raise TypeError("bool is outside the checkpoint's msgpack subset")
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out.append((obj & 0xff).to_bytes(1, "big"))
        elif obj >= 0:
            for tag, n in ((b"\xcc", 1), (b"\xcd", 2), (b"\xce", 4),
                           (b"\xcf", 8)):
                if obj < 1 << (8 * n):
                    out.append(tag + obj.to_bytes(n, "big"))
                    break
            else:
                raise OverflowError(f"int {obj} does not fit 64 bits")
        else:
            for tag, n in ((b"\xd0", 1), (b"\xd1", 2), (b"\xd2", 4),
                           (b"\xd3", 8)):
                if obj >= -(1 << (8 * n - 1)):
                    out.append(tag + obj.to_bytes(n, "big", signed=True))
                    break
            else:
                raise OverflowError(f"int {obj} does not fit 64 bits")
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(bytes([0x90 | n]) if n < 16 else
                   b"\xdc" + n.to_bytes(2, "big") if n < 1 << 16 else
                   b"\xdd" + n.to_bytes(4, "big"))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"{type(obj).__name__} is outside the checkpoint's "
                        "msgpack subset")


def packb(obj) -> bytes:
    """msgpack bytes of obj (the subset `_pack` takes)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def unpackb(buf):
    """Decode one msgpack object (map, str, bin, int, array; bin payloads
    come back as zero-copy memoryviews of `buf`)."""
    mv = memoryview(buf).cast("B")
    obj, end = _unpack(mv, 0)
    if end != len(mv):
        raise ValueError(f"{len(mv) - end} trailing bytes after the "
                         "msgpack object")
    return obj


def _take(mv, pos: int, n: int):
    if pos + n > len(mv):
        raise ValueError("truncated msgpack payload")
    return mv[pos:pos + n], pos + n


def _unpack(mv, pos: int):
    b, pos = _take(mv, pos, 1)
    t = b[0]
    if t < 0x80:
        return t, pos
    if t >= 0xe0:
        return t - 0x100, pos
    if 0x80 <= t <= 0x8f:
        return _unpack_map(mv, pos, t & 0x0f)
    if 0x90 <= t <= 0x9f:
        return _unpack_array(mv, pos, t & 0x0f)
    if 0xa0 <= t <= 0xbf:
        s, pos = _take(mv, pos, t & 0x1f)
        return str(s, "utf-8"), pos
    sizes = {0xc4: 1, 0xc5: 2, 0xc6: 4, 0xd9: 1, 0xda: 2, 0xdb: 4,
             0xdc: 2, 0xdd: 4, 0xde: 2, 0xdf: 4}
    if t in sizes:
        h, pos = _take(mv, pos, sizes[t])
        n = int.from_bytes(h, "big")
        if t in (0xc4, 0xc5, 0xc6):
            return _take(mv, pos, n)
        if t in (0xd9, 0xda, 0xdb):
            s, pos = _take(mv, pos, n)
            return str(s, "utf-8"), pos
        if t in (0xdc, 0xdd):
            return _unpack_array(mv, pos, n)
        return _unpack_map(mv, pos, n)
    ints = {0xcc: (1, False), 0xcd: (2, False), 0xce: (4, False),
            0xcf: (8, False), 0xd0: (1, True), 0xd1: (2, True),
            0xd2: (4, True), 0xd3: (8, True)}
    if t in ints:
        n, signed = ints[t]
        h, pos = _take(mv, pos, n)
        return int.from_bytes(h, "big", signed=signed), pos
    raise ValueError(f"msgpack type byte {t:#04x} is outside the "
                     "checkpoint's subset")


def _unpack_map(mv, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(mv, pos)
        out[k], pos = _unpack(mv, pos)
    return out, pos


def _unpack_array(mv, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(mv, pos)
        out.append(v)
    return out, pos


# ----------------------------------------------------------- the codec
def _compress_chunks(chunks: list) -> bytes:
    """tag + CRC32 + the compressed concatenation of `chunks`, streamed
    (the raw payload is never joined in memory)."""
    total = sum(memoryview(c).nbytes for c in chunks)
    if zstandard is not None:
        tag = _CODEC_ZSTD_CRC
        # size= writes the content size into the frame header, which a
        # one-shot ZstdDecompressor().decompress needs
        cobj = zstandard.ZstdCompressor(level=3).compressobj(size=total)
    else:
        tag = _CODEC_ZLIB_CRC
        cobj = zlib.compressobj(6)
    body, crc = [], 0
    for c in chunks:
        z = cobj.compress(c)
        if z:
            body.append(z)
            crc = zlib.crc32(z, crc)
    z = cobj.flush()
    body.append(z)
    crc = zlib.crc32(z, crc)
    return tag + (crc & 0xFFFFFFFF).to_bytes(4, "little") + b"".join(body)


def _decompress(blob: bytes) -> bytes:
    tag = blob[:1]
    if tag in (_CODEC_ZSTD_CRC, _CODEC_ZLIB_CRC):
        if len(blob) < 5:
            raise CheckpointCorruptError(
                "truncated checkpoint: blob ends inside the CRC header")
        want = int.from_bytes(blob[1:5], "little")
        body = memoryview(blob)[5:]
        got = zlib.crc32(body) & 0xFFFFFFFF
        if got != want:
            raise CheckpointCorruptError(
                f"payload CRC mismatch (stored {want:#010x}, computed "
                f"{got:#010x}) — the blob is truncated or bit-flipped")
        if tag == _CODEC_ZSTD_CRC:
            if zstandard is None:
                raise RuntimeError("checkpoint is zstd-compressed but the "
                                   "'zstandard' package is not installed")
            return zstandard.ZstdDecompressor().decompress(body)
        return zlib.decompress(body)
    if tag == _CODEC_ZSTD:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "'zstandard' package is not installed")
        return zstandard.ZstdDecompressor().decompress(blob[1:])
    if tag == _CODEC_ZLIB:
        return zlib.decompress(blob[1:])
    if blob[:4] == b"\x28\xb5\x2f\xfd":
        # legacy checkpoint from before the codec tag: a bare zstd frame
        if zstandard is None:
            raise RuntimeError("legacy zstd checkpoint needs the "
                               "'zstandard' package to restore")
        return zstandard.ZstdDecompressor().decompress(blob)
    raise CheckpointCorruptError(f"unknown checkpoint codec tag {tag!r}")


# ---------------------------------------------------------------- trees
def tree_flatten(tree, path=()):
    """(path, leaf) pairs in the reference's `jax.tree` order: dict keys
    sorted, lists/tuples in order, dataclass fields in order, None as no
    leaf; anything else (tensor, ndarray, scalar) is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in tree_flatten(t, path + (i,))]
    if is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in fields(tree)
                for x in tree_flatten(getattr(tree, f.name),
                                      path + (f.name,))]
    return [(path, tree)]


def tree_unflatten(template, leaves):
    """`template` with its leaves replaced, in `tree_flatten` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        if is_dataclass(t) and not isinstance(t, type):
            return replace(t, **{f.name: build(getattr(t, f.name))
                                 for f in fields(t)})
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _to_host(leaf) -> np.ndarray:
    """A host snapshot of one leaf: a copy, never a view of live state."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _pack_leaves(leaves, treedef: str) -> bytes:
    chunks: list = []
    _pack({"treedef": treedef, "leaves": [
        {"dtype": str(a.dtype), "shape": list(a.shape),
         "data": memoryview(np.ascontiguousarray(a).reshape(-1)).cast("B")}
        for a in leaves]}, chunks)
    return _compress_chunks(chunks)


def _unpack_leaves(blob: bytes):
    payload = unpackb(_decompress(blob))
    # .copy(): frombuffer views are read-only; host tables are mutated live
    return [np.frombuffer(l["data"], dtype=np.dtype(l["dtype"])).reshape(
        l["shape"]).copy() for l in payload["leaves"]]


def _treedef(pairs) -> str:
    return "repro_torch:" + ",".join(
        ".".join(str(k) for k in path) for path, _ in pairs)


def _as_template(got: np.ndarray, want):
    """A restored leaf in the template leaf's dtype (and device)."""
    if isinstance(want, torch.Tensor):
        # (np.ascontiguousarray would turn a 0-d leaf into shape (1,))
        t = torch.from_numpy(got if got.flags.c_contiguous else got.copy())
        return t.to(device=want.device, dtype=want.dtype)
    return got.astype(np.asarray(want).dtype)


@dataclass
class CheckpointInfo:
    step: int
    path: Path


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_write: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._pending: list[threading.Thread] = []

    # ------------------------------------------------------------ generic
    def save(self, step: int, tree, meta: dict | None = None,
             aux: dict | None = None):
        """Checkpoint any tree of tensors / arrays (params, optimizer
        state, engine state). The snapshot is taken HERE, on the caller's
        thread (one host copy of every leaf); only encoding, compression
        and the write run on the writer thread when `async_write`.

        `aux` is a flat {name: array} dict of variable-shape host tables
        restored as-is (no template check)."""
        pairs = tree_flatten(tree)
        self._save_leaves(step, [l for _, l in pairs], _treedef(pairs),
                          meta, aux)

    def _save_leaves(self, step, leaves, treedef, meta, aux):
        leaves = [_to_host(l) for l in leaves]
        aux = None if aux is None else {k: _to_host(v)
                                        for k, v in aux.items()}

        def _write():
            blob = _pack_leaves(leaves, treedef)
            tmp = self.dir / f"{step:010d}.ckpt.tmp"
            final = self.dir / f"{step:010d}.ckpt"
            tmp.write_bytes(blob)
            if aux is not None:
                names = sorted(aux)
                (self.dir / f"{step:010d}.aux").write_bytes(
                    _pack_leaves([aux[k] for k in names], "aux"))
                (self.dir / f"{step:010d}.auxnames.json").write_text(
                    json.dumps(names))
            if meta is not None:
                (self.dir / f"{step:010d}.meta.json").write_text(
                    json.dumps(meta))
            tmp.rename(final)
            self._gc()

        if self.async_write:
            t = threading.Thread(target=_write, daemon=True)
            t.start()
            self._pending.append(t)
        else:
            _write()

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _load_leaves(self, info: CheckpointInfo):
        """Decode one blob; any integrity failure surfaces as a
        CheckpointCorruptError carrying step + path."""
        try:
            return _unpack_leaves(info.path.read_bytes())
        except CheckpointCorruptError as e:
            raise CheckpointCorruptError(
                f"corrupt checkpoint at step {info.step} "
                f"({info.path}): {e}") from e
        except RuntimeError:
            raise                          # a zstd blob without zstandard
        except Exception as e:   # zlib.error / msgpack / struct depths
            raise CheckpointCorruptError(
                f"corrupt checkpoint at step {info.step} ({info.path}): "
                f"{type(e).__name__}: {e}") from e

    def checkpoints(self) -> list[CheckpointInfo]:
        return [CheckpointInfo(int(p.stem.split(".")[0]), p)
                for p in sorted(self.dir.glob("*.ckpt"))]

    def _restore_leaves(self, n_leaves: int, step: int | None):
        """(host leaves, step) of the newest readable checkpoint (or of
        `step`): step=None falls back generation by generation with a
        warning when a blob is corrupt; an explicit step raises."""
        infos = ([CheckpointInfo(step, self.dir / f"{step:010d}.ckpt")]
                 if step is not None else list(reversed(self.checkpoints())))
        if not infos:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        errors: list[CheckpointCorruptError] = []
        for info in infos:
            try:
                leaves = self._load_leaves(info)
            except CheckpointCorruptError as e:
                if step is not None:
                    raise
                errors.append(e)
                warnings.warn(f"{e} — falling back to the previous kept "
                              "generation")
                continue
            if len(leaves) != n_leaves:
                raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                                 f"template {n_leaves}")
            return leaves, info.step
        raise errors[0]

    def restore(self, template, step: int | None = None):
        """Restore into the structure of `template` (shape-checked, cast
        to each template leaf's dtype; torch leaves come back on their
        template's device).

        step=None restores the newest checkpoint; if its blob fails the
        integrity check the restore FALLS BACK to the previous kept
        generation (newest -> oldest) with a warning. An explicit step
        raises CheckpointCorruptError instead."""
        t_leaves = [l for _, l in tree_flatten(template)]
        leaves, got_step = self._restore_leaves(len(t_leaves), step)
        out = []
        for got, want in zip(leaves, t_leaves):
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"checkpoint leaf of shape {got.shape}, "
                                 f"template {tuple(want.shape)}")
            out.append(_as_template(got, want))
        return tree_unflatten(template, out), got_step

    def restore_aux(self, step: int | None = None) -> dict:
        info = self.latest() if step is None else CheckpointInfo(
            step, self.dir / f"{step:010d}.ckpt")
        names = json.loads(
            (self.dir / f"{info.step:010d}.auxnames.json").read_text())
        leaves = _unpack_leaves(
            (self.dir / f"{info.step:010d}.aux").read_bytes())
        return dict(zip(names, leaves))

    def latest(self) -> CheckpointInfo | None:
        ckpts = sorted(self.dir.glob("*.ckpt"))
        if not ckpts:
            return None
        p = ckpts[-1]
        return CheckpointInfo(int(p.stem.split(".")[0]), p)

    def _gc(self):
        ckpts = sorted(self.dir.glob("*.ckpt"))
        for p in ckpts[: -self.keep]:
            p.unlink(missing_ok=True)
            stem = p.with_suffix("")
            for suffix in (".meta.json", ".aux", ".auxnames.json"):
                stem.with_suffix(suffix).unlink(missing_ok=True)

    # ----------------------------------------------------------- pipeline
    def save_pipeline(self, step: int, pipe):
        """Full engine snapshot: device state + host partitioner tables.
        Window-pending state (the in-flight events) is inside the layer
        states and held point queries live in the query table, so this is
        the Chandy-Lamport-equivalent cut: a restored pipeline answers
        pending `consistent` queries identically. On a mesh every rank
        calls it; rank 0 writes the gathered global layout (with the
        in-flight rows of a 2-D pipeline's inter-stage ring)."""
        pipe._need_active()
        t = pipe.part.t
        aux = {
            "degree": t.degree, "replicas": t.replicas, "load": t.load,
            "master": t.master, "master_slot": t.master_slot,
            "next_vslot": t.next_vslot, "next_eslot": t.next_eslot,
            "repl_counters": pipe.part._repl_counters,
            "slot_keys": np.asarray([[p, v] for (p, v) in t.slot_of],
                                    np.int64).reshape(-1, 2),
            "slot_vals": np.asarray(list(t.slot_of.values()), np.int64),
            "now": np.asarray(pipe.now),
        }
        pairs = gather_tree(pipe)
        if pipe.mesh is not None and pipe.mesh.rank != 0:
            return
        self._save_leaves(step, [l for _, l in pairs], _treedef(pairs),
                          {"now": pipe.now}, aux)

    def restore_pipeline(self, pipe, step: int | None = None) -> int:
        """Restore a `save_pipeline` checkpoint (either package's, of the
        same configuration) into `pipe`; returns its step. With training
        on, the live parameters are mirrored back into the model, as each
        tick does. On a mesh every rank calls it and takes its own block
        of parts (and, on a 2-D mesh, its stage's rounds and ring slot)."""
        pipe._need_active()
        mesh = pipe.mesh
        if mesh is not None:
            self.wait()                     # rank 0's pending write
            mesh.all_reduce(torch.zeros(1, device=pipe.device))  # barrier
        template = pipeline_tree(pipe)
        pairs = tree_flatten(template)
        leaves, got_step = self._restore_leaves(len(pairs), step)
        grid = _grid(pipe)
        out = []
        for (path, want), got in zip(pairs, leaves):
            kind = _leaf_kind(path)
            shape = _global_shape(kind, tuple(want.shape), *grid[:2])
            if mesh is not None and tuple(got.shape) == shape:
                got = local_block(kind, got, *grid)
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint leaf {'.'.join(map(str, path))} has shape "
                    f"{got.shape}, the pipeline expects {shape}")
            out.append(_as_template(got, want))
        install_tree(pipe, tree_unflatten(template, out))
        h = self.restore_aux(got_step)
        t = pipe.part.t
        t.degree = np.asarray(h["degree"])
        t.replicas = np.asarray(h["replicas"])
        t.load = np.asarray(h["load"])
        t.master = np.asarray(h["master"])
        t.master_slot = np.asarray(h["master_slot"])
        t.next_vslot = np.asarray(h["next_vslot"])
        t.next_eslot = np.asarray(h["next_eslot"])
        pipe.part._repl_counters = np.asarray(h["repl_counters"])
        keys = np.asarray(h["slot_keys"]).reshape(-1, 2)
        vals = np.asarray(h["slot_vals"])
        t.slot_of = {(int(p), int(v)): int(s)
                     for (p, v), s in zip(keys, vals)}
        pipe.now = int(np.asarray(h["now"]))
        return got_step


def pipeline_tree(pipe) -> dict:
    """The reference's checkpoint tree of a pipeline: {"topo", "layers",
    "sink", "sink_seen", "queries", "params", "stage_ring", "train"}, as
    this rank holds it. `params` is the reference's parameter layout
    ({"l<i>": {"self": {"w", "b"}, "neigh": {"w"}}, "head": {"w", "b"}},
    the inverse of `convert.params_from_numpy`); `stage_ring` is None (zero
    leaves) on a 1-D mesh, as in the reference; `train` is None without
    the training plane."""
    from repro_torch.graph.sage import linear_tree
    params = dict(pipe.params)
    head = getattr(pipe.model, "head", None)
    if head is not None:
        params["head"] = linear_tree(head)
    return {"topo": pipe.topo, "layers": list(pipe.states),
            "sink": pipe.sink, "sink_seen": pipe.sink_seen,
            "queries": pipe.queries, "params": params,
            "stage_ring": pipe.stage_ring, "train": pipe.train_state}


def install_tree(pipe, tree) -> None:
    """Put a (local) pipeline tree's state into `pipe`; with training on,
    the live parameters are mirrored into the model, as each tick does."""
    pipe.topo = tree["topo"]
    pipe.states = list(tree["layers"])
    pipe.sink = tree["sink"]
    pipe.sink_seen = tree["sink_seen"]
    pipe.queries = tree["queries"]
    pipe.stage_ring = tree["stage_ring"]
    if tree["train"] is not None:
        pipe.train_state = tree["train"]
        pipe._sync_params_from_train()
    else:
        _load_params(pipe, tree["params"])


def _leaf_kind(path) -> str:
    """How a pipeline-tree leaf lies over a mesh: "layer" (a round
    state's table: sharded over the data axis, one layer per stage),
    "cms" (a round state's sketch: replicated over the data axis, one per
    stage), "part" (sharded over the data axis, the same on every stage),
    "ring" (the inter-stage ring) or "rep" (replicated)."""
    top = path[0]
    if top == "stage_ring":
        return "ring"
    if top == "layers":
        return "cms" if path[-1] == "cms" else "layer"
    if top in ("topo", "sink", "sink_seen", "queries"):
        return "part"
    if top == "train":
        if path[1] in ("labels", "label_mask", "dirty", "touch",
                       "residual"):
            return "part"
        return "part" if path[1] == "opt" and path[2] != "head" else "rep"
    return "rep"                            # params: replicated


def _grid(pipe):
    """(S, D, s, d) of this rank (1, 1, 0, 0 without a mesh)."""
    m = pipe.mesh
    if m is None:
        return 1, 1, 0, 0
    return m.n_stages, m.n_data, m.stage_index, m.data_index


def _global_shape(kind, shape, S, D):
    """The reference's global shape of a local leaf on an S x D grid."""
    if kind == "rep" or (kind == "cms" and S == 1):
        return shape
    if kind == "part" or (kind == "layer" and S == 1):
        return (shape[0] * D,) + shape[1:]
    if kind == "layer":
        return (S, shape[0] * D) + shape[1:]
    if kind == "cms":
        return (S,) + shape
    R, C, W = shape                         # the ring
    return (S, R, D * C, W)


def local_block(kind, got, S, D, s, d):
    """Rank (s, d)'s block of a global leaf of the given kind."""
    if kind == "rep" or (kind == "cms" and S == 1):
        return got
    if kind == "part" or (kind == "layer" and S == 1):
        n = got.shape[0] // D
        return got[d * n:(d + 1) * n]
    if kind == "layer":
        n = got.shape[1] // D
        return got[s, d * n:(d + 1) * n]
    if kind == "cms":
        return got[s]
    C = got.shape[2] // D
    return got[s, :, d * C:(d + 1) * C]


def gather_tree(pipe, kind: str = "all_gather"):
    """(path, leaf) pairs of `pipeline_tree(pipe)` in the reference's
    GLOBAL layout, on every rank of the mesh (collective over its members;
    a pipeline without a mesh is global already). The gathers count under
    `kind` in the mesh's call table."""
    pairs = tree_flatten(pipeline_tree(pipe))
    if pipe.mesh is None:
        return pairs
    return [(path, _gather_leaf(pipe.mesh, path, l, kind))
            for path, l in pairs]


def _gather_leaf(mesh, path, leaf, kind_name="all_gather"):
    """The global layout of one leaf (`_leaf_kind`): one all_gather over
    the axis it is sharded on, none for replicated leaves."""
    kind = _leaf_kind(path)
    S = mesh.n_stages
    if kind == "rep" or (kind == "cms" and S == 1):
        return leaf
    x = leaf.to(torch.uint8) if leaf.dtype == torch.bool else leaf
    n, rest = (leaf.shape[0] if leaf.ndim else 0), tuple(leaf.shape[1:])
    if kind == "part" or (kind == "layer" and S == 1):
        g = mesh.data_view().all_gather(x, kind_name).reshape(
            (mesh.n_data * n,) + rest)
    elif kind == "layer":
        g = mesh.all_gather(x, kind_name).reshape((S, mesh.n_data * n)
                                                   + rest)
    elif kind == "cms":
        g = mesh.stage_view().all_gather(x, kind_name)
    else:                                   # ring [R, C, W] a rank
        R, C, W = leaf.shape
        g = mesh.all_gather(x, kind_name).reshape(
            S, mesh.n_data, R, C, W).permute(
            0, 2, 1, 3, 4).reshape(S, R, mesh.n_data * C, W)
    return g.to(torch.bool) if leaf.dtype == torch.bool else g


def _load_params(pipe, params: dict) -> None:
    from repro_torch.graph.sage import load_linear_tree
    for i, layer in enumerate(pipe.layers):
        layer.load_param_tree(params[f"l{i}"])
    head = getattr(pipe.model, "head", None)
    if head is not None:
        load_linear_tree(head, params["head"])
