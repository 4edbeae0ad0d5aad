"""Checkpoints of a train state: msgpack + zstd shards, atomic rename, in the
JAX package's on-disk format, so a checkpoint written by either package
restores into the other.

Layout:
    <dir>/step_<n>/manifest.json        tree structure + shapes/dtypes
    <dir>/step_<n>/shard_<i>.bin        zstd(msgpack) leaf payloads
    <dir>/step_<n>/COMMITTED            written last (atomicity marker)

Leaves are written in ``jax.tree_util.tree_flatten`` order (sorted dict
keys, ``tree.leaves``' order): for a train state ``opt/m/...``,
``opt/v/...``, ``params/...``, ``step``.  bf16 is stored as its raw 16-bit
words under dtype ``"bfloat16"``; the step, a Python int in the port's
state, as an int32 0-d array, as the reference's ``init_state`` makes it.
A leaf is one msgpack item ``{"i", "data"}``, and a shard is closed once it
holds ``SHARD_BYTES``.

Parts.  One msgpack bin32 payload holds at most 4 GiB
(``LEAF_BYTES_MAX``), which a full-width client-stacked leaf can exceed
(qwen2-7b's K = 4 embedding is 4.36 GB in bf16, each of its AdamW moments
8.72 GB).  Such a leaf is written as parts of one shard's size, each its
own item ``{"i", "part", "data"}`` holding elements ``[start, stop)`` of
the leaf's flat view, and each part closes its shard; the leaf's manifest
entry lists them under ``"parts"`` (``start``, ``stop``, ``shard``).  A
checkpoint whose leaves all fit is the reference's format byte for byte.
The reference's reader cannot take a split leaf: it keeps the last part it
reads for the leaf and its ``reshape`` raises.

Codec.  Shards are written with zstd where ``zstandard`` imports and with
zlib otherwise, as the reference writes them, and the manifest does not
say which.  The reader takes either, by each shard's first bytes (zstd
``28 B5 2F FD``, zlib ``78``); a zstd shard where ``zstandard`` is missing
raises an error that says so.

Restore checks each leaf's shape and dtype, and that a split leaf's parts
cover it with no gap and no overlap, against the live state before
anything is copied; then it copies into its tensors in place (a part into
its span of the leaf's flat view), shard by shard, so two states never sit
on the card at once and no split leaf is assembled on the host.

Up to ``WORKERS`` shards are compressed (or read back and decompressed) at
once by threads, since zstd and zlib release the GIL; each is written (or
copied into the state) as soon as it is done, in whatever order they
finish. Each shard's bytes are those a single thread writes.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import msgpack
import torch

from repro_torch import tree as T

try:
    import zstandard as zstd
    CODEC = "zstd"
    # a compressor object is not safe to share between threads
    def _comp(b): return zstd.ZstdCompressor(level=3).compress(b)
except ImportError:  # pragma: no cover - the reference's zlib fallback
    CODEC = "zlib"
    def _comp(b): return zlib.compress(b, 3)

SHARD_BYTES = 64 * 1024 * 1024
LEAF_BYTES_MAX = 2 ** 32 - 1    # one msgpack bin32 payload
WORKERS = min(8, os.cpu_count() or 1)
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
ZLIB_MAGIC = b"\x78"          # deflate with a 32 KiB window: every level


def _pack(items) -> bytes:
    return _comp(msgpack.packb(items, use_bin_type=True))


def _decompress(blob: bytes, path: str) -> bytes:
    """``blob`` decompressed by the codec its first bytes name."""
    if blob[:4] == ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise ImportError(f"checkpoint shard {path} is zstd-compressed "
                              "and zstandard is not installed") from None
        return zstandard.ZstdDecompressor().decompress(blob)
    if blob[:1] == ZLIB_MAGIC:
        return zlib.decompress(blob)
    raise ValueError(f"checkpoint shard {path} is neither zstd nor zlib "
                     f"(first bytes {blob[:4].hex()})")


_NP = {torch.float32: "float32", torch.float16: "float16",
       torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
       torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {v: k for k, v in _NP.items()}
_TORCH["bfloat16"] = torch.bfloat16


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts."""
    def one(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {one(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({one(tree)})"


def _as_tensor(leaf) -> torch.Tensor:
    if torch.is_tensor(leaf):
        return leaf.detach()
    return torch.tensor(leaf, dtype=torch.int32)   # the step counter


def _dtype(t: torch.Tensor) -> str:
    """The on-disk dtype of a tensor."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    if t.dtype not in _NP:
        raise TypeError(f"checkpoint: no on-disk dtype for {t.dtype}")
    return _NP[t.dtype]


def _raw(t: torch.Tensor) -> bytes:
    """The raw bytes of a tensor (bf16 as its 16-bit words)."""
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save_checkpoint(path: str, state, meta: dict | None = None) -> str:
    """state: tree of tensors (and an int step).  Returns the committed
    directory."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    leaves = T.leaves(state)
    manifest = {"treedef": treedef_str(state), "n_leaves": len(leaves),
                "meta": meta or {}, "leaves": [], "shards": []}
    shard, shard_size, shard_idx = [], 0, 0
    pending = {}               # future blob -> its file name

    def write(keep):
        """Writes finished shards until at most ``keep`` are pending."""
        while len(pending) > keep:
            done, _ = wait(pending, return_when=FIRST_COMPLETED)
            for blob in done:
                with open(os.path.join(tmp, pending.pop(blob)), "wb") as f:
                    f.write(blob.result())

    def flush():
        nonlocal shard, shard_size, shard_idx
        if not shard:
            return
        fn = f"shard_{shard_idx}.bin"
        pending[pool.submit(_pack, shard)] = fn
        manifest["shards"].append(fn)
        shard, shard_size, shard_idx = [], 0, shard_idx + 1
        write(WORKERS)                 # bounds the shards held in memory

    with ThreadPoolExecutor(WORKERS) as pool:
        for i, leaf in enumerate(leaves):
            t = _as_tensor(leaf)
            spec = {"i": i, "shape": list(t.shape), "dtype": _dtype(t),
                    "shard": shard_idx}
            manifest["leaves"].append(spec)
            if t.numel() * t.element_size() <= LEAF_BYTES_MAX:
                raw = _raw(t)
                shard.append({"i": i, "data": raw})
                shard_size += len(raw)
                if shard_size >= SHARD_BYTES:
                    flush()
                continue
            # parts of one shard's size, each closing its shard
            flat = t.reshape(-1)
            step = max(1, min(SHARD_BYTES, LEAF_BYTES_MAX)
                       // t.element_size())
            spec["parts"] = []
            for j, e0 in enumerate(range(0, flat.numel(), step)):
                e1 = min(e0 + step, flat.numel())
                spec["parts"].append({"start": e0, "stop": e1,
                                      "shard": shard_idx})
                shard.append({"i": i, "part": j,
                              "data": _raw(flat[e0:e1])})
                flush()
        flush()
        write(0)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, "COMMITTED"))


def _manifest(path: str) -> dict:
    if not is_committed(path):
        raise IOError(f"checkpoint {path} not committed")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _unpack(path: str):
    with open(path, "rb") as f:
        return msgpack.unpackb(_decompress(f.read(), path), raw=False)


def _check_parts(path: str, manifest: dict):
    """Raises ValueError unless every split leaf's parts, in order, cover
    its elements with no gap and no overlap, each in a listed shard."""
    n_shards = len(manifest["shards"])
    for spec in manifest["leaves"]:
        if "parts" not in spec:
            continue
        numel, at = math.prod(spec["shape"]), 0
        for j, part in enumerate(spec["parts"]):
            if (part["start"] != at or part["stop"] <= at
                    or not 0 <= part["shard"] < n_shards):
                raise ValueError(
                    f"checkpoint {path}: leaf {spec['i']}'s part {j} holds "
                    f"[{part['start']}, {part['stop']}) in shard "
                    f"{part['shard']}; the parts before it end at {at}")
            at = part["stop"]
        if at != numel:
            raise ValueError(f"checkpoint {path}: leaf {spec['i']}'s parts "
                             f"end at {at} of its {numel} elements")


def _items(path: str, manifest: dict):
    """(leaf spec, span, CPU tensor) for every item: ``span`` None and the
    tensor in the leaf's shape for a whole leaf, ``(start, stop)`` and the
    flat elements for a part; shard by shard in the order the shards
    finish decompressing, at most ``WORKERS`` read ahead.  Raises IOError
    at the end if an item never came."""
    specs = manifest["leaves"]
    want = {(s["i"], j) for s in specs
            for j in (range(len(s["parts"])) if "parts" in s else [None])}
    names = iter(manifest["shards"])
    with ThreadPoolExecutor(WORKERS) as pool:
        pending = {pool.submit(_unpack, os.path.join(path, fn))
                   for _, fn in zip(range(WORKERS), names)}
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for items in done:
                fn = next(names, None)
                if fn is not None:
                    pending.add(pool.submit(_unpack, os.path.join(path, fn)))
                for item in items.result():
                    want.discard((item["i"], item.get("part")))
                    yield _tensor(specs[item["i"]], item)
    if want:
        raise IOError(f"checkpoint {path}: no data for (leaf, part) "
                      f"{sorted(want, key=str)[:4]}")


def _tensor(spec, item):
    """(spec, span, CPU tensor) of one unpacked item (see ``_items``)."""
    bf16 = spec["dtype"] == "bfloat16"
    dt = torch.int16 if bf16 else _TORCH[spec["dtype"]]
    t = torch.frombuffer(bytearray(item["data"]), dtype=dt) \
        if item["data"] else torch.empty((0,), dtype=dt)
    if bf16:
        t = t.view(torch.bfloat16)
    if "part" not in item:
        return spec, None, t.reshape(spec["shape"])
    part = spec["parts"][item["part"]]
    span = (part["start"], part["stop"])
    if t.numel() != span[1] - span[0]:
        raise ValueError(f"leaf {spec['i']}'s part {item['part']} holds "
                         f"{t.numel()} elements, its span {span}")
    return spec, span, t


def load_checkpoint(path: str):
    """-> (leaves as CPU tensors in file order, meta)."""
    manifest = _manifest(path)
    _check_parts(path, manifest)
    leaves = [None] * manifest["n_leaves"]
    for spec, span, t in _items(path, manifest):
        i = spec["i"]
        if span is None:
            leaves[i] = t
            continue
        if leaves[i] is None:
            leaves[i] = torch.empty(spec["shape"], dtype=t.dtype)
        leaves[i].view(-1)[span[0]:span[1]].copy_(t)
    return leaves, manifest["meta"]


def restore_checkpoint(path: str, state) -> dict:
    """Copy a checkpoint into ``state`` in place (its tensors keep their
    storage and device; its int step is replaced).  Every leaf's shape and
    dtype, and the parts of a split leaf, are checked against the live
    state before anything is copied.  Returns the meta."""
    manifest = _manifest(path)
    paths, leaves = zip(*T.leaves_with_path(state))
    live = [_as_tensor(leaf) for leaf in leaves]
    if manifest["n_leaves"] != len(live):
        raise ValueError(f"checkpoint {path} has {manifest['n_leaves']} "
                         f"leaves, the state {len(live)}")
    for spec, p, t in zip(manifest["leaves"], paths, live):
        if (tuple(spec["shape"]) != tuple(t.shape)
                or _TORCH.get(spec["dtype"]) != t.dtype):
            raise ValueError(
                f"checkpoint leaf {'/'.join(p)}: {spec['shape']} "
                f"{spec['dtype']}, live {list(t.shape)} {t.dtype}")
    _check_parts(path, manifest)
    for spec, span, t in _items(path, manifest):
        i = spec["i"]
        if span is not None:
            live[i].view(-1)[span[0]:span[1]].copy_(t)
        elif torch.is_tensor(leaves[i]):
            live[i].copy_(t)
        else:
            node = state
            for k in paths[i][:-1]:
                node = node[k]
            node[paths[i][-1]] = int(t)
    return manifest["meta"]
