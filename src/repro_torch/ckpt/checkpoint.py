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
A leaf is never split, and a shard is closed once it holds 64 MB; so a
leaf holds at most 4 GiB (one msgpack bin32), which the full-width
client-stacked bank exceeds (ROADMAP).

Restore checks each leaf's shape and dtype against the live state and
copies into its tensors in place, shard by shard, so two states never sit
on the card at once.

Up to ``WORKERS`` shards are compressed (or read back and decompressed) at
once by threads, since zstd and zlib release the GIL; each is written (or
copied into the state) as soon as it is done, in whatever order they
finish. Each shard's bytes are those a single thread writes.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import msgpack
import torch

from repro_torch import tree as T

try:
    import zstandard as zstd
    CODEC = "zstd"
    # a (de)compressor object is not safe to share between threads
    def _comp(b): return zstd.ZstdCompressor(level=3).compress(b)
    def _decomp(b): return zstd.ZstdDecompressor().decompress(b)
except ImportError:  # pragma: no cover - the reference's zlib fallback
    import zlib
    CODEC = "zlib"
    def _comp(b): return zlib.compress(b, 3)
    def _decomp(b): return zlib.decompress(b)

SHARD_BYTES = 64 * 1024 * 1024
LEAF_BYTES_MAX = 2 ** 32 - 1    # one msgpack bin32 payload
WORKERS = min(8, os.cpu_count() or 1)


def _pack(items) -> bytes:
    return _comp(msgpack.packb(items, use_bin_type=True))

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


def _raw(t: torch.Tensor) -> tuple[str, bytes]:
    """(on-disk dtype, raw bytes) of a tensor."""
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().tobytes()
    if t.dtype not in _NP:
        raise TypeError(f"checkpoint: no on-disk dtype for {t.dtype}")
    return _NP[t.dtype], t.numpy().tobytes()


def check_leaf_sizes(state):
    """Raises ValueError when a leaf of ``state`` is larger than the format
    holds, before anything is written (a trainer calls it before its first
    round)."""
    for p, leaf in T.leaves_with_path(state):
        t = _as_tensor(leaf)
        if t.numel() * t.element_size() > LEAF_BYTES_MAX:
            raise ValueError(
                f"checkpoint leaf {'/'.join(p)} holds "
                f"{t.numel() * t.element_size()} bytes; the format holds "
                f"at most {LEAF_BYTES_MAX} a leaf")


def save_checkpoint(path: str, state, meta: dict | None = None) -> str:
    """state: tree of tensors (and an int step).  Returns the committed
    directory."""
    check_leaf_sizes(state)
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
            dt, raw = _raw(t)
            manifest["leaves"].append({"i": i, "shape": list(t.shape),
                                       "dtype": dt, "shard": shard_idx})
            shard.append({"i": i, "data": raw})
            shard_size += len(raw)
            if shard_size >= SHARD_BYTES:
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
        return msgpack.unpackb(_decomp(f.read()), raw=False)


def _items(path: str, manifest: dict):
    """(leaf spec, CPU tensor) for every leaf, shard by shard in the order
    the shards finish decompressing, at most ``WORKERS`` read ahead."""
    specs = manifest["leaves"]
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
                yield from _tensors(specs, items.result())


def _tensors(specs, items):
    """(leaf spec, CPU tensor) for each leaf of one unpacked shard."""
    for item in items:
        spec = specs[item["i"]]
        bf16 = spec["dtype"] == "bfloat16"
        dt = torch.int16 if bf16 else _TORCH[spec["dtype"]]
        t = torch.frombuffer(bytearray(item["data"]), dtype=dt) \
            if item["data"] else torch.empty((0,), dtype=dt)
        if bf16:
            t = t.view(torch.bfloat16)
        yield spec, t.reshape(spec["shape"])


def load_checkpoint(path: str):
    """-> (leaves as CPU tensors in file order, meta)."""
    manifest = _manifest(path)
    leaves = [None] * manifest["n_leaves"]
    for spec, t in _items(path, manifest):
        leaves[spec["i"]] = t
    return leaves, manifest["meta"]


def restore_checkpoint(path: str, state) -> dict:
    """Copy a checkpoint into ``state`` in place (its tensors keep their
    storage and device; its int step is replaced).  Every leaf's shape and
    dtype is checked against the live state before anything is copied.
    Returns the meta."""
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
    for spec, t in _items(path, manifest):
        i = spec["i"]
        if torch.is_tensor(leaves[i]):
            live[i].copy_(t)
        else:
            node = state
            for k in paths[i][:-1]:
                node = node[k]
            node[paths[i][-1]] = int(t)
    return manifest["meta"]
