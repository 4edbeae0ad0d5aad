"""Client meshes over ``torch.distributed`` ranks: a (pod, data, model)
grid.

The reference lays its FL clients along one axis of a JAX device mesh
(``jax.make_mesh((D, M), ("data", "model"))``, or ``((P, D, M), ("pod",
"data", "model"))`` with pods), splits each client's parameters over the
other axes through their PartitionSpecs, and runs the round step's
aggregation under ``shard_map``.  Here one process is one place in that
grid: rank ``r = (p * D + d) * M + m``, with ``model`` the fastest axis as
in ``jax.make_mesh``, on ``cuda:r`` with NCCL, or on the CPU with gloo
when the caller asks for ``device="cpu"``.  A :class:`Mesh` has the
reference's ``shape`` (``{"data": D, "model": M}``, and ``"pod": P`` first
when the mesh has pods), the rank's coordinate on each axis
(``coord(ax)``) and one process group per axis (``group(ax)``): ``model``,
the M ranks of a (p, d) (tensor parallelism, ``dist.tensor_parallel``);
``data``, the D ranks of a (p, m); ``pod``, the P ranks of a (d, m).  In
``replica`` mode a client is a row of ``data`` (its M ranks), and the data
group is the aggregation group; in ``shared`` mode a client is a pod, the
data group is its FSDP group (``dist.fsdp``) and the pod group the
aggregation group.  An axis that spans every rank uses the default group
(``group`` returns None).

A mesh comes from torchrun's environment (``mesh_from_env``) or from
``spawn``, which starts P x D x M ranks on this host with the ``spawn``
start method over a ``FileStore`` in a fresh temporary directory (no fixed
port, so tests run side by side).  Every process group gets a timeout, so
a hung collective fails instead of waiting forever.

``Mesh.subgroups`` keeps one set of process groups per ``level_groups`` of
an aggregation schedule (client indices along the client axis), the
counterpart of the reference compiling one round step per
``AggSchedule.signature()``; each level's groups are laid out once for
every coordinate of the other axes.  ``torch.distributed`` needs every
rank to create every group, in the same order, so the groups are made
when a schedule's step is built, on every rank.
"""
from __future__ import annotations

import datetime
import itertools
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve
from repro_torch.dist.sharding import mesh_coords

TIMEOUT_S = 600.0       # a collective that waits longer fails


def check_axes(model: int, pods: int = 0):
    if model < 1:
        raise ValueError(f"a model axis of {model}: at least 1")
    if pods < 0:
        raise ValueError(f"{pods} pods: 0 (no pod axis) or more")


class Mesh:
    """This process's place in the (pod, data, model) grid: ``rank`` and
    ``world`` are the process group's, ``coord(ax)`` its index on each
    axis."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, timeout_s: float = TIMEOUT_S, model: int = 1,
                 pods: int = 0):
        self.rank, self.world = rank, world
        self.device, self.backend = device, backend
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.model, self.pods = model, pods
        data = world // (model * max(pods, 1))
        self.shape = ({"pod": pods} if pods else {}) | {"data": data,
                                                        "model": model}
        self._coords = mesh_coords(self.shape, rank)
        self._groups: dict = {}
        self._axis_groups: dict = {}
        for ax in ("model", "data", "pod"):   # every rank, in this order
            if ax in self.shape:                 # None: the default group
                self._axis_groups[ax] = None if self.shape[ax] == world \
                    else self._own_group(self._lines(ax))

    def coord(self, ax: str) -> int:
        """This rank's index on axis ``ax``."""
        return self._coords[ax]

    def group(self, ax: str):
        """The process group of this rank's line along ``ax`` (None: the
        default group, where the axis spans every rank)."""
        return self._axis_groups[ax]

    def rank_of(self, coords: dict) -> int:
        """The rank at ``coords`` (axis -> index; a missing axis is 0)."""
        r = 0
        for ax, n in self.shape.items():
            r = r * n + coords.get(ax, 0)
        return r

    def _lines(self, ax: str, groups=None) -> list:
        """For every coordinate of the other axes (in rank order), and
        within it for every group of ``groups`` (tuples of indices along
        ``ax``; one group of the whole axis by default), that group's
        ranks."""
        others = [a for a in self.shape if a != ax]
        groups = [range(self.shape[ax])] if groups is None else groups
        return [[self.rank_of(dict(zip(others, at)) | {ax: c}) for c in g]
                for at in itertools.product(*(range(self.shape[a])
                                              for a in others))
                for g in groups]

    def _own_group(self, groups):
        cur, _ = dist.new_subgroups_by_enumeration(groups,
                                                   timeout=self.timeout)
        return cur

    def subgroups(self, level_groups, axis: str) -> tuple:
        """This rank's process group at each level of ``level_groups``
        (a tuple per level of tuples of client indices that partition the
        client axis ``axis``), within its line of the other axes, or None
        where its group is itself alone.  Collective: every rank calls it
        with the same arguments, in the same order."""
        key = (axis,) + tuple(tuple(tuple(g) for g in lvl)
                              for lvl in level_groups)
        if key not in self._groups:
            mine, me = [], self.coord(axis)
            for groups in key[1:]:
                cur = self._own_group(self._lines(axis, groups))
                size = next(len(g) for g in groups if me in g)
                mine.append(cur if size > 1 else None)
            self._groups[key] = tuple(mine)
        return self._groups[key]

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=self._wire())
        return box[0]

    def all_max(self, value: float) -> float:
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def _wire(self):
        return self.device if self.backend == "nccl" else None

    def close(self):
        if dist.is_initialized():
            dist.destroy_process_group()


def init_mesh(data: int, model: int = 1, *, rank: int, device="cuda",
              local_rank: int | None = None, store=None,
              init_method: str | None = None,
              timeout_s: float = TIMEOUT_S, pods: int = 0) -> Mesh:
    """Joins the process group of ``pods x data x model`` ranks (no pod
    axis when ``pods`` is 0) as ``rank`` and returns this rank's mesh.  A
    CUDA mesh puts the rank on ``cuda:<local_rank>`` (``rank`` unless
    given) under NCCL; a CPU mesh runs gloo, with one intra-op thread in
    this process.  There is no fallback from one to the other."""
    check_axes(model, pods)
    kind = torch.device(device).type
    if kind == "cuda":
        dev = resolve(torch.device("cuda", rank if local_rank is None
                                   else local_rank))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
        # ranks share the host's cores: with a thread pool each, their
        # spinning workers oversubscribe it (a smoke round runs ~50x slower)
        torch.set_num_threads(1)
    else:
        raise ValueError(f"mesh device {device!r}: cuda or cpu")
    world = max(pods, 1) * data * model
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a ({pods}, {data}, {model}) "
                         "mesh")
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(rank, world, dev, backend, timeout_s, model, pods)


def mesh_from_env(model: int = 1, device="cuda",
                  timeout_s: float = TIMEOUT_S, pods: int = 0) -> Mesh:
    """The mesh of a process that torchrun started (``RANK``,
    ``WORLD_SIZE`` = P x D x ``model``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``)."""
    world = int(os.environ["WORLD_SIZE"])
    per = model * max(pods, 1)
    if world % per:
        raise ValueError(f"{world} processes on a model axis of {model} "
                         f"and {pods} pods")
    return init_mesh(world // per, model,
                     rank=int(os.environ["RANK"]), device=device,
                     local_rank=int(os.environ.get("LOCAL_RANK",
                                                   os.environ["RANK"])),
                     init_method="env://", timeout_s=timeout_s, pods=pods)


def in_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_main(rank, fn, data, model, pods, device, store_path, out_dir,
               timeout_s, args):
    world = max(pods, 1) * data * model
    mesh = init_mesh(data, model, rank=rank, device=device,
                     store=dist.FileStore(store_path, world),
                     timeout_s=timeout_s, pods=pods)
    out = fn(mesh, *args)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close()


def spawn(fn, data: int, args=(), *, model: int = 1, pods: int = 0,
          device="cuda", timeout_s: float = TIMEOUT_S) -> list:
    """Runs ``fn(mesh, *args)`` on the ``pods x data x model`` ranks of a
    mesh started on this host (no pod axis when ``pods`` is 0) and returns
    each rank's result, in rank order.  ``fn`` and ``args`` must pickle (a
    module-level function).  A rank that raises or dies fails the call
    (the others are stopped), and so does a run longer than
    ``timeout_s``."""
    check_axes(model, pods)
    world = max(pods, 1) * data * model
    if torch.device(device).type == "cuda" and \
            world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} CUDA cards, this "
                         f"host has {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, data, model, pods, str(device),
                  os.path.join(tmp, "store"), tmp, timeout_s, tuple(args)))
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                    p.join()
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout_s} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
