"""Client meshes over ``torch.distributed`` ranks: a (data, model) grid.

The reference lays its FL clients along the ``data`` axis of a JAX device
mesh (``jax.make_mesh((D, M), ("data", "model"))``), splits each client's
parameters over the ``model`` axis through their PartitionSpecs, and runs
the round step's aggregation under ``shard_map``.  Here one process is one
(client, model shard) pair: rank ``r = d * M + m`` holds model shard m of
client d, with ``model`` the faster axis as in ``jax.make_mesh``, on
``cuda:r`` with NCCL, or on the CPU with gloo when the caller asks for
``device="cpu"``.  Client d owns ranks ``d*M .. d*M + M - 1``.  A
:class:`Mesh` has the reference's ``shape``, ``{"data": D, "model": M}``,
and two process groups of its own: ``model_group``, the M ranks of its
client (the collectives of tensor parallelism, ``dist.tensor_parallel``),
and ``data_group``, the D ranks of its model column (the aggregation and
the loss mean).  With M = 1 the data group is the default group and there
is no model group, so the rank path of one client a rank is unchanged.
The ``pod`` axis of ``shared`` mode is ROADMAP item 5b-iii, and raises.

A mesh comes from torchrun's environment (``mesh_from_env``) or from
``spawn``, which starts D x M ranks on this host with the ``spawn`` start
method over a ``FileStore`` in a fresh temporary directory (no fixed port,
so tests run side by side).  Every process group gets a timeout, so a hung
collective fails instead of waiting forever.

``Mesh.subgroups`` keeps one set of process groups per ``level_groups`` of
an aggregation schedule (client indices), the counterpart of the reference
compiling one round step per ``AggSchedule.signature()``; each level's
groups are laid out once for every model column.  ``torch.distributed``
needs every rank to create every group, in the same order, so the groups
are made when a schedule's step is built, on every rank.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve

TIMEOUT_S = 600.0       # a collective that waits longer fails


def check_axes(model: int, pods: int = 0):
    if model < 1:
        raise ValueError(f"a model axis of {model}: at least 1")
    if pods:
        raise NotImplementedError(
            f"{pods} pods: the shared (FSDP) mode, one client a pod, is "
            "ROADMAP item 5b-iii; this mesh takes a (data, model) grid")


class Mesh:
    """This process's place in the (data, model) grid: ``rank`` and
    ``world`` are the process group's, ``data_rank`` is its client and
    ``model_rank`` its shard of that client."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, timeout_s: float = TIMEOUT_S, model: int = 1):
        self.rank, self.world = rank, world
        self.device, self.backend = device, backend
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.model = model
        self.data_rank, self.model_rank = divmod(rank, model)
        self._groups: dict = {}
        self.model_group = self.data_group = None
        if model > 1:           # every rank makes every group, in order
            self.model_group = self._own_group(
                [[d * model + m for m in range(model)]
                 for d in range(world // model)])
            self.data_group = self._own_group(
                [[d * model + m for d in range(world // model)]
                 for m in range(model)])

    @property
    def shape(self) -> dict:
        return {"data": self.world // self.model, "model": self.model}

    def _own_group(self, groups):
        cur, _ = dist.new_subgroups_by_enumeration(groups,
                                                   timeout=self.timeout)
        return cur

    def subgroups(self, level_groups) -> tuple:
        """This rank's process group at each level of ``level_groups``
        (a tuple per level of tuples of client indices that partition the
        data axis), within its model column, or None where its group is
        itself alone.  Collective: every rank calls it with the same
        argument, in the same order."""
        key = tuple(tuple(tuple(g) for g in lvl) for lvl in level_groups)
        if key not in self._groups:
            M, mine = self.model, []
            for groups in key:
                cur = self._own_group([[c * M + m for c in g]
                                       for m in range(M) for g in groups])
                size = next(len(g) for g in groups if self.data_rank in g)
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
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """Joins the process group of ``data x model`` ranks as ``rank`` and
    returns this rank's mesh.  A CUDA mesh puts the rank on
    ``cuda:<local_rank>`` (``rank`` unless given) under NCCL; a CPU mesh
    runs gloo, with one intra-op thread in this process.  There is no
    fallback from one to the other."""
    check_axes(model)
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
    world = data * model
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a ({data}, {model}) mesh")
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(rank, world, dev, backend, timeout_s, model)


def mesh_from_env(model: int = 1, device="cuda",
                  timeout_s: float = TIMEOUT_S) -> Mesh:
    """The mesh of a process that torchrun started (``RANK``,
    ``WORLD_SIZE`` = D x ``model``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``)."""
    world = int(os.environ["WORLD_SIZE"])
    if world % model:
        raise ValueError(f"{world} processes on a model axis of {model}")
    return init_mesh(world // model, model,
                     rank=int(os.environ["RANK"]), device=device,
                     local_rank=int(os.environ.get("LOCAL_RANK",
                                                   os.environ["RANK"])),
                     init_method="env://", timeout_s=timeout_s)


def in_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_main(rank, fn, data, model, device, store_path, out_dir,
               timeout_s, args):
    mesh = init_mesh(data, model, rank=rank, device=device,
                     store=dist.FileStore(store_path, data * model),
                     timeout_s=timeout_s)
    out = fn(mesh, *args)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close()


def spawn(fn, data: int, args=(), *, model: int = 1, device="cuda",
          timeout_s: float = TIMEOUT_S) -> list:
    """Runs ``fn(mesh, *args)`` on the ``data x model`` ranks of a mesh
    started on this host and returns each rank's result, in rank order.
    ``fn`` and ``args`` must pickle (a module-level function).  A rank that
    raises or dies fails the call (the others are stopped), and so does a
    run longer than ``timeout_s``."""
    check_axes(model)
    world = data * model
    if torch.device(device).type == "cuda" and \
            world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} CUDA cards, this "
                         f"host has {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, data, model, str(device), os.path.join(tmp, "store"),
                  tmp, timeout_s, tuple(args)))
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
