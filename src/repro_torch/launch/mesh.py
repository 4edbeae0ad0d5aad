"""Client meshes over ``torch.distributed`` ranks.

The reference lays its FL clients along the ``data`` axis of a JAX device
mesh (``make_host_mesh``) and runs the round step's body under
``shard_map``.  Here one process is one client: rank r of a process group
is client r, on ``cuda:r`` with NCCL, or on the CPU with gloo when the
caller asks for ``device="cpu"``.  A :class:`Mesh` has the reference's
``shape``, ``{"data": world, "model": 1}``.  A ``model``
axis above 1 (tensor or expert parallelism inside a client) and the
``pod`` axis of ``shared`` mode are ROADMAP item 5b, and raise.

A mesh comes from torchrun's environment (``mesh_from_env``) or from
``spawn``, which starts ``data`` ranks on this host with the ``spawn``
start method over a ``FileStore`` in a fresh temporary directory (no fixed
port, so tests run side by side).  Every process group gets a timeout, so
a hung collective fails instead of waiting forever.

``Mesh.subgroups`` keeps one set of process groups per ``level_groups`` of
an aggregation schedule, the counterpart of the reference compiling one
round step per ``AggSchedule.signature()``.  ``torch.distributed`` needs
every rank to create every group, in the same order, so the groups are
made when a schedule's step is built, on every rank.
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
    if model != 1 or pods:
        raise NotImplementedError(
            f"a model axis of {model} and {pods} pods: tensor and expert "
            "parallelism inside a client and the shared (FSDP) mode are "
            "ROADMAP item 5b; this mesh takes model=1 and no pods")


class Mesh:
    """This process's place in the client mesh: ``rank`` is its client."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, timeout_s: float = TIMEOUT_S):
        self.rank, self.world = rank, world
        self.device, self.backend = device, backend
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self._groups: dict = {}

    @property
    def shape(self) -> dict:
        return {"data": self.world, "model": 1}

    def subgroups(self, level_groups) -> tuple:
        """This rank's process group at each level of ``level_groups``
        (a tuple per level of tuples of ranks that partition the axis), or
        None where its group is itself alone.  Collective: every rank calls
        it with the same argument, in the same order."""
        key = tuple(tuple(tuple(g) for g in lvl) for lvl in level_groups)
        if key not in self._groups:
            mine = []
            for groups in key:
                cur, _ = dist.new_subgroups_by_enumeration(
                    [list(g) for g in groups], timeout=self.timeout)
                size = next(len(g) for g in groups if self.rank in g)
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
    """Joins the process group of ``data`` ranks as ``rank`` and returns
    this rank's mesh.  A CUDA mesh puts the rank on ``cuda:<local_rank>``
    (``rank`` unless given) under NCCL; a CPU mesh runs gloo, with one
    intra-op thread in this process.  There is no fallback from one to the
    other."""
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
    if not 0 <= rank < data:
        raise ValueError(f"rank {rank} outside a data axis of {data}")
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=data,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(rank, data, dev, backend, timeout_s)


def mesh_from_env(model: int = 1, device="cuda",
                  timeout_s: float = TIMEOUT_S) -> Mesh:
    """The mesh of a process that torchrun started (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)."""
    return init_mesh(int(os.environ["WORLD_SIZE"]), model,
                     rank=int(os.environ["RANK"]), device=device,
                     local_rank=int(os.environ.get("LOCAL_RANK",
                                                   os.environ["RANK"])),
                     init_method="env://", timeout_s=timeout_s)


def in_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_main(rank, fn, data, device, store_path, out_dir, timeout_s,
               args):
    mesh = init_mesh(data, rank=rank, device=device,
                     store=dist.FileStore(store_path, data),
                     timeout_s=timeout_s)
    out = fn(mesh, *args)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close()


def spawn(fn, data: int, args=(), *, device="cuda",
          timeout_s: float = TIMEOUT_S) -> list:
    """Runs ``fn(mesh, *args)`` on ``data`` ranks started on this host and
    returns each rank's result, in rank order.  ``fn`` and ``args`` must
    pickle (a module-level function).  A rank that raises or dies fails the
    call (the others are stopped), and so does a run longer than
    ``timeout_s``."""
    if torch.device(device).type == "cuda" and \
            data > torch.cuda.device_count():
        raise ValueError(f"{data} ranks need {data} CUDA cards, this host "
                         f"has {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=data, join=False, start_method="spawn",
            args=(fn, data, str(device), os.path.join(tmp, "store"), tmp,
                  timeout_s, tuple(args)))
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                    p.join()
                raise TimeoutError(f"{data} ranks did not finish within "
                                   f"{timeout_s} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(data)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
