"""Rank groups: the port's counterpart of a device mesh.

The reference partitions the packed ``[W, n_pad]`` buffer's columns over
every axis of a ``jax.sharding.Mesh`` (``shard_kernels._flat`` flattens the
axes). The port does the same over a ``torch.distributed`` process group:
rank r of an R-rank group holds column slice r, and the group's size is the
mesh's device count.

``Mesh`` names the group's ranks by axes, as ``jax.make_mesh`` lays
devices out: ``make_host_mesh(group, data=2, model=2)`` reads rank r as
the row-major coordinates ``(r // 2, r % 2)`` over ``("data", "model")``,
and builds one sub-group per axis (the ranks that differ only along it),
through ``dist.new_group`` on every rank in the same order. The sharding
rules (``distributed/sharding.py``) place tensor dims on these axes. A bare
``ProcessGroup`` stays valid wherever a mesh is taken: it is the mesh
``("data",)`` of its size (``as_mesh``).

``spawn_ranks`` starts such a group: R fresh processes (start method
``spawn``), each joining one group through a ``file://`` rendezvous with the
backend and the device it is given. The caller names both; nothing is
chosen for it. ``"gloo"`` runs on the CPU, and also on CUDA tensors for
``all_reduce`` and ``broadcast``, which is all the packed engine needs, so
R ranks can share one card. ``"nccl"`` needs a card per rank.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

#: how long a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """A process group read as a named mesh of ranks (module docstring).

    ``axis_names`` and ``shape`` (axis -> size, in order) are the
    reference's ``mesh.axis_names`` and ``mesh.shape``; ``coords`` is this
    rank's coordinate on each axis; ``axis_group(a)`` is the sub-group of
    the ranks that differ from this one only along ``a``, its ranks in the
    order of their coordinate on ``a``."""

    def __init__(self, group, axis_names: Sequence[str], sizes: Sequence[int]):
        if not isinstance(group, dist.ProcessGroup):
            raise TypeError(f"expected a torch.distributed ProcessGroup, "
                            f"got {type(group).__name__}")
        R = dist.get_world_size(group)
        if math.prod(sizes) != R:
            raise ValueError(f"a mesh of shape {tuple(sizes)} over {R} ranks")
        self.group = group
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(n) for n in sizes)))
        self.size = R
        self.rank = dist.get_rank(group)
        self.coords = self.coords_of(self.rank)
        self._axis_groups = {}
        for a in self.axis_names:  # the same calls in the same order on every rank
            n = self.shape[a]
            if n == 1 or n == R:
                continue
            for r in range(R):
                c = self.coords_of(r)
                if c[a]:
                    continue
                ranks = [self.rank_of({**c, a: i}) for i in range(n)]
                sub = dist.new_group([dist.get_global_rank(group, q) for q in ranks])
                if self.rank in ranks:
                    self._axis_groups[a] = sub

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of group rank ``rank``, row-major."""
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def axis_group(self, axis: str):
        """The sub-group along ``axis`` (``None`` for an axis of size 1)."""
        n = self.shape[axis]
        if n == 1:
            return None
        return self.group if n == self.size else self._axis_groups[axis]

    def __repr__(self) -> str:  # pragma: no cover
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def as_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a bare ``ProcessGroup`` as the mesh ``("data",)``."""
    if isinstance(mesh, Mesh):
        return mesh
    if not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"expected a torch.distributed ProcessGroup or a Mesh, "
                        f"got {type(mesh).__name__}")
    return Mesh(mesh, ("data",), (dist.get_world_size(mesh),))


def make_host_mesh(group, data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """The mesh ``("data", "model")`` of shape ``(data, model)`` over
    ``group`` (``("pod", "data", "model")`` with ``pod`` > 0): the
    counterpart of the reference's ``make_host_mesh``. Every rank of the
    group calls it with the same arguments."""
    if pod:
        return Mesh(group, ("pod", "data", "model"), (pod, data, model))
    return Mesh(group, ("data", "model"), (data, model))


def make_production_mesh(group, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes over ``group``: ``(16, 16)`` over
    ``("data", "model")`` (256 ranks), or with ``multi_pod`` ``(2, 16, 16)``
    over ``("pod", "data", "model")`` (512). The dry-run builds them on a
    ``"fake"`` process group of that size (``launch/dryrun.activate``)."""
    if multi_pod:
        return make_host_mesh(group, data=16, model=16, pod=2)
    return make_host_mesh(group, data=16, model=16)


def worker_axes(mesh) -> Tuple[str, ...]:
    """The axes the workers split over: ``pod`` and ``data``, where present."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def n_workers(mesh) -> int:
    """The number of worker groups: the product of the worker axes' sizes."""
    return math.prod(mesh.shape[a] for a in worker_axes(mesh))


def n_devices(group) -> int:
    """The number of ranks in ``group`` or mesh (the mesh's device count)."""
    if isinstance(group, Mesh):
        return group.size
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"expected a torch.distributed ProcessGroup, got {type(group).__name__}")
    return dist.get_world_size(group)


def _to_host(obj):
    """Tensors in ``obj`` (nested dicts, lists, tuples) as numpy arrays, so a
    result pickles without the sending process staying alive."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, world_size: int, backend: str, device: str, init_method: str,
               fn: Callable, args: tuple, results) -> None:
    try:
        # the ranks share the host's cores: each gets an equal share for its
        # intra-op threads (more would oversubscribe the cores and stall)
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=COLLECTIVE_TIMEOUT)
        try:
            out = _to_host(fn(rank, dist.group.WORLD, dev, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, world_size: int, *, backend: str, devices: Sequence[str],
                args: tuple = (), timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(rank, group, device, *args)`` in ``world_size`` new processes
    that form one process group, and return the ranks' results in rank
    order (tensors come back as numpy arrays).

    ``fn`` must be importable by name (a module-level function), and so must
    ``args``. ``devices[r]`` is rank r's device (``"cpu"``, ``"cuda:0"``, ...).
    The rendezvous file lies in a new temporary directory. If any rank
    raises or dies, the other ranks are stopped and
    ``RuntimeError`` carries the failing rank's traceback; every process is
    ended before this returns."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = multiprocessing.get_context("spawn")
    tmpdir = tempfile.TemporaryDirectory(prefix="repro_torch_rdzv_")
    init_method = "file://" + os.path.join(tmpdir.name, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, devices[r], init_method, fn, args,
                               results))
             for r in range(world_size)]
    out: List[Any] = [None] * world_size
    pending = set(range(world_size))
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while pending:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode} before it reported")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(pending)} did not finish in "
                                       f"{timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            out[rank] = payload
            pending.discard(rank)
    finally:
        for p in procs:
            if p.is_alive() and pending:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        tmpdir.cleanup()
    return out
