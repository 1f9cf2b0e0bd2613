"""Rank groups: the port's counterpart of a device mesh.

The reference partitions the packed ``[W, n_pad]`` buffer's columns over
every axis of a ``jax.sharding.Mesh`` (``shard_kernels._flat`` flattens the
axes). The port does the same over a ``torch.distributed`` process group:
rank r of an R-rank group holds column slice r, and the group's size is the
mesh's device count.

``spawn_ranks`` starts such a group: R fresh processes (start method
``spawn``), each joining one group through a ``file://`` rendezvous with the
backend and the device it is given. The caller names both; nothing is
chosen for it. ``"gloo"`` runs on the CPU, and also on CUDA tensors for
``all_reduce`` and ``broadcast``, which is all the packed engine needs, so
R ranks can share one card. ``"nccl"`` needs a card per rank.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

#: how long a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def n_devices(group) -> int:
    """The number of ranks in ``group`` (the mesh's device count)."""
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
