"""The aggregation kernels partitioned over a group of ranks.

Port of ``repro/distributed/shard_kernels.py``. There, ``shard_map`` hands
each device its COLUMN slice of the packed ``[W, n_pad]`` buffer (worker
rows replicated) and the wrappers finish with a ``psum`` where the math
reduces over columns. Here each rank of a ``torch.distributed`` group holds
its slice as an ordinary tensor, and a function below receives what the
reference's ``shard_map`` body receives:

  gram / residual_norms / the fused-CCLIP residual output
      column reductions  -> local kernel + ``all_reduce`` over the group;
  mix_apply / cm_aggregate / tm_aggregate / coordinatewise_combine / the
      fused-CCLIP centre output
      column-local       -> local kernel, no collective; the output STAYS
      column-sharded (rank r holds slice r).

``shard_cols`` lays a global ``[..., n]`` tensor out this way (``_pad_cols``
first zero-pads ``n`` up to a multiple of the group's size, so slices are
equal; zero columns add 0 to every reduction); ``rows_to_cols`` does it for
a stack whose worker rows are spread over the ranks (one ``all_to_all``,
``exchange``: the reference's ``_colshard`` of a worker-sharded stack);
``unshard_cols`` replicates a column-sharded result: one ``all_reduce`` of
a zero-filled row into which each rank has written its own slice (gloo has
no CUDA ``all_gather``; adding zeros is exact). The all-reduces run on the
tensors' own device; gloo's ``all_to_all`` is staged through the host
(``exchange``).

Numerics: the ranks' partial sums are added in the collective's order, so
reductions match the single-device kernels to fp32 tolerance, not bit for
bit. Column-local results do match bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.launch.mesh import as_mesh, n_devices


def _flat(mesh):
    """Every axis of ``mesh`` (a ``Mesh`` or a bare group, the mesh
    ``("data",)``) as one spec entry: a tuple, or the one name."""
    axes = as_mesh(mesh).axis_names
    return axes if len(axes) > 1 else axes[0]


def col_spec(mesh) -> tuple:
    """``[W, n]`` with the column axis over ALL mesh axes, the layout
    ``shard_cols`` gives: the reference's ``col_spec`` as the port's tuple
    spec (``sharding.Placement``)."""
    return (None, _flat(mesh))


def vec_spec(mesh) -> tuple:
    """``[n]`` laid over ALL mesh axes: the reference's ``vec_spec``."""
    return (_flat(mesh),)


def _pad_cols(x: torch.Tensor, group) -> Tuple[torch.Tensor, int]:
    """Zero-pad the last axis up to a multiple of the group's size. Returns
    ``(padded, original_n)``."""
    n_dev = n_devices(group)
    n = x.shape[-1]
    n_up = -(-n // n_dev) * n_dev
    if n_up == n:
        return x, n
    return torch.nn.functional.pad(x, (0, n_up - n)), n


def shard_cols(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's (contiguous) column slice of the zero-padded ``x``, in
    ``x``'s dtype (a 16-bit leaf is padded and sliced as 16-bit columns)."""
    x, _ = _pad_cols(x, group)
    n_local = x.shape[-1] // n_devices(group)
    r = dist.get_rank(group)
    return x[..., r * n_local:(r + 1) * n_local].contiguous()


def exchange(send: torch.Tensor, send_sizes, recv_sizes, group) -> torch.Tensor:
    """One ``all_to_all``: ``send`` holds, in rank order, ``send_sizes[q]``
    elements for each rank q; the result holds ``recv_sizes[r]`` from each
    rank r, in rank order, on ``send``'s device.

    gloo's ``all_to_all`` takes CPU tensors only: handed a CUDA tensor it
    writes the device pointer to its socket and the process aborts
    (``writev ... Bad address``; torch 2.11 with CUDA 12.8 on an H100). So
    under gloo the exchange always runs on a host copy; any other backend
    exchanges on the tensors' own device: NCCL, and the ``"fake"`` backend
    of the dry-run (``launch/dryrun.py``), which so traces the route a
    multi-card NCCL run takes."""
    host = dist.get_backend(group) == "gloo" and send.device.type != "cpu"
    src = send.cpu() if host else send
    recv = torch.empty(sum(recv_sizes), dtype=send.dtype, device=src.device)
    dist.all_to_all_single(recv, src.contiguous(), list(recv_sizes), list(send_sizes),
                           group=group)
    return recv.to(send.device)


def rows_to_cols(rows: torch.Tensor, group, senders: Optional[Sequence[int]] = None
                 ) -> torch.Tensor:
    """The worker-sharded ingress: from this rank's rows ``[w, n]`` of a
    global ``[W, n]`` stack to its column slice ``[W, n_up/R]`` of the
    zero-padded stack, bit for bit ``shard_cols`` of the global stack,
    through one ``all_to_all``: column block d of this rank's rows goes to
    rank d. ``senders`` (all ranks by default), in rank order, hold the
    stack's rows ``i w .. (i+1) w - 1``, i their place in ``senders``;
    the other ranks' rows are not sent (the ranks of one worker's model
    group hold the same rows)."""
    R = n_devices(group)
    senders = list(range(R)) if senders is None else list(senders)
    rows, _ = _pad_cols(rows, group)
    w, n = rows.shape
    per = w * (n // R)  # the elements one sender sends each rank
    sends = dist.get_rank(group) in senders
    send = (rows.reshape(w, R, n // R).transpose(0, 1).reshape(-1) if sends  # [R, w, n/R]
            else rows[:0].reshape(-1))
    recv = exchange(send, [per if sends else 0] * R,
                    [per if r in senders else 0 for r in range(R)], group)
    return recv.reshape(len(senders) * w, n // R)


def unshard_cols(local: torch.Tensor, n: int, group) -> torch.Tensor:
    """The global ``[..., n]`` tensor, replicated on every rank, from each
    rank's column slice: one ``all_reduce``."""
    n_local = local.shape[-1]
    r = dist.get_rank(group)
    full = torch.zeros(local.shape[:-1] + (n_local * n_devices(group),),
                       dtype=local.dtype, device=local.device)
    full[..., r * n_local:(r + 1) * n_local] = local
    dist.all_reduce(full, group=group)
    return full[..., :n]


def all_reduced(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group, in place (every rank gets the sum)."""
    dist.all_reduce(t, group=group)
    return t


# ------------------------------------------------------------------ kernels
def gram(local: torch.Tensor, group) -> torch.Tensor:
    """Sharded stats phase: local ``[W, n/R]`` Gram + all-reduce -> ``[W, W]``."""
    return all_reduced(ops.gram(local), group)


def mix_apply(mix: torch.Tensor, local: torch.Tensor, group) -> torch.Tensor:
    """Sharded mixing/combine: the small ``[m, W]`` operator is the same on
    every rank and each rank mixes its own columns; no collective, the
    output stays column-sharded."""
    del group  # column-local
    return ops.mix_apply(mix, local)


def cm_aggregate(local: torch.Tensor, group) -> torch.Tensor:
    """Sharded coordinate-wise median: column-local selection network; the
    output is this rank's slice of the ``[n]`` aggregate."""
    del group  # column-local
    return ops.cm_aggregate(local)


def tm_aggregate(local: torch.Tensor, n_trim: int, group) -> torch.Tensor:
    """Sharded coordinate-wise trimmed mean: column-local selection network;
    the output is this rank's slice of the ``[n]`` aggregate."""
    del group  # column-local
    return ops.tm_aggregate(local, n_trim)


def coordinatewise_combine(local: torch.Tensor, group, combine_fn: Callable) -> torch.Tensor:
    """Any column-local ``[W, n] -> [n]`` reduction (an aggregator's
    ``combine_leaf``) run on this rank's columns."""
    del group  # column-local
    return combine_fn(local)


def residual_norms(local: torch.Tensor, coeffs: Optional[torch.Tensor] = None, *,
                   center: Optional[torch.Tensor] = None, group) -> torch.Tensor:
    """Sharded Weiszfeld/CCLIP norms phase: local pass + all-reduce ->
    ``[W]``. The centre is given as ``coeffs`` ``[W]`` (the same on every
    rank) or as this rank's slice of an explicit ``center`` row."""
    if (coeffs is None) == (center is None):
        raise ValueError("provide exactly one of coeffs / center")
    return all_reduced(ops.norms(local, coeffs, center=center), group)


def cclip_fused_iter(local: torch.Tensor, v: torch.Tensor, lam: torch.Tensor,
                     group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded fused CCLIP iteration: the centre update is column-local (the
    new centre stays column-sharded; one pass over the local slice); the
    next iteration's residuals finish with an all-reduce."""
    v_new, r2 = ops.cclip_iter(local, v, lam)
    return v_new, all_reduced(r2, group)


# ------------------------------------------------------------- compositions
def rfa_aggregate(local: torch.Tensor, group, *, n_iters: int = 8,
                  eps: float = 1e-6, with_stats: bool = False):
    """Counterpart of ``ops.rfa_aggregate`` over the group: smoothed
    Weiszfeld with one sharded norms pass (+ all-reduce of ``[W]``) per
    iteration. Returns this rank's slice of the aggregate.

    ``with_stats=True`` also returns the telemetry stats dict: each
    iteration's smoothed residual norms, ``sqrt(r2 + eps^2)`` of the
    ``residual_norms`` output the iteration uses (no pass of its own)."""
    W = local.shape[0]
    c = torch.full((W,), 1.0 / W, dtype=torch.float32, device=local.device)
    rs = []
    for _ in range(n_iters):
        r = torch.sqrt(residual_norms(local, c, group=group) + eps**2)
        rs.append(r)
        w = 1.0 / r
        c = w / torch.sum(w)
    out = mix_apply(c[None, :], local, group)[0]
    if not with_stats:
        return out
    r_seq = torch.stack(rs)
    stats = {
        "rfa_resid_norms": r_seq,                  # [T, W]
        "rfa_residual": torch.sum(r_seq, dim=1),   # [T]
        "rfa_iters": n_iters,
    }
    return out, stats


def cclip_aggregate(local: torch.Tensor, tau: float, group, *, n_iters: int = 3,
                    eps: float = 1e-12, with_stats: bool = False):
    """Counterpart of ``ops.cclip_aggregate`` over the group: one fused
    sharded pass per iteration (combine column-local, norms all-reduced).
    Returns this rank's slice of the aggregate.

    ``with_stats=True`` also returns the telemetry stats dict: the clip
    weights ``lam`` each iteration feeds ``cclip_fused_iter``."""
    W = local.shape[0]
    uniform = torch.full((1, W), 1.0 / W, dtype=torch.float32, device=local.device)
    v = mix_apply(uniform, local, group)[0]
    r2 = residual_norms(local, center=v, group=group)
    lams = []
    for _ in range(n_iters):
        lam = torch.clamp(tau / torch.sqrt(r2 + eps), max=1.0)
        lams.append(lam)
        v, r2 = cclip_fused_iter(local, v, lam, group)
    if not with_stats:
        return v
    lam32 = torch.stack(lams)
    stats = {
        "cclip_lam": lam32,                        # [T, W]
        "cclip_clip_frac": torch.mean((lam32 < 1.0).float(), dim=1),
        "cclip_tau": torch.full((n_iters,), tau, dtype=torch.float32, device=local.device),
    }
    return v, stats
