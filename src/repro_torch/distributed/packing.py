"""Packed flat-buffer robust-aggregation engine, on one device or over a
group of ranks.

Port of ``repro/distributed/packing.py``. Mixing, the Gram stats phase
and the combine are linear, so the whole stats -> coeff -> combine
pipeline runs on one packed ``[W, n_pad]`` fp32 buffer.

``GradPacker`` owns the layout: leaves in the reference's order (dict keys
sorted), each leaf's segment padded up to a multiple of the Gram kernel's
fixed tile, ``TILE_D`` = 2048 columns (the reference's default
``block_d``). The kernel sums its tiles in column order
(``kernels/pairwise_gram.py``), so a tile never straddles two leaves, and a
chain of per-leaf Gram calls seeded through ``acc`` equals one call on the
packed buffer bit for bit.

On one device the engine launches four kernels: ``bucket_mix`` (mix and
final combine), ``cwise_median`` (CM), ``cwise_trimmed_mean`` (TM) and
``pairwise_gram`` (every other rule). ``use_kernels=False`` runs the plain
PyTorch contractions instead. The phases are marked with
``telemetry.phase`` under the reference's names (``telemetry/pack``,
``mix``, ``kernel``, ``gram``, ``coeff``, ``combine``, ``unpack``).

``telemetry=True`` adds ``info["telemetry"]``: the layout counters and the
rule's statistics, read from what the route already holds (the kernels'
outputs, ``mixed``, the Gram matrix) with plain PyTorch. It launches no
kernel more and leaves the result's bits as they are; with the default
False the engine does no tensor work for telemetry.

Over a group of ranks (``mesh``: a ``torch.distributed`` process group of
more than one rank; ``launch/mesh.py``) the engine follows the reference's
multi-device route. ``reshard_in`` keeps this rank's column slice of the
packed buffer, the phases run the sharded kernels of ``shard_kernels.py``
on it, and ``reshard_out`` replicates the combined row (one all-reduce).
With ``worker_sharded=True`` each rank holds only its own workers' rows
(the train step over a group: rank r runs workers ``r W/R .. (r+1) W/R -
1``), and ``reshard_in`` turns them into the column slice with one
``all_to_all`` (``shard_kernels.rows_to_cols``; on a mesh with a
``model`` axis the rows come from the ranks at model coordinate 0). With
``in_shardings`` too (the train step computing along a model axis) each
rank holds its blocks of its workers' rows, and the ingress is
``pack_from_shardings``, the mirror of the param-sharded egress: one
``all_to_all`` in which each rank sends each column owner exactly the
elements of its blocks, the layout the whole leaves'; the column slice
is ``rows_to_cols``'s bit for bit, so the kernels see what they saw. With
``out_shardings`` (a ``sharding.Placement`` tree) the egress is the
param-sharded one, ``unpack_to_shardings``: one more ``all_to_all`` in
which each rank receives, from the column slices, exactly the elements of
its own blocks of each leaf; no rank holds the replicated ``[n_pad]`` row.
CM/TM mix and select column-locally; RFA and CCLIP skip the ``[W, W]``
Gram and run the fused compositions (one ``residual_norms`` or
``cclip_fused_iter`` pass plus an all-reduce of ``[W]`` per iteration);
Krum, ACClip and the mean take the sharded Gram (an all-reduce of
``[W, W]``) and the sharded combine. ``use_kernels=False`` on a group runs
the one-device plain route on every rank, the numerics reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.aragg import RobustAggregator
from repro_torch.distributed import shard_kernels
from repro_torch.kernels import ops
from repro_torch.kernels.pairwise_gram import TILE_D
from repro_torch.launch.mesh import as_mesh, n_devices, n_workers, worker_axes
from repro_torch.telemetry import InflightMetrics, phase
from repro_torch.telemetry import probes as _probes
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class GradPacker:
    """Flattens a per-worker gradient tree (leaves ``[W, ...]``) into one
    padded ``[W, n_pad]`` fp32 buffer and back. Layout is static per tree
    structure; build instances via ``packer_for`` to get caching."""

    def __init__(self, treedef, leaf_shapes: Tuple[tuple, ...], leaf_dtypes: tuple):
        self.treedef = treedef
        self.leaf_shapes = tuple(tuple(s) for s in leaf_shapes)  # sans worker axis
        self.leaf_dtypes = tuple(leaf_dtypes)
        self.sizes = tuple(math.prod(s) for s in self.leaf_shapes)
        self.padded = tuple(_round_up(z, TILE_D) if z else 0 for z in self.sizes)
        self.offsets = tuple(sum(self.padded[:i]) for i in range(len(self.padded)))
        self.n_params = sum(self.sizes)
        self.n_pad = sum(self.padded)

    def pack(self, grads_w: Any) -> torch.Tensor:
        """Stacked tree (leaves ``[W, ...]``) -> packed ``[W, n_pad]`` fp32."""
        leaves, _ = tree_flatten(grads_w)
        W = leaves[0].shape[0]
        buf = torch.zeros((W, self.n_pad), dtype=torch.float32, device=leaves[0].device)
        for leaf, size, off in zip(leaves, self.sizes, self.offsets):
            if size:
                buf[:, off:off + size] = leaf.reshape(W, size)
        return buf

    def unpack(self, vec: torch.Tensor) -> Any:
        """Packed row ``[n_pad]`` -> gradient tree (original shapes/dtypes)."""
        leaves = [
            vec[off:off + size].reshape(shape).to(dtype)
            for off, size, shape, dtype in zip(
                self.offsets, self.sizes, self.leaf_shapes, self.leaf_dtypes)
        ]
        return tree_unflatten(self.treedef, leaves)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"GradPacker(n_leaves={len(self.sizes)}, n_params={self.n_params}, "
                f"n_pad={self.n_pad})")


_PACKER_CACHE: Dict[tuple, GradPacker] = {}


def packer_for(grads_w: Any, in_shardings: Any = None) -> GradPacker:
    """Layout-cached ``GradPacker`` for this tree structure (leaves carry a
    leading worker axis that is NOT part of the layout). With
    ``in_shardings`` (a ``sharding.Placement`` tree) the leaves are this
    rank's blocks and the layout is that of the whole leaves."""
    leaves, treedef = tree_flatten(grads_w)
    shapes = tuple(tuple(l.shape[1:]) for l in leaves)
    if in_shardings is not None:
        shapes = tuple(pl.whole_shape(shape)
                       for shape, pl in zip(shapes, tree_flatten(in_shardings)[0]))
    key = (treedef, shapes, tuple(l.dtype for l in leaves))
    packer = _PACKER_CACHE.get(key)
    if packer is None:
        packer = GradPacker(treedef, key[1], key[2])
        _PACKER_CACHE[key] = packer
    return packer


# -------------------------------------------------------------- collectives
def reshard_in(buf: torch.Tensor, mesh, worker_sharded: bool = False,
               senders=None) -> torch.Tensor:
    """The ingress: this rank's column slice of the packed ``[W, n_pad]``
    buffer (zero-padded to a multiple of the group's size). Where every rank
    holds the whole global stack no collective is needed; with
    ``worker_sharded`` ``buf`` is this rank's worker rows and one
    ``all_to_all`` from the ``senders`` gathers the slice
    (``shard_kernels.rows_to_cols``). No-op without a group."""
    if mesh is None:
        return buf
    if worker_sharded:
        return shard_kernels.rows_to_cols(buf, mesh, senders)
    return shard_kernels.shard_cols(buf, mesh)


def reshard_out(vec: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The replicated egress: the combined ``[n]`` row on every rank, from
    each rank's column slice (one all-reduce). No-op without a group."""
    return vec if mesh is None else shard_kernels.unshard_cols(vec, n, mesh)


def _ravel(index: Tuple[int, ...], shape: Tuple[int, ...]) -> int:
    flat = 0
    for i, n in zip(index, shape):
        flat = flat * n + i
    return flat


def _flat_boxes(a: int, b: int, shape: Tuple[int, ...]):
    """The flat range ``[a, b)`` of a row-major array of ``shape`` as boxes
    ``(start, stop)``, in flat order; each box (leading indices fixed, one
    dim ranged, the trailing dims whole) is contiguous in flat order."""
    if a >= b:
        return []
    if not shape:
        return [((), ())]
    inner = math.prod(shape[1:])
    i0, r0 = divmod(a, inner)
    i1, r1 = divmod(b, inner)

    def row(i, lo, hi):
        return [((i,) + s, (i + 1,) + e) for s, e in _flat_boxes(lo, hi, shape[1:])]

    if i0 == i1:
        return row(i0, r0, r1)
    out = []
    if r0:
        out += row(i0, r0, inner)
        i0 += 1
    if i1 > i0:
        out.append(((i0,) + (0,) * (len(shape) - 1), (i1,) + tuple(shape[1:])))
    if r1:
        out += row(i1, 0, r1)
    return out


def _box(packer: GradPacker, i: int, start, stop, col0: int):
    """``(first, shape)``: where the box ``[start, stop)`` of leaf ``i``
    begins in a column slice that starts at packed column ``col0``, and
    its shape (a box is contiguous in the packed row)."""
    shape = tuple(e - s for s, e in zip(start, stop))
    return packer.offsets[i] + _ravel(start, packer.leaf_shapes[i]) - col0, shape


def _within(lo, hi, origin) -> tuple:
    """The index of the part ``[lo, hi)`` in a block that starts at ``origin``."""
    return tuple(slice(x - o, y - o) for x, y, o in zip(lo, hi, origin))


def _egress_pieces(packer: GradPacker, placements, n_local: int, src: int, dst: int):
    """What rank ``src``'s column slice sends rank ``dst``: for each leaf and
    each box of the slice within it, the part inside each box of ``dst``'s
    block (``Placement.boxes``: one, or one a segment of a segmented dim),
    as ``(leaf, box start, box stop, part start, part stop, block box)`` in
    leaf coordinates, in the order both ranks walk."""
    for i, (off, size, shape, pl) in enumerate(zip(packer.offsets, packer.sizes,
                                                   packer.leaf_shapes, placements)):
        a, b = max(src * n_local - off, 0), min((src + 1) * n_local - off, size)
        if a >= b:
            continue
        block = pl.boxes(shape, dst)
        for start, stop in _flat_boxes(a, b, shape):
            for box in block:
                lo = tuple(max(s, r) for s, r in zip(start, box.lo))
                hi = tuple(min(e, r) for e, r in zip(stop, box.hi))
                if all(x < y for x, y in zip(lo, hi)):
                    yield i, start, stop, lo, hi, box


def _origin(box) -> tuple:
    """Where the whole tensor's index 0 falls in the block that holds
    ``box``: a part ``[lo, hi)`` of the box lies at ``_within(lo, hi,
    _origin(box))`` in the block."""
    return tuple(lo - at for lo, at in zip(box.lo, box.at))


def _sends(mesh, rank: int, box) -> bool:
    """Whether ``rank``'s ``box`` of a leaf's block goes into the ingress:
    a box that ranks differing only off the worker axes and off the axes
    that pick it all hold (a leaf, or a segment of one, whole on every
    model rank) is sent by the one at coordinate 0 there, and a replicated
    block's box (``box.held``: r consecutive ranks along an axis hold it)
    by its replica 0."""
    coords = mesh.coords_of(rank)
    own = set(worker_axes(mesh)).union(box.axes)
    return (all(coords[a] == 0 for a in mesh.axis_names if a not in own)
            and all(coords[a] % r == 0 for a, r in box.held))


def pack_from_shardings(packer: GradPacker, grads_w: Any, in_shardings: Any, mesh
                        ) -> torch.Tensor:
    """The block ingress, the mirror of ``unpack_to_shardings``: from this
    rank's workers' blocks of every leaf (``grads_w``, leaves ``[w, ...]``
    placed sans worker axis by ``in_shardings``, the train step's compute
    blocks) to its column slice ``[W, n_up/R]`` of the packed stack of all
    W workers, through one ``all_to_all`` (``shard_kernels.exchange``) in
    which each rank sends each column owner exactly the fp32 elements of
    its blocks that fall in the owner's columns. A block, or a segment of
    one, held alike by several model ranks is sent once (``_sends``; an
    SSM layer's whole B / C columns by model coordinate 0, its heads'
    columns by every rank; an attention head block held by r replicas by
    replica 0). Pure data movement: the
    slice is ``shard_kernels.rows_to_cols``'s of the same global stack,
    bit for bit, padding zeros included."""
    placements, _ = tree_flatten(in_shardings)
    leaves, _ = tree_flatten(grads_w)
    R, me, w = mesh.size, mesh.rank, leaves[0].shape[0]
    n_local = -(-packer.n_pad // R)

    def elems(plan):
        return w * sum(math.prod(y - x for x, y in zip(lo, hi)) for *_, lo, hi, _ in plan)

    send_plan = [[piece for piece in _egress_pieces(packer, placements, n_local, q, me)
                  if _sends(mesh, me, piece[-1])] for q in range(R)]
    recv_plan = [[piece for piece in _egress_pieces(packer, placements, n_local, me, r)
                  if _sends(mesh, r, piece[-1])] for r in range(R)]
    device = leaves[0].device
    # each part converted to fp32 as it is copied in: one fp32 copy of the blocks
    send = torch.empty(sum(elems(plan) for plan in send_plan), dtype=torch.float32,
                       device=device)
    pos = 0
    for plan in send_plan:
        for i, _, _, lo, hi, box in plan:
            part = leaves[i][(slice(None),) + _within(lo, hi, _origin(box))]
            send[pos:pos + part.numel()].view(part.shape).copy_(part)
            pos += part.numel()
    recv = shard_kernels.exchange(send, [elems(plan) for plan in send_plan],
                                  [elems(plan) for plan in recv_plan], mesh.group)
    del send
    buf = torch.zeros((w * n_workers(mesh), n_local), dtype=torch.float32, device=device)
    pos = 0
    for r, plan in enumerate(recv_plan):
        g = 0  # rank r's worker group: its worker-axis coordinates, row-major
        for a in worker_axes(mesh):
            g = g * mesh.shape[a] + mesh.coords_of(r)[a]
        for i, start, stop, lo, hi, _ in plan:
            first, box_shape = _box(packer, i, start, stop, me * n_local)
            part_shape = tuple(y - x for x, y in zip(lo, hi))
            n = w * math.prod(part_shape)
            box = buf[g * w:(g + 1) * w, first:first + math.prod(box_shape)].view(
                (w,) + box_shape)
            box[(slice(None),) + _within(lo, hi, start)] = recv[pos:pos + n].view(
                (w,) + part_shape)
            pos += n
    return buf


def unpack_to_shardings(packer: GradPacker, local: torch.Tensor, out_shardings: Any) -> Any:
    """Param-sharded egress: from this rank's column slice ``local`` of the
    combined row to its block of every leaf, placed by ``out_shardings``
    (a ``sharding.Placement`` tree matching the gradients sans worker
    axis). One ``all_to_all`` (``shard_kernels.exchange``) in which each
    rank receives exactly the fp32 elements of its own blocks; the
    replicated ``[n_pad]`` row never exists. The blocks are the replicated
    egress's leaves, cut, bit for bit; each replica of a replicated block
    receives the same block."""
    placements, _ = tree_flatten(out_shardings)
    if len(placements) != len(packer.sizes):
        raise ValueError(f"out_shardings has {len(placements)} leaves for a "
                         f"{len(packer.sizes)}-leaf layout")
    mesh = placements[0].mesh
    R, me, n_local = mesh.size, mesh.rank, local.shape[-1]
    chunks, send_sizes = [], []
    for q in range(R):
        n = 0
        for i, start, stop, lo, hi, _ in _egress_pieces(packer, placements, n_local, me, q):
            first, box_shape = _box(packer, i, start, stop, me * n_local)
            box = local[first:first + math.prod(box_shape)].view(box_shape)
            part = box[_within(lo, hi, start)]
            chunks.append(part.reshape(-1))
            n += part.numel()
        send_sizes.append(n)
    recv_plan = [list(_egress_pieces(packer, placements, n_local, r, me)) for r in range(R)]
    recv_sizes = [sum(math.prod(y - x for x, y in zip(lo, hi)) for *_, lo, hi, _ in plan)
                  for plan in recv_plan]
    send = torch.cat(chunks) if chunks else local[:0]
    recv = shard_kernels.exchange(send, send_sizes, recv_sizes, mesh.group)
    del send, chunks
    blocks = [torch.empty(pl.local_shape(shape), dtype=torch.float32, device=local.device)
              for shape, pl in zip(packer.leaf_shapes, placements)]
    pos = 0
    for plan in recv_plan:
        for i, _, _, lo, hi, box in plan:
            part_shape = tuple(y - x for x, y in zip(lo, hi))
            n = math.prod(part_shape)
            blocks[i][_within(lo, hi, _origin(box))] = recv[pos:pos + n].view(part_shape)
            pos += n
    del recv
    leaves = [blk.to(dtype) for blk, dtype in zip(blocks, packer.leaf_dtypes)]
    return tree_unflatten(packer.treedef, leaves)


def _mesh_is_trivial(mesh) -> bool:
    return mesh is None or n_devices(mesh) == 1


# ------------------------------------------------------------------- engine
def packed_robust_sync(
    grads_w: Any,
    aggregator: RobustAggregator,
    mix: Optional[torch.Tensor] = None,
    mesh=None,
    use_kernels: bool = True,
    out_shardings: Any = None,
    telemetry: bool = False,
    worker_sharded: bool = False,
    in_shardings: Any = None,
) -> Tuple[Any, dict]:
    """Aggregate per-worker gradient trees (leaves ``[W, ...]``) into one
    gradient tree on a single packed buffer. Returns ``(grads, info)``.

    ``mix`` is the round's ``[m, W]`` mixing matrix
    (``aggregator.mixing_matrix``); without it the identity permutation's
    (the reference's ``key=None``). The tensors' device decides where it
    runs: CUDA tensors go through the kernels (``use_kernels=True``), CPU
    tensors through the plain versions.

    ``mesh`` is ``None`` (one device), a process group or a
    ``launch.mesh.Mesh``. Over more than one rank every rank passes the
    same global stack and the same ``mix`` (keeping ``mix`` the same is the
    caller's duty, as the replicated ``key`` is in the reference), the
    kernel route runs sharded (module docstring), and every rank gets the
    whole result, or with ``out_shardings`` (a ``sharding.Placement``
    tree matching the result) its own blocks of it.
    ``worker_sharded=True`` (over a group, kernel route only) means each
    rank passes only its own workers' rows, ``[W/G, ...]`` leaves for G
    worker groups (``mesh.n_workers``), the ranks of worker group g holding
    workers ``g W/G .. (g+1) W/G - 1``; ``mix`` stays ``[m, W]``. With
    ``in_shardings`` too (a ``sharding.Placement`` tree, the train step's
    compute plan over a model axis) each leaf is this rank's block of its
    workers' rows, and the ingress is ``pack_from_shardings``.
    On the Gram route ``info`` holds ``agg_weights`` and
    ``gram_diag_mean``; with ``telemetry=True`` ``info["telemetry"]``
    holds the metrics (module docstring), the same on every rank of a
    group."""
    m = None if mesh is None else as_mesh(mesh)
    sharded = not _mesh_is_trivial(m) and use_kernels
    group = m.group if sharded else None
    worker_sharded = worker_sharded and not _mesh_is_trivial(m)
    if worker_sharded and not use_kernels:
        raise NotImplementedError("worker-sharded rows go through the kernel route only")
    blocks = worker_sharded and in_shardings is not None
    packer = packer_for(grads_w, in_shardings if blocks else None)
    leaves, _ = tree_flatten(grads_w)
    W, device = leaves[0].shape[0], leaves[0].device
    senders = None
    if worker_sharded:  # one row group a worker group: model coordinate 0
        senders = [r for r in range(m.size) if not m.coords_of(r).get("model", 0)]
        W *= len(senders)
    if packer.n_params == 0:  # degenerate all-empty tree
        return packer.unpack(torch.zeros((packer.n_pad,), device=device)), {}
    if mix is None:
        mix = aggregator.mixer.matrix(W, device=device)
    mix = mix.to(device=device, dtype=torch.float32).contiguous()
    info: dict = {}
    tm = InflightMetrics(telemetry)
    if tm:
        tm.put("sync_n_workers", W)
        tm.put("sync_n_params", packer.n_params)
        tm.put("sync_n_pad", packer.n_pad)
        tm.put("sync_ingress_bytes", W * packer.n_pad * 4)
        tm.put("sync_egress_bytes", packer.n_params * 4
               if (out_shardings is not None and mesh is not None) else packer.n_pad * 4)

    def col_sum(t: torch.Tensor) -> torch.Tensor:
        """A probe's sum over this rank's columns -> over all columns."""
        return t if group is None else shard_kernels.all_reduced(t, group)

    with phase("pack"):  # [W, n_pad/R]
        buf = (pack_from_shardings(packer, grads_w, in_shardings, m) if blocks
               else reshard_in(packer.pack(grads_w), group, worker_sharded, senders))

    def finish(out):
        if tm:
            info["telemetry"] = tm.tree()
        with phase("unpack"):
            if out_shardings is not None and group is not None:
                return unpack_to_shardings(packer, out, out_shardings), info
            grads = packer.unpack(reshard_out(out, packer.n_pad, group))
            if out_shardings is not None and m is not None:  # ignored without a mesh
                grads = tree_map(lambda g, pl: pl.local(g), grads, out_shardings)
            return grads, info

    base = aggregator.base
    if base.coordinatewise:
        with phase("mix"):
            if not use_kernels:
                mixed = mix @ buf
            else:
                mixed = (shard_kernels.mix_apply(mix, buf, group) if sharded
                         else ops.mix_apply(mix, buf))
        with phase("kernel"):
            if not use_kernels:
                out = base.combine_leaf(mixed)
            elif base.name == "cm":
                out = (shard_kernels.cm_aggregate(mixed, group) if sharded
                       else ops.cm_aggregate(mixed))
            elif base.name == "tm":
                b = min(base.n_trim, (mixed.shape[0] - 1) // 2)
                out = (shard_kernels.tm_aggregate(mixed, b, group) if sharded
                       else ops.tm_aggregate(mixed, b))
            elif sharded:  # any other combine_leaf is column-local too
                out = shard_kernels.coordinatewise_combine(mixed, group, base.combine_leaf)
            else:
                out = base.combine_leaf(mixed)
        if tm:
            # the probes read the mixed rows and the kernel's output
            tm.put("bucket_dispersion", lambda: col_sum(_probes.bucket_dispersion(mixed)))
            if base.name == "cm":
                tm.put("cm_worker_dev", lambda: col_sum(_probes.cm_worker_dev(
                    mixed, out, packer.n_params)))
            elif base.name == "tm":
                tm.put("tm_trim_frac", lambda: col_sum(_probes.tm_trim_frac(
                    mixed, base.n_trim, packer.n_params)))
        return finish(out)

    if sharded and base.name in ("rfa", "cclip"):
        # fused multi-rank route: mix in vector space, then the sharded
        # Weiszfeld / fused-CCLIP composition, one local kernel pass plus
        # one [W]-sized all-reduce per iteration instead of the [W, W] Gram
        # detour. ACClip stays on the Gram route (its adaptive tau needs the
        # whole norm vector).
        with phase("mix"):
            mixed = shard_kernels.mix_apply(mix, buf, group)
        with phase("kernel"):
            if base.name == "cclip":
                out = shard_kernels.cclip_aggregate(mixed, base.tau, group,
                                                    n_iters=base.n_iters, eps=base.eps,
                                                    with_stats=telemetry)
            else:
                out = shard_kernels.rfa_aggregate(mixed, group, n_iters=base.n_iters,
                                                  eps=base.eps, with_stats=telemetry)
        if tm:
            out, stats = out
            tm.update(stats)
            tm.put("bucket_dispersion", lambda: col_sum(_probes.bucket_dispersion(mixed)))
        return finish(out)

    with phase("gram"):
        if not use_kernels:
            gram = buf @ buf.T
        elif sharded:
            gram = shard_kernels.gram(buf, group)
        else:
            gram = ops.gram(buf)
    with phase("coeff"):
        if tm:
            weights, stats = aggregator.worker_weights_and_stats_from_gram(gram, mix=mix)
            tm.update(stats)
        else:
            weights = aggregator.worker_weights_from_gram(gram, mix=mix)
    info["agg_weights"] = weights
    info["gram_diag_mean"] = torch.mean(torch.diagonal(gram))
    with phase("combine"):
        if not use_kernels:
            out = weights @ buf
        elif sharded:
            out = shard_kernels.mix_apply(weights[None, :].contiguous(), buf, group)[0]
        else:
            out = ops.mix_apply(weights[None, :].contiguous(), buf)[0]
    return finish(out)


def packed_aggregate(
    xs: torch.Tensor,
    aggregator: RobustAggregator,
    mix: Optional[torch.Tensor] = None,
    use_kernels: bool = True,
    telemetry: bool = False,
    with_info: bool = False,
):
    """Packed engine on an already-stacked ``[W, d]`` matrix -> ``[d]``; the
    counterpart of ``RobustAggregator.__call__`` for callers that hold a
    flat stack (the cross-device server). ``with_info=True`` returns
    ``(out, info)``; with ``telemetry=True`` the info carries the metrics."""
    out_tree, info = packed_robust_sync(
        [xs], aggregator, mix=mix, use_kernels=use_kernels, telemetry=telemetry)
    if with_info:
        return out_tree[0], info
    return out_tree[0]
