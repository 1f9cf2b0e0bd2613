"""Sharding rules and placements over a mesh of ranks (port of
``repro/distributed/sharding.py``).

The rules are the reference's, entry for entry:

- tensor ("model") axis: the largest dim divisible by the model-axis size
  (prefers the last dims, the d_ff / head / expert-shaped ones);
- optional FSDP: among the remaining dims, the largest one divisible by
  the combined (pod, data) size, or else by data alone, is sharded over
  those axes (params, grads and optimizer state all follow one spec);
- leaves under "blocks" carry a leading period axis, never sharded;
- decode caches: batch over the workers; for batch-1 long contexts the
  cache length shards over the data axis (sequence parallelism for the KV
  cache) and the heads over the model axis where they divide.

These rules place storage: parameters, optimizer moments and the sync's
egress. Compute has a plan of its own, ``compute_shardings``: the block
of each parameter a rank runs the training forward and backward on,
Megatron's column / row split of attention and the MLP, the vocab split,
a MoE layer's experts and an SSM layer's heads over the model axis where
its size divides them, attention over the largest divisor of it that fits
the heads (replicated blocks), the leaf whole elsewhere
(``models/parallel.py``).
The storage rule picks the largest dim, the first on a tie, so it often
splits a weight on its input dim where the column split needs the output
dim; the train step gathers each leaf from its storage blocks and keeps
its compute block.

Per-arch overrides replace the inferred spec: ``overrides={path_regex:
spec}``, matched with ``re.search`` against the leaf's path string
(``utils.tree.tree_flatten_with_path``).

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names (the major axis first), the counterpart of JAX's
``PartitionSpec``; or, in the compute plan, a *replicated-block* entry
``(axis, n)``, n dividing the axis's size, which cuts the dim into n
blocks, each held by the size / n consecutive ranks along the axis (its
replicas: rank c holds block c // (size / n); an attention layer whose
heads the model axis's size does not divide); or a tuple of *segments*
``((size, entry), ...)`` that cut the dim into consecutive ranges, each
split by its entry's axes or whole (an SSM layer's ``in_proj`` columns
z | x | B | C | dt: z, x and dt by heads, B and C whole). A rank's block
of a segmented dim is its part of each segment, in segment order; every
split segment of a dim names the same axes. A ``Placement(mesh, spec)``
takes the place of a ``NamedSharding``: ``local(full)`` cuts this rank's
block out of a whole tensor, ``gather(block)`` rebuilds the whole tensor
on every rank (one copy of each replicated block), ``local_shape(shape)``
is the block's shape and ``boxes(shape)`` the ranges of the whole that
make up the block. The
rules only put a dim on axes whose sizes divide it, so every block is
even; a placement that would be uneven raises. Rule functions read only
``mesh.axis_names`` and ``mesh.shape``; ``local`` and ``gather`` need a
``launch.mesh.Mesh``.

The collectives copy bytes and add nothing, so a gathered tensor is the
whole tensor bit for bit. gloo's ``all_gather`` takes CPU tensors only, so
under gloo a CUDA block is staged through host memory, as
``shard_kernels.rows_to_cols`` stages the ingress. ``gather_many`` gathers
several tensors placed along one axis with one ``all_gather`` of their
bytes side by side.
"""

from __future__ import annotations

import itertools
import math
import re
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import worker_axes
from repro_torch.utils.tree import tree_map, tree_map_with_path

Spec = Tuple[Any, ...]


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(a for a in entry if isinstance(a, str))
    return (entry,)


def _entry_blocks(entry) -> Optional[int]:
    """n of a replicated-block entry ``(axis, n)``, or ``None``."""
    if isinstance(entry, tuple) and len(entry) == 2 and isinstance(entry[1], int):
        return entry[1]
    return None


def _segments(entry):
    """The segments ``((size, entry), ...)`` of a segmented spec entry, or
    ``None`` for a plain one."""
    if isinstance(entry, tuple) and entry and isinstance(entry[0], tuple):
        return entry
    return None


def _all_gather_parts(ts: Sequence[torch.Tensor], group) -> List[List[torch.Tensor]]:
    """Every rank's ``ts`` (the same shapes and dtypes on every rank of
    ``group``), in the group's rank order, ``[rank][i]``: one byte-exact
    ``all_gather`` of their bytes side by side."""
    n = dist.get_world_size(group)
    stage = dist.get_backend(group) == "gloo" and ts[0].device.type != "cpu"
    flats = [(t.contiguous().cpu() if stage else t.contiguous()).reshape(-1).view(torch.uint8)
             for t in ts]
    sizes = [f.numel() for f in flats]
    flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    out = []
    for part in parts:
        got = []
        for seg, t in zip(part.split(sizes), ts):
            if seg.storage_offset() % t.element_size():
                seg = seg.clone()  # a view as t's dtype needs its alignment
            got.append(seg.view(t.dtype).reshape(t.shape).to(t.device))
        out.append(got)
    return out


def _gather_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate along ``dim`` the equal blocks ``t`` of every rank of
    ``group``, in the group's rank order (a byte-exact ``all_gather``)."""
    return torch.cat([got[0] for got in _all_gather_parts([t], group)], dim=dim)


class Box(NamedTuple):
    """A range of a whole tensor inside one rank's block: ``lo`` / ``hi``
    per dim in the whole, ``at`` per dim where it starts in the block,
    ``axes`` the mesh axes whose coordinates pick it (a segment held whole
    by a model group names no model axis), and ``held`` the ``(axis, r)``
    of a replicated block: r consecutive ranks along the axis hold it."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    at: Tuple[int, ...]
    axes: Tuple[str, ...]
    held: Tuple[Tuple[str, int], ...] = ()


class Placement:
    """Where each block of a tensor lives on ``mesh`` (module docstring)."""

    def __init__(self, mesh, spec: Sequence[Any]):
        self.mesh = mesh
        self.spec: Spec = tuple(spec)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Placement{self.spec}"

    def _segs(self, dim: int):
        """The segments of ``dim``'s entry, or ``None`` for a plain one."""
        return _segments(self.spec[dim]) if dim < len(self.spec) else None

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The axes that cut ``dim`` (those of its split segments)."""
        segs = self._segs(dim)
        if segs is None:
            return _entry_axes(self.spec[dim]) if dim < len(self.spec) else ()
        named = {_entry_axes(e) for _, e in segs} - {()}
        if len(named) > 1:
            raise ValueError(f"placement {self.spec}: dim {dim}'s segments split over "
                             f"different axes {sorted(named)}")
        return next(iter(named), ())

    def parts(self, dim: int) -> int:
        """How many blocks ``dim`` (each split segment of it) is cut into."""
        size = math.prod(self.mesh.shape[a] for a in self.axes(dim))
        n = _entry_blocks(self.spec[dim]) if dim < len(self.spec) else None
        if n is not None and size % n:
            raise ValueError(f"placement {self.spec}: dim {dim} cut into {n} blocks over "
                             f"{size} ranks")
        return size if n is None else n

    def replicas(self, dim: int) -> int:
        """How many consecutive ranks along ``dim``'s axes hold each of its
        blocks: 1 but for a replicated-block entry ``(axis, n)``."""
        return math.prod(self.mesh.shape[a] for a in self.axes(dim)) // self.parts(dim)

    def _pieces(self, shape: Sequence[int], coords, dims=None):
        """Per dim the ``(lo, hi, at, axes, held)`` of each of its pieces
        in this block (one for a plain dim, one a segment for a
        segmented)."""
        out = []
        for d, n in enumerate(shape):
            if dims is not None and d not in dims:
                out.append([(0, n, 0, (), ())])
                continue
            k, axes, r = self.parts(d), self.axes(d), self.replicas(d)
            idx = 0
            for a in axes:  # mixed radix, the first axis major
                idx = idx * self.mesh.shape[a] + coords[a]
            idx //= r  # a replicated block: r consecutive ranks hold it
            held = ((axes[0], r),) if r > 1 and k > 1 else ()
            segs = self._segs(d)
            if segs is None:
                if n % k:
                    raise ValueError(f"placement {self.spec}: dim {d} of {tuple(shape)} does "
                                     f"not split into {k} even blocks")
                b = n // k
                out.append([(idx * b, (idx + 1) * b, 0, axes if k > 1 else (), held)])
                continue
            if sum(size for size, _ in segs) != n:
                raise ValueError(f"placement {self.spec}: dim {d}'s segments do not add up "
                                 f"to {n}")
            pieces, g, at = [], 0, 0
            for size, e in segs:
                if _entry_axes(e):
                    if size % k:
                        raise ValueError(f"placement {self.spec}: a segment of {size} in "
                                         f"dim {d} does not split into {k} even blocks")
                    b = size // k
                    pieces.append((g + idx * b, g + (idx + 1) * b, at, axes, held))
                else:
                    b = size
                    pieces.append((g, g + size, at, (), ()))
                g, at = g + size, at + b
            out.append(pieces)
        return out

    def boxes(self, shape: Sequence[int], rank: Optional[int] = None,
              dims: Optional[Sequence[int]] = None) -> List[Box]:
        """The ranges of a tensor of ``shape`` that make up the block of
        ``rank`` (this rank by default), one ``Box`` for each combination
        of the dims' pieces, in row-major order; only ``dims`` are cut, if
        given."""
        coords = self.mesh.coords if rank is None else self.mesh.coords_of(rank)
        out = []
        for combo in itertools.product(*self._pieces(shape, coords, dims)):
            out.append(Box(tuple(p[0] for p in combo), tuple(p[1] for p in combo),
                           tuple(p[2] for p in combo),
                           tuple(dict.fromkeys(a for p in combo for a in p[3])),
                           tuple(dict.fromkeys(h for p in combo for h in p[4]))))
        return out

    def ranges(self, shape: Sequence[int], rank: Optional[int] = None,
               dims: Optional[Sequence[int]] = None):
        """``[(start, stop), ...]`` per dim: the block of ``rank`` (this
        rank by default) in a tensor of ``shape``; only ``dims`` are cut, if
        given (the others span the tensor, whatever their size). A block
        cut from a segmented dim is no one range: ``boxes`` gives it."""
        cut = range(len(shape)) if dims is None else dims
        if any(self._segs(d) and self.parts(d) > 1 for d in cut):
            raise ValueError(f"placement {self.spec}: a segmented block is no one range per "
                             "dim; use boxes()")
        (box,) = self.boxes(shape, rank, dims)
        return list(zip(box.lo, box.hi))

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        coords = {a: 0 for a in self.mesh.shape}
        return tuple(sum(p[1] - p[0] for p in pieces)
                     for pieces in self._pieces(shape, coords))

    def whole_shape(self, local: Sequence[int]) -> Tuple[int, ...]:
        """The shape of the whole tensor whose block has shape ``local``."""
        return tuple(n * self.parts(d) if self._segs(d) is None
                     else sum(size for size, _ in self._segs(d)) for d, n in enumerate(local))

    def sharded_dims(self, ndim: int) -> Tuple[int, ...]:
        return tuple(d for d in range(ndim) if self.parts(d) > 1)

    def local(self, full: torch.Tensor, dims: Optional[Sequence[int]] = None) -> torch.Tensor:
        """This rank's block of ``full`` (only ``dims`` cut, if given): a
        copy of its own, so that ``full`` can be freed, or ``full`` itself
        where nothing is cut. A segmented dim's pieces are joined in
        segment order."""
        cut = [d for d in self.sharded_dims(full.dim()) if dims is None or d in dims]
        if not cut:
            return full
        pieces = self._pieces(full.shape, self.mesh.coords, cut)
        index = tuple(slice(*pieces[d][0][:2]) if d in cut and len(pieces[d]) == 1
                      else slice(None) for d in range(full.dim()))
        out, copied = full[index], False
        for d in cut:
            if len(pieces[d]) > 1:
                out = torch.cat([out.narrow(d, lo, hi - lo) for lo, hi, *_ in pieces[d]], dim=d)
                copied = True
        return out if copied else out.clone()

    def _join(self, parts: Sequence[torch.Tensor], dim: int, left: int) -> torch.Tensor:
        """The blocks ``parts`` of the ranks along one axis of ``dim`` in
        rank order, joined: one of each replicated block's r consecutive
        copies kept, then concatenated for a plain dim; for a segmented
        one, each split segment's parts concatenated in segment order and
        a whole segment taken from the first. ``left`` is how many blocks
        each split segment was cut into before this axis was gathered."""
        parts = list(parts)[::self.replicas(dim)]
        segs = self._segs(dim)
        if segs is None:
            return torch.cat(list(parts), dim=dim)
        pieces, at = [], 0
        for size, e in segs:
            if _entry_axes(e):
                b = size // left
                pieces += [p.narrow(dim, at, b) for p in parts]
            else:
                b = size
                pieces.append(parts[0].narrow(dim, at, b))
            at += b
        return torch.cat(pieces, dim=dim)

    def _gather_dim(self, block: torch.Tensor, d: int) -> torch.Tensor:
        out, left = block, self.parts(d)
        for a in reversed(self.axes(d)):
            group = self.mesh.axis_group(a)
            if group is not None:
                out = self._join([got[0] for got in _all_gather_parts([out], group)], d, left)
            left //= self.mesh.shape[a]
        return out

    def gather(self, block: torch.Tensor, dims: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The whole tensor from every rank's block (only ``dims``
        gathered, if given), on every rank: one ``all_gather`` over each
        axis a dim names, the minor axis first."""
        out = block
        for d in self.sharded_dims(block.dim()):
            if dims is not None and d not in dims:
                continue
            out = self._gather_dim(out, d)
        return out


def gather_many(blocks: Sequence[torch.Tensor], placements: Sequence[Placement],
                dims: Sequence[Optional[Sequence[int]]]) -> List[torch.Tensor]:
    """Each of ``blocks`` gathered as ``placements[i].gather(blocks[i],
    dims[i])`` gathers it, by one ``all_gather`` for all of them: each
    gathers at most one dim, and every such dim is cut by one and the
    same single axis (a block with none is returned as it is)."""
    todo, axis = [], None
    for i, (t, pl, ds) in enumerate(zip(blocks, placements, dims)):
        cut = [d for d in pl.sharded_dims(t.dim()) if ds is None or d in ds]
        if len(cut) > 1 or (cut and len(pl.axes(cut[0])) != 1):
            raise ValueError(f"gather_many: {pl.spec} gathers more than one dim or axis")
        if cut:
            (a,) = pl.axes(cut[0])
            if axis not in (None, a):
                raise ValueError(f"gather_many: axes {axis} and {a}")
            axis = a
            todo.append((i, cut[0]))
    out = list(blocks)
    group = None if axis is None else placements[todo[0][0]].mesh.axis_group(axis)
    if group is None:
        return out
    got = _all_gather_parts([blocks[i] for i, _ in todo], group)
    for j, (i, d) in enumerate(todo):
        out[i] = placements[i]._join([g[j] for g in got], d, placements[i].parts(d))
    return out


# ------------------------------------------------------------------- rules
def _pick_dim(shape, size: int, taken: set, start: int = 0) -> Optional[int]:
    """Largest dim (index >= start, not taken) divisible by ``size``."""
    best, best_dim = -1, None
    for i in range(start, len(shape)):
        if i in taken:
            continue
        if shape[i] % size == 0 and shape[i] >= size and shape[i] > best:
            best, best_dim = shape[i], i
    return best_dim


def infer_param_spec(path_str: str, shape, mesh, fsdp: bool = False) -> Spec:
    axes = dict(mesh.shape)
    model_size = axes.get("model", 1)
    start = 1 if path_str.startswith("blocks") and len(shape) > 1 else 0
    spec = [None] * len(shape)
    taken: set = set()

    m_dim = _pick_dim(shape, model_size, taken, start)
    if m_dim is not None and model_size > 1:
        spec[m_dim] = "model"
        taken.add(m_dim)

    if fsdp:
        w_axes = tuple(a for a in ("pod", "data") if a in axes)
        combined = math.prod(axes[a] for a in w_axes)
        f_dim = _pick_dim(shape, combined, taken, start)
        if f_dim is not None and combined > 1:
            spec[f_dim] = w_axes if len(w_axes) > 1 else w_axes[0]
            taken.add(f_dim)
        elif "data" in axes:  # fall back to data-only FSDP
            f_dim = _pick_dim(shape, axes["data"], taken, start)
            if f_dim is not None and axes["data"] > 1:
                spec[f_dim] = "data"
    return tuple(spec)


def overrides_from_config(cfg) -> Dict[str, Spec]:
    """Decode ``ModelConfig.sharding_overrides``, nested tuples
    ``((path_regex, spec_entries), ...)``, into the ``{regex: spec}``
    mapping ``param_shardings`` takes. Each spec entry is an axis name, a
    tuple of axis names, or None."""
    return {
        pat: tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in entries)
        for pat, entries in getattr(cfg, "sharding_overrides", ()) or ()
    }


def param_shardings(params, mesh, fsdp: bool = False,
                    overrides: Optional[Dict[str, Spec]] = None):
    """A ``Placement`` tree matching ``params`` (tensors or anything with a
    ``.shape``, such as ``steps.TensorSpec``)."""
    overrides = overrides or {}

    def one(path, leaf):
        for pat, spec in overrides.items():
            if re.search(pat, path):
                return Placement(mesh, spec)
        return Placement(mesh, infer_param_spec(path, tuple(leaf.shape), mesh, fsdp))

    return tree_map_with_path(one, params)


def compute_shardings(cfg, params_shape, mesh):
    """The compute plan: a ``Placement`` tree over ``params_shape`` whose
    entries are only ``"model"``, ``("model", t)``, ``None`` or segments
    over ``"model"``, each leaf's block the one a rank computes on in the
    training forward and backward (``models/parallel.py``): Megatron's
    layout wherever the model axis's size T divides the part
    (``parallel.model_split``); an attention layer over its t head blocks
    (wq / bq, and wk / wv / bk / bv where t divides the kv heads, on their
    output dim, wo on its rows), ``"model"`` where t = T and the
    replicated-block entry ``("model", t)`` where t < T, each block then
    held by T / t consecutive model ranks; the experts of a MoE layer on
    their expert dim (a shared expert as the MLP, the router whole), an
    SSM layer's heads (``ssm_segments``: in ``in_proj`` and the conv the
    x, z and dt channels of the rank's heads, B and C whole; the per-head
    leaves, the gated norm's scale and ``out_proj``'s rows by heads), the
    leaf whole on every model rank elsewhere (attention with t = 1,
    experts or SSM heads T does not split, the norms). Decided from the
    config and the mesh alone; with T = 1 every leaf is whole. It is its
    own plan beside the storage rules
    (``param_shardings``), which often put the model axis on a weight's
    input dim (the largest dim, the first on a tie) where the column split
    needs the output dim."""
    from repro_torch.models.parallel import model_split

    T = dict(mesh.shape).get("model", 1)
    split = model_split(cfg, T)
    heads = "model" if split["t"] == T else ("model", split["t"])
    kinds = dict(enumerate(cfg.pattern_))
    segs = ssm_segments(cfg)

    def entry(path: str, ndim: int) -> Optional[Tuple[int, Any]]:
        """``(dim, spec entry)`` of the one dim the leaf splits on, or None."""
        parts = path.split("/")
        if parts[0] == "embed":
            return (ndim - 2, "model") if split["vocab"] else None  # [V, D] / [K, V, D]
        if parts[0] == "lm_head":
            return (ndim - 1, "model") if split["vocab"] else None
        if parts[0] != "blocks" or len(parts) not in (4, 5):
            return None
        mixer, ff = kinds[int(parts[1])]
        name = parts[-1]
        if len(parts) == 5:  # a MoE layer's shared expert: the MLP's dims
            mlp = ff == "moe" and parts[3].startswith("shared_") and split["moe_shared"]
        else:
            mlp = ff == "mlp" and split["mlp"]
        if parts[2] == "mixer" and mixer == "attn" and split["attn"]:
            if name in ("wq", "bq") or (name in ("wk", "wv", "bk", "bv") and split["kv"]):
                return ndim - 1, heads
            if name == "wo":
                return 1, heads
        if parts[2] == "mixer" and mixer == "ssm" and split["ssm"]:
            if name == "in_proj":  # [P, D, z | x | B | C | dt]
                return ndim - 1, segs["in_proj"]
            if name in ("conv_w", "conv_b"):  # [P, x | B | C, K] / [P, x | B | C]
                return 1, segs["conv"]
            if name in ("A_log", "D", "dt_bias", "norm_scale", "out_proj"):
                return 1, "model"  # [P, H] / [P, d_inner] / [P, d_inner, D]
        if parts[2] == "ff" and mlp:
            if name in ("w_gate", "w_up"):
                return ndim - 1, "model"
            if name == "w_down":
                return 1, "model"
        if parts[2] == "ff" and ff == "moe" and split["moe"] and len(parts) == 4:
            if name in ("w_gate", "w_up", "w_down"):  # [P, E, D, F] / [P, E, F, D]
                return ndim - 3, "model"
        return None

    def one(path, leaf):
        n = len(leaf.shape)
        spec = [None] * n
        got = entry(path, n)
        if got is not None:
            spec[got[0]] = got[1]
        return Placement(mesh, spec)

    return tree_map_with_path(one, params_shape)


def ssm_segments(cfg) -> Dict[str, Spec]:
    """The segmented spec entries of an SSM layer's heads over ``model``:
    ``in_proj``'s columns z | x | B | C | dt (widths d_inner, d_inner, N,
    N, H) and the conv's channels x | B | C, the x, z and dt segments
    split by heads, B and C (one group) whole."""
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {"in_proj": ((din, "model"), (din, "model"), (n, None), (n, None), (h, "model")),
            "conv": ((din, "model"), (n, None), (n, None))}


def compute_blocks(cfg, params, mesh):
    """This rank's compute blocks of a tree of whole parameters (or of a
    checkpoint's whole leaves, ``training/checkpoint.py``), by the plan
    ``compute_shardings``: each split leaf cut to a tensor of its own
    (``Placement.local``), each whole leaf as it is. What
    ``steps.make_prefill_step`` and ``make_serve_step`` take on a mesh
    whose model axis has more than one rank."""
    return tree_map(lambda x, pl: pl.local(x), params, compute_shardings(cfg, params, mesh))


def batch_spec(mesh) -> Spec:
    """Global batch dim over all worker axes."""
    w = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return (w if len(w) > 1 else (w[0] if w else None),)


def worker_grad_spec(param_placement: Placement, mesh) -> Placement:
    """Placement of a ``[W, ...]``-stacked gradient leaf: worker axes on
    dim 0, the param's "model" placements (replicated blocks and segments
    over "model" too) kept, its FSDP placements dropped."""
    w = worker_axes(mesh)
    kept = tuple(s if param_placement.axes(d) == ("model",) else None
                 for d, s in enumerate(param_placement.spec))
    return Placement(mesh, (w if len(w) > 1 else w[0],) + kept)


def constrain_worker_tree(tree, params_sh, mesh):
    """Each ``[W, ...]`` leaf of ``tree`` placed by its worker-stacked
    spec: this rank's block of it (the reference constrains the traced
    program; here the block is cut)."""
    return tree_map(lambda leaf, sh: worker_grad_spec(sh, mesh).local(leaf), tree, params_sh)


def cache_shardings(cache, mesh, batch: int):
    """Decode-cache placements. Leaves: [period, B, L, KV, dh] (attn k/v),
    [period, B, K-1, C] (conv), [period, B, H, P, N] (ssm state)."""
    axes = dict(mesh.shape)
    w_axes = tuple(a for a in ("pod", "data") if a in axes)
    n_work = math.prod(axes[a] for a in w_axes)
    model_size = axes.get("model", 1)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        # dim 0 = period axis (never sharded); dim 1 = batch
        if batch % n_work == 0 and batch >= n_work:
            spec[1] = w_axes if len(w_axes) > 1 else w_axes[0]
            # shard heads/channels over model where divisible
            d = _pick_dim(shape, model_size, {0, 1}, 2)
            if d is not None:
                spec[d] = "model"
        else:
            # batch-1 long-context: sequence-shard the cache over data,
            # heads over model where divisible.
            last = path.split("/")[-1]
            if ("k" in last or "v" in last) and len(shape) == 5:
                if shape[2] % axes.get("data", 1) == 0:
                    spec[2] = "data"
                if shape[3] % model_size == 0 and shape[3] >= model_size:
                    spec[3] = "model"
            else:
                d = _pick_dim(shape, model_size, {0, 1}, 2)
                if d is not None:
                    spec[d] = "model"
        return Placement(mesh, spec)

    return tree_map_with_path(one, cache)


def local_zeros(specs, placements, device=None):
    """Zero blocks for a tree of ``TensorSpec``s placed by ``placements``:
    this rank's share of, say, ``make_serve_step``'s cache."""
    return tree_map(lambda s, pl: torch.zeros(pl.local_shape(s.shape), dtype=s.dtype,
                                              device=device), specs, placements)
