"""Worker Gram matrix ``G = acc + X X^T``: CUDA kernel ``csrc/pairwise_gram.cu``
(with ``csrc/tma.cuh``).

Replaces ``repro/kernels/pairwise_gram.py::pairwise_gram``. The kernel sums
fixed ``TILE_D``-column units and folds them in column order from ``acc``,
so a chain of calls over ``TILE_D``-aligned column segments, each seeded
with the previous result, equals one call over the whole buffer bit for
bit (the reference's ``acc`` / ``full_blocks`` contract; the packer pads
every leaf to a ``TILE_D`` multiple). ``variant`` picks how the kernel
stages X, by TMA or by predicated loads, before the launch;
``VARIANT_LAUNCHES`` counts each. Both give the same bits.

X may be fp32, bf16 or fp16 (one library each, ``_build.x_source``). Either
way X is staged in its own type: by a TMA tensor map of that type
(``gram_tma``, whatever the dtype) where its rows are 16-byte aligned, else
by predicated loads (``gram_ldg``); the kernel widens a 16-bit element to
fp32 where it reads it from shared memory (exact), so the Gram of ``X16``
is the Gram of ``X16.float()`` bit for bit on either route. ``acc`` is
taken in fp32 (a 16-bit one is cast) and the result is fp32.

The kernel takes at most 64 rows (``MAX_ROWS``). More rows go through
``grouped_gram``: groups of at most 32 rows, one kernel call for each pair
of groups on their rows stacked.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.kernels import CALLS, LAUNCHES, VARIANT_LAUNCHES, _build, cost, ref

#: columns per unit of the kernel (``GR_UNIT`` in the source) and per tile
#: of the plain version's sum
TILE_D = ref.GRAM_TILE

_ARGS = {"pairwise_gram_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)}
_TMA_MAX_D = 2 ** 31 - 2 * TILE_D  # TMA's column coordinate is a 32-bit int
#: rows the kernel takes in one call, and rows of a group of ``grouped_gram``
MAX_ROWS = 64
GROUP_ROWS = MAX_ROWS // 2


def sources(dtype: torch.dtype = torch.float32):
    return [_build.x_source("pairwise_gram", _build.read_source("tma.cuh")
                            + _build.read_source("pairwise_gram.cu"), dtype)]


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32):
    (name, text), = sources(dtype)
    return _build.load(name, text, _ARGS)


def variant(d: int, data_ptr: int, dtype: torch.dtype = torch.float32) -> str:
    """How the kernel stages ``X [W, d]`` of ``dtype``: ``"gram_tma"`` (a TMA
    tensor map of X's type, which needs 16-byte aligned rows: ``d`` a
    multiple of 4 fp32 or 8 16-bit elements and a 16-byte aligned base) or
    ``"gram_ldg"`` (predicated loads into the same layout)."""
    row_bytes = d * torch.finfo(dtype).bits // 8
    aligned = row_bytes % 16 == 0 and data_ptr % 16 == 0 and d <= _TMA_MAX_D
    return "gram_tma" if aligned else "gram_ldg"


def row_groups(W: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` row bounds of ``ceil(W / GROUP_ROWS)`` groups of W rows,
    sizes as equal as they can be (the first ``W % n`` one row larger)."""
    n = -(-W // GROUP_ROWS)
    q, r = divmod(W, n)
    bounds = [0]
    for g in range(n):
        bounds.append(bounds[-1] + q + (g < r))
    return list(zip(bounds[:-1], bounds[1:]))


def grouped_gram(xs: torch.Tensor, acc: Optional[torch.Tensor],
                 gram: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
                 ) -> torch.Tensor:
    """``acc + X X^T`` for any W from calls ``gram(rows, acc)`` on at most
    ``MAX_ROWS`` rows (the kernel's wrapper on the card; the tests pass an
    emulation of its order).

    The rows form groups of at most ``GROUP_ROWS`` (``row_groups``). Each
    pair of groups a < b is one call on the two groups' rows stacked, with
    the matching blocks of ``acc`` gathered in: it gives blocks (a, b) and
    (b, a), and group a's diagonal block where b = a + 1 (the last group's
    comes from the pair before it). A block's bits depend only on W, which
    fixes the groups and so each call's row count and order of summation,
    and on its own columns. So the result is symmetric where ``acc`` is,
    repeats bit for bit, and a chain of calls over 2048-aligned column
    segments, each seeded with the previous result, equals one call."""
    W = xs.shape[0]
    groups = row_groups(W)
    last = len(groups) - 1
    out = torch.empty((W, W), dtype=torch.float32, device=xs.device)
    for a, (a0, a1) in enumerate(groups):
        for b in range(a + 1, len(groups)):
            b0, b1 = groups[b]
            n = a1 - a0
            sub_acc = None
            if acc is not None:
                idx = torch.cat([torch.arange(a0, a1), torch.arange(b0, b1)]).to(acc.device)
                sub_acc = acc[idx][:, idx].contiguous()
            g = gram(torch.cat([xs[a0:a1], xs[b0:b1]]), sub_acc)
            out[a0:a1, b0:b1] = g[:n, n:]
            out[b0:b1, a0:a1] = g[n:, :n]
            if b == a + 1:
                out[a0:a1, a0:a1] = g[:n, :n]
                if b == last:
                    out[b0:b1, b0:b1] = g[n:, n:]
    return out


def pairwise_gram(xs: torch.Tensor, acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs: ``[W, d]`` -> ``[W, W]`` fp32 (``acc +`` if given). CPU tensors take
    the plain version; CUDA tensors launch the kernel (xs fp32, bf16 or
    fp16, a 16-bit acc cast to fp32; contiguous, d >= 1; above ``MAX_ROWS``
    rows, one launch per pair of row groups, ``grouped_gram``)."""
    CALLS["pairwise_gram"] += 1
    W, d = xs.shape
    if acc is not None and tuple(acc.shape) != (W, W):
        raise ValueError(f"pairwise_gram: acc {tuple(acc.shape)} for W={W}")
    if _build.is_fake(xs):
        return cost.fake_call("pairwise_gram",
                              cost.pairwise_gram(W, d, xs.element_size(), acc is not None),
                              cost.empty_f32(xs, W, W))
    if xs.device.type == "cpu" and (acc is None or acc.device.type == "cpu"):
        return ref.pairwise_gram(xs, acc)
    acc = _build.as_f32(acc)
    tensors = {"xs": xs} if acc is None else {"xs": xs, "acc": acc}
    _build.check_inputs("pairwise_gram", {"xs": _build.X_DTYPES}, **tensors)
    _build.check_rows("pairwise_gram", "W", W)
    if d < 1:
        raise ValueError("pairwise_gram: d must be >= 1")
    if W > MAX_ROWS:
        return grouped_gram(xs, acc, pairwise_gram)
    n_units = -(-d // TILE_D)
    pairs = W * (W + 1) // 2
    out = torch.empty((W, W), dtype=torch.float32, device=xs.device)
    partial = torch.empty((n_units, -(-pairs // 32) * 32), dtype=torch.float32,
                          device=xs.device)
    counter = torch.zeros(1, dtype=torch.int32, device=xs.device)  # the fold's ticket
    kind = variant(d, xs.data_ptr(), xs.dtype)
    code = _lib(xs.dtype).pairwise_gram_launch(
        xs.data_ptr(), None if acc is None else acc.data_ptr(), out.data_ptr(),
        partial.data_ptr(), counter.data_ptr(), W, d, int(kind == "gram_tma"),
        _build.stream_of(xs))
    _build.check_launch("pairwise_gram", code)
    LAUNCHES["pairwise_gram"] += 1
    VARIANT_LAUNCHES[kind] += 1
    return out
