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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES, _build, ref

#: columns per unit of the kernel (``GR_UNIT`` in the source) and per tile
#: of the plain version's sum
TILE_D = ref.GRAM_TILE

_ARGS = {"pairwise_gram_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)}
_TMA_MAX_D = 2 ** 31 - 2 * TILE_D  # TMA's column coordinate is a 32-bit int


def sources():
    return [("pairwise_gram",
             _build.read_source("tma.cuh") + _build.read_source("pairwise_gram.cu"))]


@functools.lru_cache(maxsize=None)
def _lib():
    (name, text), = sources()
    return _build.load(name, text, _ARGS)


def variant(d: int, data_ptr: int) -> str:
    """How the kernel stages ``X [W, d]``: ``"gram_tma"`` (a TMA tensor map,
    which needs 16-byte aligned rows: ``d % 4 == 0`` and a 16-byte aligned
    base) or ``"gram_ldg"`` (predicated loads into the same layout)."""
    aligned = d % 4 == 0 and data_ptr % 16 == 0 and d <= _TMA_MAX_D
    return "gram_tma" if aligned else "gram_ldg"


def pairwise_gram(xs: torch.Tensor, acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs: ``[W, d]`` -> ``[W, W]`` fp32 (``acc +`` if given). CPU tensors take
    the plain version; CUDA tensors launch the kernel (fp32, contiguous,
    1 <= W <= 64, d >= 1)."""
    W, d = xs.shape
    if acc is not None and tuple(acc.shape) != (W, W):
        raise ValueError(f"pairwise_gram: acc {tuple(acc.shape)} for W={W}")
    if xs.device.type == "cpu" and (acc is None or acc.device.type == "cpu"):
        return ref.pairwise_gram(xs, acc)
    tensors = {"xs": xs} if acc is None else {"xs": xs, "acc": acc}
    _build.check_inputs("pairwise_gram", **tensors)
    _build.check_rows("pairwise_gram", "W", W)
    if d < 1:
        raise ValueError("pairwise_gram: d must be >= 1")
    n_units = -(-d // TILE_D)
    pairs = W * (W + 1) // 2
    out = torch.empty((W, W), dtype=torch.float32, device=xs.device)
    partial = torch.empty((n_units, -(-pairs // 32) * 32), dtype=torch.float32,
                          device=xs.device)
    counter = torch.zeros(1, dtype=torch.int32, device=xs.device)  # the fold's ticket
    kind = variant(d, xs.data_ptr())
    code = _lib().pairwise_gram_launch(
        xs.data_ptr(), None if acc is None else acc.data_ptr(), out.data_ptr(),
        partial.data_ptr(), counter.data_ptr(), W, d, int(kind == "gram_tma"),
        _build.stream_of(xs))
    _build.check_launch("pairwise_gram", code)
    LAUNCHES["pairwise_gram"] += 1
    VARIANT_LAUNCHES[kind] += 1
    return out
