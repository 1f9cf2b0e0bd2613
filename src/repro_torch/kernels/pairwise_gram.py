"""Worker Gram matrix ``G = acc + X X^T``: CUDA kernel ``csrc/pairwise_gram.cu``.

Replaces ``repro/kernels/pairwise_gram.py::pairwise_gram``. The kernel sums
fixed ``TILE_D``-column tiles and folds them in column order from ``acc``,
so a chain of calls over ``TILE_D``-aligned column segments, each seeded
with the previous result, equals one call over the whole buffer bit for
bit (the reference's ``acc`` / ``full_blocks`` contract; the packer pads
every leaf to a ``TILE_D`` multiple).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, ref

#: columns per tile of the kernel (``GR_TILE`` in the source) and of the
#: plain version's sum
TILE_D = ref.GRAM_TILE

_ARGS = {"pairwise_gram_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_void_p)}


def sources():
    return [("pairwise_gram", _build.read_source("pairwise_gram.cu"))]


@functools.lru_cache(maxsize=None)
def _lib():
    (name, text), = sources()
    return _build.load(name, text, _ARGS)


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
    n_tiles = -(-d // TILE_D)
    out = torch.empty((W, W), dtype=torch.float32, device=xs.device)
    partial = torch.empty((n_tiles, W * (W + 1) // 2), dtype=torch.float32,
                          device=xs.device)
    code = _lib().pairwise_gram_launch(
        xs.data_ptr(), None if acc is None else acc.data_ptr(), out.data_ptr(),
        partial.data_ptr(), W, d, _build.stream_of(xs))
    _build.check_launch("pairwise_gram", code)
    LAUNCHES["pairwise_gram"] += 1
    return out
