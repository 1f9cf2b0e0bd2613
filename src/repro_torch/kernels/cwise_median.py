"""Coordinate-wise median over the worker axis: CUDA kernel generated from
``csrc/selection.cu``.

Replaces ``repro/kernels/cwise_median.py::cwise_median``. The source for a
worker count W carries the pruned Batcher program
``selection_program(W, median_ranks(W))`` unrolled into register
compare-exchanges; for even W the result is ``0.5 * (a + b)`` of the two
middle order statistics, in the reference's order of operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build, ref
from repro_torch.kernels.selection_network import emit_cuda, median_ranks

SELECT_ARGS = {"select_launch": (ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p)}


def sources(W: int):
    ranks = median_ranks(W)
    if len(ranks) == 1:
        result = f"res = v[{ranks[0]}];"
    else:
        result = f"res = __fmul_rn(0.5f, __fadd_rn(v[{ranks[0]}], v[{ranks[1]}]));"
    text = emit_cuda(_build.read_source("selection.cu"), W, ranks, result)
    return [(f"cwise_median_w{W}", text)]


@functools.lru_cache(maxsize=None)
def _lib(W: int):
    (name, text), = sources(W)
    return _build.load(name, text, SELECT_ARGS)


def cwise_median(xs: torch.Tensor) -> torch.Tensor:
    """xs: ``[W, d]`` -> median over workers ``[d]`` fp32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (fp32, contiguous,
    any W >= 1)."""
    W, d = xs.shape
    if xs.device.type == "cpu":
        return ref.cwise_median(xs)
    _build.check_inputs("cwise_median", xs=xs)
    _build.check_rows("cwise_median", "W", W)
    out = torch.empty((d,), dtype=torch.float32, device=xs.device)
    if d == 0:
        return out
    code = _lib(W).select_launch(xs.data_ptr(), out.data_ptr(), d,
                                 _build.stream_of(xs))
    _build.check_launch("cwise_median", code)
    LAUNCHES["cwise_median"] += 1
    return out
