"""Coordinate-wise median over the worker axis: CUDA kernel generated from
``csrc/selection.cu``.

Replaces ``repro/kernels/cwise_median.py::cwise_median``. The source for a
worker count W carries the pruned Batcher program
``selection_program(W, median_ranks(W))`` unrolled into register
compare-exchanges; for even W the result is ``0.5 * (a + b)`` of the two
middle order statistics, in the reference's order of operations.
``select`` launches a library built from that template (the trimmed
mean's too) in blocks of ``threads_for`` threads. The generated source and
the library's name carry X's element type (fp32, bf16 or fp16, converted
to fp32 at the load: ``_build.x_source``), so one library serves one
(W, dtype); the result is fp32.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from repro_torch.kernels import CALLS, LAUNCHES, _build, cost, ref
from repro_torch.kernels.selection_network import emit_cuda, median_ranks

SELECT_ARGS = {"select_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_void_p)}
#: widest W whose blocks are fitted to the card; wider W, whose threads hold
#: more registers, takes WIDE_THREADS-thread blocks
FITTED_MAX_W = 32
WIDE_THREADS = 64


def sources(W: int, dtype: torch.dtype = torch.float32):
    ranks = median_ranks(W)
    if len(ranks) == 1:
        result = f"res = v[{ranks[0]}];"
    else:
        result = f"res = __fmul_rn(0.5f, __fadd_rn(v[{ranks[0]}], v[{ranks[1]}]));"
    text = emit_cuda(_build.read_source("selection.cu"), W, ranks, result)
    return [_build.x_source(f"cwise_median_w{W}", text, dtype)]


@functools.lru_cache(maxsize=None)
def _lib(W: int, dtype: torch.dtype = torch.float32):
    (name, text), = sources(W, dtype)
    return _build.load(name, text, SELECT_ARGS)


def threads_for(W: int, d: int, n_sm: int) -> int:
    """Threads a block (one column a thread): up to ``FITTED_MAX_W`` rows the
    fewest that cover the columns with one block an SM; above, 64, so
    blocks of many registers pack several to an SM."""
    return _build.fitted_threads(d, n_sm) if W <= FITTED_MAX_W else WIDE_THREADS


def select(kernel: str, lib, xs: torch.Tensor) -> torch.Tensor:
    """Launch a selection library on ``xs`` [W, d] (checked by the caller,
    d >= 1) in blocks of ``threads_for`` threads and return its ``[d]``
    result."""
    W, d = xs.shape
    out = torch.empty((d,), dtype=torch.float32, device=xs.device)
    threads = threads_for(W, d, _build.sm_count(xs.device.index))
    code = lib.select_launch(xs.data_ptr(), out.data_ptr(), d, threads, _build.stream_of(xs))
    _build.check_launch(kernel, code)
    return out


def cwise_median(xs: torch.Tensor) -> torch.Tensor:
    """xs: ``[W, d]`` -> median over workers ``[d]`` fp32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (fp32, bf16 or fp16,
    contiguous, any W >= 1)."""
    CALLS["cwise_median"] += 1
    W, d = xs.shape
    if _build.is_fake(xs):
        return cost.fake_call("cwise_median", cost.selection(W, d, None, xs.element_size()),
                              cost.empty_f32(xs, d))
    if xs.device.type == "cpu":
        return ref.cwise_median(xs)
    _build.check_inputs("cwise_median", {"xs": _build.X_DTYPES}, xs=xs)
    _build.check_rows("cwise_median", "W", W)
    if d == 0:
        return torch.empty((0,), dtype=torch.float32, device=xs.device)
    out = select("cwise_median", _lib(W, xs.dtype), xs)
    LAUNCHES["cwise_median"] += 1
    return out
