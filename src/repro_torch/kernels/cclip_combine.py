"""Unfused centered-clipping update: CUDA kernel ``csrc/cclip.cu``.

Replaces ``repro/kernels/cclip_combine.py::cclip_combine``,
``v' = v + (1/W) sum_i lam_i (x_i - v)`` with ``lam`` known; the combine
pass of ``ops.cclip_aggregate_unfused``, the fused schedule's baseline. X
may be fp32, bf16 or fp16 (one library each); v' is fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import CALLS, LAUNCHES, _build, cost, ref
from repro_torch.kernels.cclip_fused import check_update_args, check_update_shapes

__all__ = ["cclip_combine", "sources"]

_P = ctypes.c_void_p
_ARGS = {"cclip_combine_launch": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P)}


def sources(dtype: torch.dtype = torch.float32):
    return [_build.x_source("cclip", _build.read_source("cclip.cu"), dtype)]


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32):
    (name, text), = sources(dtype)
    return _build.load(name, text, _ARGS)


def cclip_combine(xs: torch.Tensor, v: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """xs: ``[W, d]``; v: ``[d]``; lam: ``[W]`` -> updated centre ``[d]`` fp32.
    CPU tensors take the plain version; CUDA tensors launch the kernel (xs
    fp32, bf16 or fp16, a 16-bit v or lam cast to fp32; contiguous, any
    W >= 1)."""
    CALLS["cclip_combine"] += 1
    check_update_shapes("cclip_combine", xs, v, lam)
    W, d = xs.shape
    if _build.is_fake(xs):
        return cost.fake_call("cclip_combine", cost.cclip_combine(W, d, xs.element_size()),
                              cost.empty_f32(xs, d))
    v, lam = _build.as_f32(v), _build.as_f32(lam)
    if check_update_args("cclip_combine", xs, v, lam):
        return ref.cclip_combine(xs, v, lam)
    out = torch.empty((d,), dtype=torch.float32, device=xs.device)
    if d == 0:
        return out
    code = _lib(xs.dtype).cclip_combine_launch(xs.data_ptr(), v.data_ptr(), lam.data_ptr(),
                                               out.data_ptr(), W, d, _build.stream_of(xs))
    _build.check_launch("cclip_combine", code)
    LAUNCHES["cclip_combine"] += 1
    return out
