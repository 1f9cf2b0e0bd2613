"""Unfused centered-clipping update: CUDA kernel ``csrc/cclip.cu``.

Replaces ``repro/kernels/cclip_combine.py::cclip_combine``,
``v' = v + (1/W) sum_i lam_i (x_i - v)`` with ``lam`` known; the combine
pass of ``ops.cclip_aggregate_unfused``, the fused schedule's baseline.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import CALLS, LAUNCHES, _build, ref
from repro_torch.kernels.cclip_fused import check_update_args

__all__ = ["cclip_combine", "sources"]

_P = ctypes.c_void_p
_ARGS = {"cclip_combine_launch": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P)}


def sources():
    return [("cclip", _build.read_source("cclip.cu"))]


@functools.lru_cache(maxsize=None)
def _lib():
    (name, text), = sources()
    return _build.load(name, text, _ARGS)


def cclip_combine(xs: torch.Tensor, v: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """xs: ``[W, d]``; v: ``[d]``; lam: ``[W]`` -> updated centre ``[d]`` fp32.
    CPU tensors take the plain version; CUDA tensors launch the kernel (fp32,
    contiguous, any W >= 1)."""
    CALLS["cclip_combine"] += 1
    if check_update_args("cclip_combine", xs, v, lam):
        return ref.cclip_combine(xs, v, lam)
    W, d = xs.shape
    out = torch.empty((d,), dtype=torch.float32, device=xs.device)
    if d == 0:
        return out
    code = _lib().cclip_combine_launch(xs.data_ptr(), v.data_ptr(), lam.data_ptr(),
                                       out.data_ptr(), W, d, _build.stream_of(xs))
    _build.check_launch("cclip_combine", code)
    LAUNCHES["cclip_combine"] += 1
    return out
