"""Per-worker residual norms ``r_i = ||x_i - v||^2``: CUDA kernel
``csrc/residual_norms.cu`` (with ``csrc/row_sums.cuh``).

Replaces ``repro/kernels/weiszfeld_norms.py::residual_norms``, the inner
loop of smoothed Weiszfeld (RFA) and the first norms pass of centered
clipping. The centre is given either as coefficients ``coeffs`` (``v =
c^T X``, formed per column inside the kernel and never written out) or as an
explicit row ``center``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, ref

#: columns per block of the kernel (``RS_TILE`` in ``row_sums.cuh``)
TILE_D = 2048

_ARGS = {"residual_norms_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_void_p)}


def sources():
    return [("residual_norms",
             _build.read_source("row_sums.cuh") + _build.read_source("residual_norms.cu"))]


@functools.lru_cache(maxsize=None)
def _lib():
    (name, text), = sources()
    return _build.load(name, text, _ARGS)


def residual_norms(xs: torch.Tensor, coeffs: Optional[torch.Tensor] = None, *,
                   center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs: ``[W, d]`` -> ``[W]`` fp32, against ``v = coeffs^T xs`` (``coeffs``
    ``[W]``) or an explicit ``center`` ``[d]``; exactly one of the two, else
    ``ValueError``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (fp32, contiguous, 1 <= W <= 64)."""
    if (coeffs is None) == (center is None):
        raise ValueError("provide exactly one of coeffs / center")
    W, d = xs.shape
    given = coeffs if center is None else center
    if tuple(given.shape) != ((W,) if center is None else (d,)):
        raise ValueError(f"residual_norms: {tuple(given.shape)} for xs {tuple(xs.shape)}")
    if xs.device.type == "cpu" and given.device.type == "cpu":
        return ref.residual_norms(xs, coeffs, center=center)
    _build.check_inputs("residual_norms", xs=xs, **({"coeffs": coeffs} if center is None
                                                     else {"center": center}))
    _build.check_rows("residual_norms", "W", W)
    out = torch.empty((W,), dtype=torch.float32, device=xs.device)
    if d == 0:
        return out.zero_()
    partial = torch.empty((W, -(-d // TILE_D)), dtype=torch.float32, device=xs.device)
    code = _lib().residual_norms_launch(
        xs.data_ptr(), None if coeffs is None else coeffs.data_ptr(),
        None if center is None else center.data_ptr(), out.data_ptr(), partial.data_ptr(),
        W, d, _build.stream_of(xs))
    _build.check_launch("residual_norms", code)
    LAUNCHES["residual_norms"] += 1
    return out
