"""Fused centered-clipping iteration: CUDA kernel ``csrc/cclip.cu`` (with
``csrc/row_sums.cuh``).

Replaces ``repro/kernels/cclip_fused.py::cclip_fused_iter``. With the clip
weights ``lam`` known, one pass over the ``[W, d]`` stack writes

    v' = v + (1/W) sum_i lam_i (x_i - v)        and     r_i = ||x_i - v'||^2,

the residuals the next iteration's ``lam`` needs. ``cclip_combine`` (the
update alone) is a second entry of the same library.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build, ref

#: columns per block of the kernel (``RS_TILE`` in ``row_sums.cuh``)
TILE_D = 2048

_P = ctypes.c_void_p
_ARGS = {
    "cclip_fused_launch": (_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P),
    "cclip_combine_launch": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P),
}


def sources():
    return [("cclip", _build.read_source("row_sums.cuh") + _build.read_source("cclip.cu"))]


@functools.lru_cache(maxsize=None)
def _lib():
    (name, text), = sources()
    return _build.load(name, text, _ARGS)


def check_update_args(kernel: str, xs: torch.Tensor, v: torch.Tensor,
                      lam: torch.Tensor) -> bool:
    """Shape checks shared with ``cclip_combine``; True when every tensor is
    on the CPU (the plain version runs), else the kernel's own checks."""
    W, d = xs.shape
    if tuple(v.shape) != (d,) or tuple(lam.shape) != (W,):
        raise ValueError(f"{kernel}: v {tuple(v.shape)}, lam {tuple(lam.shape)} for "
                         f"xs {tuple(xs.shape)}")
    if all(t.device.type == "cpu" for t in (xs, v, lam)):
        return True
    _build.check_inputs(kernel, xs=xs, v=v, lam=lam)
    _build.check_rows(kernel, "W", W)
    return False


def cclip_fused_iter(xs: torch.Tensor, v: torch.Tensor,
                     lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs: ``[W, d]``; v: ``[d]``; lam: ``[W]`` -> ``(v' [d], ||x_i - v'||^2
    [W])`` fp32. CPU tensors take the plain version; CUDA tensors launch the
    kernel (fp32, contiguous, any W >= 1; above 64 rows a slower route)."""
    if check_update_args("cclip_fused_iter", xs, v, lam):
        return ref.cclip_fused_iter(xs, v, lam)
    W, d = xs.shape
    v_new = torch.empty((d,), dtype=torch.float32, device=xs.device)
    r2 = torch.empty((W,), dtype=torch.float32, device=xs.device)
    if d == 0:
        return v_new, r2.zero_()
    partial = torch.empty((W, -(-d // TILE_D)), dtype=torch.float32, device=xs.device)
    code = _lib().cclip_fused_launch(xs.data_ptr(), v.data_ptr(), lam.data_ptr(),
                                     v_new.data_ptr(), r2.data_ptr(), partial.data_ptr(),
                                     W, d, _build.stream_of(xs))
    _build.check_launch("cclip_fused_iter", code)
    LAUNCHES["cclip_fused_iter"] += 1
    return v_new, r2
