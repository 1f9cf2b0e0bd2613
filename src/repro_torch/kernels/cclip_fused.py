"""Fused centered-clipping iteration: the CLIP form of the residual-norms
kernel, ``csrc/residual_norms.cu`` (entry ``cclip_fused_launch``).

Replaces ``repro/kernels/cclip_fused.py::cclip_fused_iter``. With the clip
weights ``lam`` known, one pass over the ``[W, d]`` stack writes

    v' = v + (1/W) sum_i lam_i (x_i - v)        and     r_i = ||x_i - v'||^2,

the residuals the next iteration's ``lam`` needs. It is one launch of the
``residual_norms`` library, with that module's launch geometry and ticket
counters (one library, launched on one stream, so launches serialise and
a counter is back at zero after each). ``v'`` has the bits of
``cclip_combine`` on the same inputs (the same fmaf chain). X may be fp32,
bf16 or fp16 (the library built for its type); v' and the norms are fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import CALLS, LAUNCHES, _build, cost, ref
from repro_torch.kernels import weiszfeld_norms as wn


def sources(dtype: torch.dtype = torch.float32):
    """The library this kernel launches: ``residual_norms``'s, built once."""
    return wn.sources(dtype)


def check_update_shapes(kernel: str, xs: torch.Tensor, v: torch.Tensor,
                        lam: torch.Tensor) -> None:
    W, d = xs.shape
    if tuple(v.shape) != (d,) or tuple(lam.shape) != (W,):
        raise ValueError(f"{kernel}: v {tuple(v.shape)}, lam {tuple(lam.shape)} for "
                         f"xs {tuple(xs.shape)}")


def check_update_args(kernel: str, xs: torch.Tensor, v: torch.Tensor,
                      lam: torch.Tensor) -> bool:
    """Checks shared with ``cclip_combine`` (after ``check_update_shapes``
    and the fp32 cast of v and lam): True when every tensor is on the CPU
    (the plain version runs), else the kernel's own checks."""
    if all(t.device.type == "cpu" for t in (xs, v, lam)):
        return True
    _build.check_inputs(kernel, {"xs": _build.X_DTYPES}, xs=xs, v=v, lam=lam)
    _build.check_rows(kernel, "W", xs.shape[0])
    return False


def launch(xs: torch.Tensor, v: torch.Tensor, lam: torch.Tensor, v_new: torch.Tensor,
           r2: torch.Tensor) -> None:
    """One launch of the kernel into ``v_new`` [d] and ``r2`` [W] (checked
    CUDA tensors, d >= 1); ``v_new`` may be any contiguous slice, 16-byte
    aligned or not."""
    W, d = xs.shape
    threads, blocks = wn.geometry(W, d, _build.sm_count(xs.device.index))
    partial = torch.empty((W, blocks), dtype=torch.float32, device=xs.device)
    stream = _build.stream_of(xs)
    code = wn._lib(xs.dtype).cclip_fused_launch(
        xs.data_ptr(), v.data_ptr(), lam.data_ptr(), v_new.data_ptr(), r2.data_ptr(),
        partial.data_ptr(), wn._ticket(xs.device, stream).data_ptr(), W, d, threads, blocks,
        stream)
    _build.check_launch("cclip_fused_iter", code)
    LAUNCHES["cclip_fused_iter"] += 1


def cclip_fused_iter(xs: torch.Tensor, v: torch.Tensor,
                     lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs: ``[W, d]``; v: ``[d]``; lam: ``[W]`` -> ``(v' [d], ||x_i - v'||^2
    [W])`` fp32. CPU tensors take the plain version; CUDA tensors launch the
    kernel (xs fp32, bf16 or fp16, a 16-bit v or lam cast to fp32;
    contiguous, any W >= 1)."""
    CALLS["cclip_fused_iter"] += 1
    check_update_shapes("cclip_fused_iter", xs, v, lam)
    W, d = xs.shape
    if _build.is_fake(xs):
        return cost.fake_call("cclip_fused_iter",
                              cost.cclip_fused_iter(W, d, xs.element_size()),
                              (cost.empty_f32(xs, d), cost.empty_f32(xs, W)))
    v, lam = _build.as_f32(v), _build.as_f32(lam)
    if check_update_args("cclip_fused_iter", xs, v, lam):
        return ref.cclip_fused_iter(xs, v, lam)
    v_new = torch.empty((d,), dtype=torch.float32, device=xs.device)
    r2 = torch.empty((W,), dtype=torch.float32, device=xs.device)
    if d == 0:
        return v_new, r2.zero_()
    launch(xs, v, lam, v_new, r2)
    return v_new, r2
