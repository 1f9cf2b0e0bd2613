"""Per-worker residual norms ``r_i = ||x_i - v||^2``: CUDA kernel
``csrc/residual_norms.cu``.

Replaces ``repro/kernels/weiszfeld_norms.py::residual_norms``, the inner
loop of smoothed Weiszfeld (RFA) and the first norms pass of centered
clipping. The centre is given either as coefficients ``coeffs`` (``v =
c^T X``, formed per column inside the kernel and never written out) or as an
explicit row ``center``. The same kernel has a third centre form, the
centered-clipping update, which ``cclip_fused.cclip_fused_iter`` launches
through this library (entry ``cclip_fused_launch``).

The kernel folds its blocks' partial sums in the same launch: the block
that draws the last ticket of a counter adds them, and sets the counter
back to zero. The counters belong to this module, one per device and
stream, and one more for the graph capture under way on a stream
(``_ticket``), so two launches that may run at once never share one.

X may be fp32, bf16 or fp16: each type is a library of its own
(``_build.x_source``); the centre or coefficients are taken in fp32 (a
16-bit one is cast, as the reference's wrapper does) and the norms are fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import CALLS, LAUNCHES, _build, cost, ref

_P = ctypes.c_void_p
_ARGS = {
    "residual_norms_launch": (_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, _P),
    "cclip_fused_launch": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, _P),
    "rn_capture_id": (_P, ctypes.POINTER(ctypes.c_ulonglong)),
}
#: (device, stream, under capture) -> (capture id, ticket counter)
_TICKETS: Dict[Tuple[int, int, bool], Tuple[int, torch.Tensor]] = {}


def sources(dtype: torch.dtype = torch.float32):
    return [_build.x_source("residual_norms", _build.read_source("residual_norms.cu"), dtype)]


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32):
    (name, text), = sources(dtype)
    return _build.load(name, text, _ARGS)


#: threads a block (``RN_THREADS``)
THREADS = 256


def geometry(W: int, d: int, n_sm: int) -> Tuple[int, int]:
    """``(threads, blocks)`` of a launch: 256 threads, one group of 4
    columns a thread, and at most as many blocks as fit on the card at once
    (``RN_MIN_BLOCKS``: 2 an SM up to W = 8, 1 above), each owning a
    contiguous range of column groups."""
    n_vec = -(-d // 4)
    per_sm = 2 if W <= 8 else 1
    return THREADS, min(-(-n_vec // THREADS), n_sm * per_sm)


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The zeroed counter for a launch on ``stream``. Under a graph capture
    it is made (and zeroed, by a node of that graph) once per capture; the
    previous capture's counter stays with its graph's memory pool."""
    cid = ctypes.c_ulonglong()
    _build.check_launch("residual_norms", _lib().rn_capture_id(stream, ctypes.byref(cid)))
    key = (device.index, stream, cid.value != 0)
    held = _TICKETS.get(key)
    if held is None or held[0] != cid.value:
        held = _TICKETS[key] = (cid.value, torch.zeros(1, dtype=torch.int32, device=device))
    return held[1]


def residual_norms(xs: torch.Tensor, coeffs: Optional[torch.Tensor] = None, *,
                   center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs: ``[W, d]`` -> ``[W]`` fp32, against ``v = coeffs^T xs`` (``coeffs``
    ``[W]``) or an explicit ``center`` ``[d]``; exactly one of the two, else
    ``ValueError``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (xs fp32, bf16 or fp16, a 16-bit centre or coefficients cast
    to fp32; contiguous, any W >= 1)."""
    CALLS["residual_norms"] += 1
    if (coeffs is None) == (center is None):
        raise ValueError("provide exactly one of coeffs / center")
    W, d = xs.shape
    given = coeffs if center is None else center
    if tuple(given.shape) != ((W,) if center is None else (d,)):
        raise ValueError(f"residual_norms: {tuple(given.shape)} for xs {tuple(xs.shape)}")
    if _build.is_fake(xs):
        return cost.fake_call("residual_norms",
                              cost.residual_norms(W, d, xs.element_size(), center is not None),
                              cost.empty_f32(xs, W))
    if xs.device.type == "cpu" and given.device.type == "cpu":
        return ref.residual_norms(xs, coeffs, center=center)
    coeffs, center = _build.as_f32(coeffs), _build.as_f32(center)
    _build.check_inputs("residual_norms", {"xs": _build.X_DTYPES}, xs=xs,
                        **({"coeffs": coeffs} if center is None else {"center": center}))
    _build.check_rows("residual_norms", "W", W)
    out = torch.empty((W,), dtype=torch.float32, device=xs.device)
    if d == 0:
        return out.zero_()
    threads, blocks = geometry(W, d, _build.sm_count(xs.device.index))
    partial = torch.empty((W, blocks), dtype=torch.float32, device=xs.device)
    stream = _build.stream_of(xs)
    code = _lib(xs.dtype).residual_norms_launch(
        xs.data_ptr(), None if coeffs is None else coeffs.data_ptr(),
        None if center is None else center.data_ptr(), out.data_ptr(), partial.data_ptr(),
        _ticket(xs.device, stream).data_ptr(), W, d, threads, blocks, stream)
    _build.check_launch("residual_norms", code)
    LAUNCHES["residual_norms"] += 1
    return out
