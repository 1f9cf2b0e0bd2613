"""Mixing operator ``Y = M X``: CUDA kernel ``csrc/bucket_mix.cu``.

Replaces ``repro/kernels/bucket_mix.py::bucket_mix``. Bucketing and
resampling (Algorithm 1) are a row-stochastic ``[m, W]`` matrix applied to
the stacked worker gradients ``[W, d]``; with ``m = 1`` the same kernel is
the final weighted combine of the Gram route. X may be fp32, bf16 or fp16
(one library each, ``_build.x_source``); the result is fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import CALLS, LAUNCHES, _build, cost, ref

_ARGS = {"bucket_mix_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_void_p)}


def sources(dtype: torch.dtype = torch.float32):
    return [_build.x_source("bucket_mix", _build.read_source("bucket_mix.cu"), dtype)]


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32):
    (name, text), = sources(dtype)
    return _build.load(name, text, _ARGS)


def bucket_mix(mix: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """mix: ``[m, W]``; xs: ``[W, d]`` -> ``[m, d]`` fp32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (xs fp32, bf16 or fp16, a
    16-bit mix cast to fp32; contiguous, any m, W >= 1)."""
    CALLS["bucket_mix"] += 1
    m, W = mix.shape
    W2, d = xs.shape
    if W != W2:
        raise ValueError(f"bucket_mix: mix {tuple(mix.shape)} vs xs {tuple(xs.shape)}")
    if _build.is_fake(xs):
        return cost.fake_call("bucket_mix", cost.bucket_mix(m, W, d, xs.element_size()),
                              cost.empty_f32(xs, m, d))
    if xs.device.type == "cpu" and mix.device.type == "cpu":
        return ref.bucket_mix(mix, xs)
    mix = _build.as_f32(mix)
    _build.check_inputs("bucket_mix", {"xs": _build.X_DTYPES}, mix=mix, xs=xs)
    _build.check_rows("bucket_mix", "W", W)
    _build.check_rows("bucket_mix", "m", m)
    out = torch.empty((m, d), dtype=torch.float32, device=xs.device)
    if d == 0:
        return out
    threads = _build.fitted_threads(-(-d // 4), _build.sm_count(xs.device.index))
    code = _lib(xs.dtype).bucket_mix_launch(mix.data_ptr(), xs.data_ptr(), out.data_ptr(),
                                    m, W, d, threads, _build.stream_of(xs))
    _build.check_launch("bucket_mix", code)
    LAUNCHES["bucket_mix"] += 1
    return out
