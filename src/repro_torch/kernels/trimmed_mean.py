"""Coordinate-wise trimmed mean over the worker axis: CUDA kernel generated
from ``csrc/selection.cu``.

Replaces ``repro/kernels/trimmed_mean.py::cwise_trimmed_mean``. The source
for ``(W, n_trim)`` carries ``selection_program(W, trim_ranks(W, n_trim))``
unrolled into register compare-exchanges, then sums the sorted band
``[n_trim, W - n_trim)`` in rank order and scales the sum by the fp32
reciprocal of the band length (``selection_network.band_scale``).
``n_trim == 0`` has no program and sums the rows in row order. X may be
fp32, bf16 or fp16: the generated source and the library's name carry its
type (``_build.x_source``); the result is fp32.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import CALLS, LAUNCHES, _build, cost, ref
from repro_torch.kernels.cwise_median import SELECT_ARGS, select
from repro_torch.kernels.selection_network import band_scale, emit_cuda, trim_ranks


def _check_trim(W: int, n_trim: int) -> None:
    if not 0 <= n_trim <= (W - 1) // 2:
        raise ValueError(f"n_trim={n_trim} out of range for W={W}")


def sources(W: int, n_trim: int, dtype: torch.dtype = torch.float32):
    _check_trim(W, n_trim)
    band = tuple(range(W)) if n_trim == 0 else trim_ranks(W, n_trim)
    lines = [f"float s = v[{band[0]}];"]
    lines += [f"s = __fadd_rn(s, v[{r}]);" for r in band[1:]]
    lines.append(f"res = __fmul_rn(s, {band_scale(len(band)).hex()}f);")
    program_ranks = () if n_trim == 0 else band
    text = emit_cuda(_build.read_source("selection.cu"), W, program_ranks,
                     "\n    ".join(lines))
    return [_build.x_source(f"cwise_trimmed_mean_w{W}_b{n_trim}", text, dtype)]


@functools.lru_cache(maxsize=None)
def _lib(W: int, n_trim: int, dtype: torch.dtype = torch.float32):
    (name, text), = sources(W, n_trim, dtype)
    return _build.load(name, text, SELECT_ARGS)


def cwise_trimmed_mean(xs: torch.Tensor, n_trim: int) -> torch.Tensor:
    """xs: ``[W, d]`` -> mean of the sorted ``[n_trim, W - n_trim)`` band,
    ``[d]`` fp32; ``ValueError`` unless ``0 <= n_trim <= (W - 1) // 2``. CPU
    tensors take the plain version; CUDA tensors launch the kernel (fp32,
    bf16 or fp16, contiguous, any W >= 1)."""
    CALLS["cwise_trimmed_mean"] += 1
    W, d = xs.shape
    _check_trim(W, n_trim)
    if _build.is_fake(xs):
        return cost.fake_call("cwise_trimmed_mean",
                              cost.selection(W, d, n_trim, xs.element_size()),
                              cost.empty_f32(xs, d))
    if xs.device.type == "cpu":
        return ref.cwise_trimmed_mean(xs, n_trim)
    _build.check_inputs("cwise_trimmed_mean", {"xs": _build.X_DTYPES}, xs=xs)
    _build.check_rows("cwise_trimmed_mean", "W", W)
    if d == 0:
        return torch.empty((0,), dtype=torch.float32, device=xs.device)
    out = select("cwise_trimmed_mean", _lib(W, n_trim, xs.dtype), xs)
    LAUNCHES["cwise_trimmed_mean"] += 1
    return out
