"""Causal GQA flash attention: CUDA kernels ``csrc/flash_attention_wgmma.cu``
(bf16 on the tensor cores) and ``csrc/flash_attention.cu`` (fp32, and the
bf16 inputs the first does not take).

Replaces ``repro/kernels/flash_attention.py::flash_attention`` and keeps its
entry point: the same signature (without ``interpret``), the same mask
semantics, the same refusal of lengths that the caller's blocks do not
divide. As in the reference, no model path calls it; ``chip_smoke.py``
holds it on the card at the attention shapes of the ported LLM configs and
on the serving model's own q/k/v. ``variant`` picks the kernel from dtype,
head dim and alignment before the launch; ``VARIANT_LAUNCHES`` counts each.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Iterable

import torch

from repro_torch.kernels import CALLS, LAUNCHES, VARIANT_LAUNCHES, _build, cost, ref

_COMMON = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v out
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B Sq Skv H KV
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dh causal window q_offset
           ctypes.c_float)  # scale (simt) or scale * log2(e) (wgmma)
_ARGS = {"simt": {"flash_attention_launch": _COMMON + (ctypes.c_int, ctypes.c_void_p)},  # bf16
         "wgmma": {"flash_attention_wgmma_launch": _COMMON + (ctypes.c_void_p,)}}
_NAMES = {"simt": "flash_attention", "wgmma": "flash_attention_wgmma"}  # csrc/<name>.cu

#: a masked logit: the reference kernel's ``NEG_INF``, the plain version's
#: (``ref.attention``) and the fp32 kernel's ``FA_NEG_INF``; the bf16
#: kernel masks its edge tiles with -inf
NEG_INF = -1e30
#: largest head dim the kernel's templates cover
MAX_HEAD_DIM = 256
_GRID_LIMIT = 65535  # gridDim.y and gridDim.z: heads and batch (simt), batch (wgmma)


def _text(kind: str) -> str:
    text = _build.read_source(_NAMES[kind] + ".cu")
    return _build.read_source("tma.cuh") + text if kind == "wgmma" else text


def sources():
    return [(_NAMES[kind], _text(kind)) for kind in _NAMES]


@functools.lru_cache(maxsize=None)
def _lib(kind: str):
    return _build.load(_NAMES[kind], _text(kind), _ARGS[kind])


def variant(dtype: torch.dtype, dh: int, data_ptrs: Iterable[int]) -> str:
    """The CUDA kernel a call takes: ``"wgmma"`` (tensor cores, TMA) for bf16
    with ``dh % 8 == 0`` and every pointer 16-byte aligned (TMA's rule for
    the base address and the row strides), else ``"simt"`` (fp32 math on the
    CUDA cores: fp32 inputs keep the reference's precision, which neither
    TF32 nor bf16 products would hold)."""
    if dtype != torch.bfloat16 or dh % 8:
        return "simt"
    return "wgmma" if all(p % 16 == 0 for p in data_ptrs) else "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, block_q: int = 128, block_kv: int = 128,
                    q_offset: int = -1) -> torch.Tensor:
    """q: ``[B, Sq, H, dh]``; k, v: ``[B, Skv, KV, dh]`` -> ``[B, Sq, H, dh]`` in
    q's dtype. Head h reads kv head ``h // (H // KV)``; query row i sits at
    position ``q_offset + i`` (-1 -> ``Skv - Sq``). ``Sq`` must be divisible
    by ``block_q`` and ``Skv`` by ``block_kv``, as the reference requires;
    the CUDA tiles are the kernels' own. CPU tensors take the plain version
    (``ref.attention``); CUDA tensors launch the kernel that ``variant``
    names (fp32 or bf16, contiguous, dh <= 256)."""
    CALLS["flash_attention"] += 1
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if Sq % block_q or Skv % block_kv:
        raise ValueError(f"flash_attention: Sq={Sq} must be divisible by block_q={block_q} "
                         f"and Skv={Skv} by block_kv={block_kv}")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != dh or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k, v [B, Skv, KV, dh] with H % KV == 0")
    off = Skv - Sq if q_offset == -1 else q_offset
    if _build.is_fake(q):
        return cost.fake_call("flash_attention",
                              cost.flash_attention(B, Sq, Skv, H, KV, dh, window, off,
                                                   q.element_size()), torch.empty_like(q))
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=off)
    fa = (torch.float32, torch.bfloat16)
    _build.check_inputs("flash_attention", {"q": fa, "k": fa, "v": fa}, q=q, k=k, v=v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; "
                        "the kernel takes one dtype")
    if dh > MAX_HEAD_DIM or B > _GRID_LIMIT or H > _GRID_LIMIT:
        raise ValueError(f"flash_attention: dh={dh} (max {MAX_HEAD_DIM}), B={B} and H={H} "
                         f"(max {_GRID_LIMIT}) outside the kernel's range")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    args = (*ptrs, B, Sq, Skv, H, KV, dh, int(causal), window, off)
    kind = variant(q.dtype, dh, ptrs)
    if kind == "wgmma":
        code = _lib(kind).flash_attention_wgmma_launch(*args, dh ** -0.5 * math.log2(math.e),
                                                       _build.stream_of(q))
    else:
        code = _lib(kind).flash_attention_launch(*args, dh ** -0.5,
                                                 int(q.dtype == torch.bfloat16),
                                                 _build.stream_of(q))
    _build.check_launch("flash_attention", code)
    LAUNCHES["flash_attention"] += 1
    VARIANT_LAUNCHES[kind] += 1
    return out
