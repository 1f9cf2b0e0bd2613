"""Causal GQA flash attention: CUDA kernel ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` and keeps its
entry point: the same signature (without ``interpret``), the same mask
semantics, the same refusal of lengths that the caller's blocks do not
divide. As in the reference, no model path calls it; ``chip_smoke.py``
holds it on the card at the attention shapes of the ported LLM configs and
on the serving model's own q/k/v.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build, ref

_ARGS = {"flash_attention_launch": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B Sq Skv H KV
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dh causal window q_offset
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)}  # scale, bf16, stream

#: largest head dim the kernel's templates cover
MAX_HEAD_DIM = 256
_GRID_LIMIT = 65535  # gridDim.y (heads) and gridDim.z (batch)


def sources():
    return [("flash_attention", _build.read_source("flash_attention.cu"))]


@functools.lru_cache(maxsize=None)
def _lib():
    (name, text), = sources()
    return _build.load(name, text, _ARGS)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, block_q: int = 128, block_kv: int = 128,
                    q_offset: int = -1) -> torch.Tensor:
    """q: ``[B, Sq, H, dh]``; k, v: ``[B, Skv, KV, dh]`` -> ``[B, Sq, H, dh]`` in
    q's dtype. Head h reads kv head ``h // (H // KV)``; query row i sits at
    position ``q_offset + i`` (-1 -> ``Skv - Sq``). ``Sq`` must be divisible
    by ``block_q`` and ``Skv`` by ``block_kv``, as the reference requires;
    the CUDA tiles are the kernel's own. CPU tensors take the plain version
    (``ref.attention``); CUDA tensors launch the kernel (fp32 or bf16,
    contiguous, dh <= 256)."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if Sq % block_q or Skv % block_kv:
        raise ValueError(f"flash_attention: Sq={Sq} must be divisible by block_q={block_q} "
                         f"and Skv={Skv} by block_kv={block_kv}")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != dh or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k, v [B, Skv, KV, dh] with H % KV == 0")
    off = Skv - Sq if q_offset == -1 else q_offset
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=off)
    _build.check_inputs("flash_attention", dtypes=(torch.float32, torch.bfloat16), q=q, k=k,
                        v=v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; "
                        "the kernel takes one dtype")
    if dh > MAX_HEAD_DIM or B > _GRID_LIMIT or H > _GRID_LIMIT:
        raise ValueError(f"flash_attention: dh={dh} (max {MAX_HEAD_DIM}), B={B} and H={H} "
                         f"(max {_GRID_LIMIT}) outside the kernel's range")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    code = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KV, dh,
        int(causal), window, off, dh ** -0.5, int(q.dtype == torch.bfloat16),
        _build.stream_of(q))
    _build.check_launch("flash_attention", code)
    LAUNCHES["flash_attention"] += 1
    return out
