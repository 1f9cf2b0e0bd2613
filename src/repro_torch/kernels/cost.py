"""Bytes and operations of one call of each kernel, and the least time an
NVIDIA H100 SXM5 could take for it.

These are the counts behind ``bound_ms`` in ``chip_smoke.py`` and PERF.md:
each input read once and each output written once, over the HBM3 rate,
against the operations over the card's peak rate for their type; the bound
is the larger of the two. X's bytes follow its element type (4 for fp32, 2
for bf16 or fp16); every other operand and every output of the aggregation
kernels is fp32.

A wrapper handed a ``FakeTensor`` launches nothing and calls ``fake_call``:
the call's cost is added to ``COSTS`` and an empty output comes back. The
dry-run (``launch/dryrun.py``) adds ``COSTS`` to what it counts for the
ATen ops of a step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

#: NVIDIA H100 SXM5 (data sheet): HBM3 bytes/s, fp32 (non-tensor) op/s and
#: dense bf16 tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
#: Instruction rates behind the fp32 peak (132 SMs x 128 FMA a clock x 2
#: flops x 1.98 GHz): the CUDA C++ Programming Guide's throughput table for
#: compute capability 9.0 gives 128 results a clock an SM for fp32 add /
#: multiply / FMA and 64 for compare / minimum / maximum, so a min or a max
#: costs two fp32 flops' time and an add one.
PEAK_FADD_PER_S = PEAK_FP32_PER_S / 2
PEAK_MINMAX_PER_S = PEAK_FP32_PER_S / 4


class Cost(NamedTuple):
    """One call: bytes moved, operations, and the peak rate of those
    operations (op/s)."""

    bytes: float
    ops: float
    peak: float = PEAK_FP32_PER_S

    def bound(self) -> Tuple[float, str]:
        """``(ms, "bytes" or "operations")``: the larger of the two times."""
        t_bytes = self.bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = self.ops / self.peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bucket_mix(m: int, W: int, d: int, x_bytes: int = 4) -> Cost:
    """``M [m, W] @ X [W, d]``: X and M read, ``[m, d]`` written."""
    return Cost(W * d * x_bytes + (m * W + m * d) * 4, 2 * m * W * d)


def pairwise_gram(W: int, d: int, x_bytes: int = 4, acc: bool = False) -> Cost:
    """``acc + X X^T``: X read (and acc), ``[W, W]`` written; the upper
    triangle's multiply-adds, ``W (W + 1) d`` flops."""
    return Cost(W * d * x_bytes + W * W * 4 * (2 if acc else 1), W * (W + 1) * d)


def live_minmax(W: int, ranks: Sequence[int]) -> int:
    """Mins and maxes of ``selection_program(W, ranks)`` whose result a later
    comparator or the result reads: a comparator whose lower (upper) slot
    is dead afterwards needs no min (max); ptxas drops those."""
    from repro_torch.kernels.selection_network import selection_program

    live, n = set(ranks), 0
    for i, j in reversed(selection_program(W, tuple(ranks))):
        need = (i in live) + (j in live)
        n += need
        if need:
            live |= {i, j}
    return n


def selection_ops(W: int, d: int, n_trim: Optional[int] = None) -> float:
    """Operations of a CM (``n_trim`` None) or TM call, as min / max
    instructions at ``PEAK_MINMAX_PER_S``: per column, each min or max of
    the program whose result is read again (``live_minmax``), and the adds
    and the multiply that form the result (TM's band, the even median's
    midpoint) at ``PEAK_FADD_PER_S``. Min / max and add run on separate
    pipes, so the larger of the two counts."""
    from repro_torch.kernels.selection_network import median_ranks, trim_ranks

    if n_trim is None:
        ranks = median_ranks(W)
        n_minmax, n_add = live_minmax(W, ranks), 2 * (len(ranks) - 1)
    else:
        n_minmax = live_minmax(W, trim_ranks(W, n_trim)) if n_trim else 0
        n_add = W - 2 * n_trim
    return max(n_minmax, n_add * PEAK_MINMAX_PER_S / PEAK_FADD_PER_S) * d


def selection(W: int, d: int, n_trim: Optional[int] = None, x_bytes: int = 4) -> Cost:
    """CM (``n_trim`` None) or TM: X read, ``[d]`` written."""
    return Cost((W * x_bytes + 4) * d, selection_ops(W, d, n_trim), PEAK_MINMAX_PER_S)


def residual_norms(W: int, d: int, x_bytes: int = 4, center: bool = False) -> Cost:
    """The coefficient form (``c [W]`` read, 5 W d flops) or the given
    centre (``v [d]`` read, 3 W d); ``[W]`` written."""
    if center:
        return Cost(W * d * x_bytes + (d + W) * 4, 3 * W * d)
    return Cost(W * d * x_bytes + 2 * W * 4, 5 * W * d)


def cclip_fused_iter(W: int, d: int, x_bytes: int = 4) -> Cost:
    """X, v and lam read; v' and the ``[W]`` norms written; 6 W d flops."""
    return Cost(W * d * x_bytes + (2 * d + 2 * W) * 4, 6 * W * d)


def cclip_combine(W: int, d: int, x_bytes: int = 4) -> Cost:
    """X, v and lam read; v' written; 3 W d flops."""
    return Cost(W * d * x_bytes + (2 * d + W) * 4, 3 * W * d)


def visible_pairs(Sq: int, Skv: int, window: int, q_offset: int) -> int:
    """Query-key pairs the causal (and windowed) mask lets through."""
    import numpy as np

    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, qpos + 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros_like(qpos)
    return int(np.maximum(0, hi - lo).sum())


def flash_attention(B: int, Sq: int, Skv: int, H: int, KV: int, dh: int, window: int,
                    q_offset: int, elem_bytes: int) -> Cost:
    """q, k, v read and the output written once; ``QK^T`` and ``PV`` over the
    visible pairs, 4 dh flops a pair and head, at the bf16 tensor-core peak
    for 2-byte inputs, else fp32's."""
    return Cost((2 * B * Sq * H * dh + 2 * B * Skv * KV * dh) * elem_bytes,
                4 * B * H * dh * visible_pairs(Sq, Skv, window, q_offset),
                PEAK_BF16_PER_S if elem_bytes == 2 else PEAK_FP32_PER_S)


#: per kernel: calls made on fake tensors, and their bytes and operations
COSTS: Dict[str, Dict[str, float]] = {}


def reset() -> None:
    COSTS.clear()


def fake_call(kernel: str, cost: Cost, out):
    """Record a call on fake tensors and return ``out``, its empty output(s)."""
    rec = COSTS.setdefault(kernel, {"calls": 0, "bytes": 0.0, "ops": 0.0})
    rec["calls"] += 1
    rec["bytes"] += cost.bytes
    rec["ops"] += cost.ops
    return out


def totals() -> Tuple[float, float]:
    """``(bytes, ops)`` summed over every kernel in ``COSTS``."""
    return (sum(r["bytes"] for r in COSTS.values()), sum(r["ops"] for r in COSTS.values()))


def empty_f32(like: torch.Tensor, *shape: int) -> torch.Tensor:
    """An empty fp32 tensor of ``shape`` beside ``like`` (fake if it is)."""
    return like.new_empty(shape, dtype=torch.float32)
