"""Batcher odd-even-merge selection networks (the order-statistic engine).

The port's own copy of ``repro/kernels/selection_network.py``: the program
builder is pure Python and returns the IDENTICAL comparator tuples, and
``apply_program`` runs them with ``torch.minimum``/``torch.maximum``.

The coordinate-wise median and trimmed mean need a few order statistics of
W worker values per coordinate. Batcher's odd-even merge sort for the
next power of two P is shrunk twice:

1. **Sentinel elimination.** Slots W..P-1 would hold +inf and every
   comparator routes the min to its lower slot, so a comparator that
   touches a slot >= W is a no-op and is dropped.
2. **Rank pruning.** Walking the program backwards, a comparator is kept
   only if one of its slots is a requested rank or feeds a kept comparator.

Median programs have 8 / 29 / 39 / 113 / 445 comparators at W = 5 / 10 /
13 / 25 / 64. The same program is emitted as unrolled ``min``/``max`` code
for the CUDA kernels (``kernels/cwise_median.py``, ``kernels/trimmed_mean.py``),
which is what makes kernel and plain version bitwise equal.

``torch.minimum``/``torch.maximum`` propagate NaN from either input, like
``jnp.minimum``; the kernels do the same.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

Pair = Tuple[int, int]


def _oems_pairs(n: int) -> List[Pair]:
    """Comparator list of Batcher's odd-even merge sort for power-of-two n,
    in schedule order; every pair (i, j) has i < j (min routed to i)."""
    pairs: List[Pair] = []

    def merge(lo: int, hi: int, r: int) -> None:
        step = r * 2
        if step < hi - lo:
            merge(lo, hi, step)
            merge(lo + r, hi, step)
            for i in range(lo + r, hi - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo: int, hi: int) -> None:  # inclusive bounds
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            sort(lo, mid)
            sort(mid + 1, hi)
            merge(lo, hi, 1)

    if n > 1:
        sort(0, n - 1)
    return pairs


@functools.lru_cache(maxsize=None)
def selection_program(n_rows: int, ranks: Tuple[int, ...]) -> Tuple[Pair, ...]:
    """Static compare-exchange program that places the requested order
    statistics (``ranks``, ascending 0-based positions of the sorted order)
    of ``n_rows`` values into their slots. Slots outside ``ranks`` hold
    unspecified values after the program runs."""
    if not ranks:
        return ()
    if min(ranks) < 0 or max(ranks) >= n_rows:
        raise ValueError(f"ranks {ranks} out of range for n_rows={n_rows}")
    pow2 = 1 << max(0, (n_rows - 1).bit_length())
    pairs = [(i, j) for (i, j) in _oems_pairs(pow2) if j < n_rows]
    needed = set(ranks)
    kept: List[Pair] = []
    for i, j in reversed(pairs):
        if i in needed or j in needed:
            kept.append((i, j))
            needed.add(i)
            needed.add(j)
    return tuple(reversed(kept))


def emit_cuda(template: str, n_rows: int, ranks: Tuple[int, ...], result: str) -> str:
    """Fill the ``csrc/selection.cu`` template: ``n_rows`` registers
    ``v[0..n_rows)``, the program for ``ranks`` as one ``CX(i, j)`` per
    comparator (written once; the kernel runs it with and without NaN
    handling), and ``result``, the statements that set ``res``."""
    program = "\n    ".join(f"CX({i}, {j})"
                           for i, j in selection_program(n_rows, tuple(ranks)))
    return (template.replace("@W@", str(n_rows))
            .replace("// @PROGRAM@", program)
            .replace("// @RESULT@", result))


def apply_program(rows: Sequence[torch.Tensor], program: Sequence[Pair]):
    """Run a compare-exchange program over a list of same-shape tensors."""
    rows = list(rows)
    for i, j in program:
        lo = torch.minimum(rows[i], rows[j])
        hi = torch.maximum(rows[i], rows[j])
        rows[i], rows[j] = lo, hi
    return rows


def median_ranks(n_rows: int) -> Tuple[int, ...]:
    mid = n_rows // 2
    return (mid,) if n_rows % 2 else (mid - 1, mid)


def trim_ranks(n_rows: int, n_trim: int) -> Tuple[int, ...]:
    """The ``[b, n_rows - b)`` band kept by the trimmed mean."""
    return tuple(range(n_trim, n_rows - n_trim))


def select_rows(x: torch.Tensor, ranks: Sequence[int]) -> List[torch.Tensor]:
    """Order statistics ``ranks`` of ``x`` along axis 0, in rank order."""
    ranks = tuple(ranks)
    rows = apply_program(
        [x[i] for i in range(x.shape[0])], selection_program(x.shape[0], ranks)
    )
    return [rows[r] for r in ranks]


def median_select(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of ``x`` over axis 0; for even W the midpoint
    ``0.5 * (a + b)`` of the two middle order statistics."""
    sel = select_rows(x, median_ranks(x.shape[0]))
    return sel[0] if len(sel) == 1 else 0.5 * (sel[0] + sel[1])


def band_scale(n_band: int) -> float:
    """The fp32 reciprocal of the band length, as a Python float.

    The reference writes ``acc / float(len(band))``; XLA compiles a division
    by a constant into a multiply by the constant's fp32 reciprocal, so that
    multiply is what the reference computes, and what the port does (a true
    division differs in the last bit for lengths that are not powers of 2)."""
    return float(np.float32(1.0 / n_band))


def trimmed_mean_select(x: torch.Tensor, n_trim: int) -> torch.Tensor:
    """Coordinate-wise mean of the sorted ``[n_trim, W - n_trim)`` band over
    axis 0. The band is summed in rank order, then scaled by
    ``band_scale``, as the kernels do; ``n_trim == 0`` sums all rows in row
    order."""
    n = x.shape[0]
    band = [x[i] for i in range(n)] if n_trim == 0 else select_rows(
        x, trim_ranks(n, n_trim))
    acc = band[0]
    for row in band[1:]:
        acc = acc + row
    return acc * band_scale(len(band))
