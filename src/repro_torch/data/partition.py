"""Dataset partitioning across workers (paper App. A.1.2).

The port's own copy of ``repro/data/partition.py``: numpy only, the same
seeded index draws, so both packages split a dataset identically. Callers
on the card move the result to the device.

- ``long_tail_subsample``: class ``i`` keeps a ``gamma^i`` fraction of its
  samples, ``alpha = 1/gamma^(n_classes-1)`` = largest/smallest class ratio
  (paper's alpha = 500 setting).
- ``partition_iid``: shuffle, split evenly.
- ``partition_by_label`` (non-iid): sort by label, split sequentially into
  equal chunks — each good worker sees only 1-2 classes. The last chunk is
  padded from itself (paper A.1.2 step 2).
- Byzantine workers get access to the full dataset (paper A.1.2).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def long_tail_subsample(x, y, alpha: float, n_classes: int = 10, seed: int = 0):
    """Keep a gamma^i fraction of class i with gamma = alpha^(-1/(C-1))."""
    if alpha <= 1:
        return x, y
    x, y = np.asarray(x), np.asarray(y)
    gamma = alpha ** (-1.0 / (n_classes - 1))
    rng = np.random.RandomState(seed)
    keep_idx = []
    for c in range(n_classes):
        idx = np.where(y == c)[0]
        n_keep = max(1, int(round(len(idx) * gamma**c)))
        keep_idx.append(rng.choice(idx, n_keep, replace=False))
    keep = np.concatenate(keep_idx)
    rng.shuffle(keep)
    return x[keep], y[keep]


def _pad_chunks(chunks, size, rng):
    out = []
    for c in chunks:
        if len(c) < size:
            extra = rng.choice(c, size - len(c), replace=True)
            c = np.concatenate([c, extra])
        out.append(c[:size])
    return np.stack(out)


def partition_iid(n_samples: int, n_workers: int, seed: int = 0) -> np.ndarray:
    """Returns index matrix [n_workers, m]."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_samples)
    m = int(np.ceil(n_samples / n_workers))
    chunks = [perm[i * m : (i + 1) * m] for i in range(n_workers)]
    return _pad_chunks(chunks, m, rng)


def partition_by_label(y, n_workers: int, seed: int = 0) -> np.ndarray:
    """Sort-by-label sequential split (the paper's non-iid partition)."""
    y = np.asarray(y)
    rng = np.random.RandomState(seed)
    order = np.argsort(y, kind="stable")
    m = int(np.ceil(len(y) / n_workers))
    chunks = [order[i * m : (i + 1) * m] for i in range(n_workers)]
    idx = _pad_chunks(chunks, m, rng)
    # paper step 3: shuffle within each worker
    for row in idx:
        rng.shuffle(row)
    return idx


def worker_datasets(
    x, y, n_good: int, n_byz: int, noniid: bool, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Build per-worker datasets [n_workers, m, ...].

    The training set is divided among the *good* workers only; Byzantine
    workers are given random samples of the whole dataset (they have full
    information per the paper's threat model).
    """
    x, y = np.asarray(x), np.asarray(y)
    if noniid:
        idx = partition_by_label(y, n_good, seed)
    else:
        idx = partition_iid(len(y), n_good, seed)
    m = idx.shape[1]
    rng = np.random.RandomState(seed + 1)
    byz_idx = rng.randint(0, len(y), size=(n_byz, m))
    all_idx = np.concatenate([byz_idx, idx], axis=0)  # byzantine first
    return x[all_idx], y[all_idx]
