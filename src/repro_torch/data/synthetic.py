"""Synthetic datasets (port of ``repro/data/synthetic.py``).

``make_classification`` builds a seeded 10-class Gaussian-mixture image
dataset ("SynthMNIST", 784-d) whose class structure the paper's MLP can
learn. ``make_token_stream`` builds per-worker token sequences for LLM
training: tokens follow a noisy affine bigram law ``next = (a*tok + b) mod
V`` with per-worker (a, b) "dialects", so heterogeneous workers send
genuinely non-iid gradients.

Draws come from a CPU ``torch.Generator`` and are moved to ``device``;
they differ from the reference's ``jax.random`` draws, but the task has
the same distribution. The token stream also takes its draws from the
caller (``TokenDraws``), so a test can feed it the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device


def make_classification(
    generator: Optional[torch.Generator] = None,
    n_samples: int = 10000,
    n_classes: int = 10,
    dim: int = 784,
    class_sep: float = 2.0,
    noise: float = 0.3,
    means: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x [N, dim], y [N]) — equal samples per class, shuffled.

    ``means`` ([n_classes, dim], unit-normalised and scaled to
    ``class_sep`` here) fixes the class means, so that separately drawn
    train and test sets share one task; without it they are drawn."""
    dev = resolve_device(device)
    if means is None:
        means = torch.randn((n_classes, dim), generator=generator)
    means = means.cpu()
    means = means / torch.linalg.norm(means, dim=1, keepdim=True) * class_sep
    per = n_samples // n_classes
    y = torch.arange(n_classes).repeat_interleave(per)
    x = means[y] + torch.randn((per * n_classes, dim), generator=generator) * noise
    perm = torch.randperm(x.shape[0], generator=generator)
    return x[perm].to(dev), y[perm].to(dev)


def make_train_test(
    generator: Optional[torch.Generator] = None, n_train: int = 10000,
    n_test: int = 2000, device=None, **kw
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train/test split sharing class means (the 'SynthMNIST' task)."""
    n_classes, dim = kw.get("n_classes", 10), kw.get("dim", 784)
    means = torch.randn((n_classes, dim), generator=generator)
    xtr, ytr = make_classification(generator, n_train, means=means, device=device, **kw)
    xte, yte = make_classification(generator, n_test, means=means, device=device, **kw)
    return xtr, ytr, xte, yte


class TokenDraws(NamedTuple):
    """The random draws behind ``make_token_stream``: the laws' odd
    multipliers ``a`` and offsets ``b`` (``[n_laws]``, one law per worker,
    or one shared law), the first tokens ``tok0`` ``[W, n_seqs]``, and per
    step the noise ``flips`` (bool) and its uniform tokens ``unif``
    (``[W, n_seqs, seq_len]``)."""

    a: torch.Tensor
    b: torch.Tensor
    tok0: torch.Tensor
    flips: torch.Tensor
    unif: torch.Tensor


def draw_token_stream(generator: Optional[torch.Generator], n_workers: int, seq_len: int,
                      n_seqs_per_worker: int, vocab: int, heterogeneous: bool = True,
                      noise_p: float = 0.1) -> TokenDraws:
    """``make_token_stream``'s draws from ``generator``, on the CPU."""
    n_laws = n_workers if heterogeneous else 1
    shape = (n_workers, n_seqs_per_worker)
    return TokenDraws(
        a=torch.randint(1, 97, (n_laws,), generator=generator) * 2 + 1,  # odd multipliers
        b=torch.randint(0, vocab, (n_laws,), generator=generator),
        tok0=torch.randint(0, vocab, shape, generator=generator),
        flips=torch.rand(shape + (seq_len,), generator=generator) < noise_p,
        unif=torch.randint(0, vocab, shape + (seq_len,), generator=generator))


def make_token_stream(
    generator: Optional[torch.Generator] = None,
    n_workers: int = 1,
    seq_len: int = 128,
    n_seqs_per_worker: int = 1,
    vocab: int = 512,
    heterogeneous: bool = True,
    noise_p: float = 0.1,
    draws: Optional[TokenDraws] = None,
    device=None,
) -> torch.Tensor:
    """Returns tokens [n_workers, n_seqs, seq_len+1] int64 (inputs + the
    next-token labels).

    Each worker's stream follows ``next = (a_w * tok + b_w) mod V`` with
    probability 1-noise_p (uniform otherwise). Homogeneous mode shares one
    (a, b) across workers. ``draws`` replaces the draws from ``generator``
    (``draw_token_stream``)."""
    dev = resolve_device(device)
    if draws is None:
        draws = draw_token_stream(generator, n_workers, seq_len, n_seqs_per_worker, vocab,
                                  heterogeneous, noise_p)
    a, b, tok, flips, unif = (torch.as_tensor(x).cpu().long() for x in draws)
    a = a.expand(n_workers)[:, None]
    b = b.expand(n_workers)[:, None]
    toks = []
    for t in range(seq_len):
        toks.append(tok)
        tok = torch.where(flips[..., t].bool(), unif[..., t], torch.remainder(a * tok + b, vocab))
    toks.append(torch.remainder(a * toks[-1] + b, vocab))  # one more step for labels
    return torch.stack(toks, dim=-1).to(dev)
