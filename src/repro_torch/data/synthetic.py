"""Synthetic datasets (port of the classification part of ``repro/data/synthetic.py``).

``make_classification`` builds a seeded 10-class Gaussian-mixture image
dataset ("SynthMNIST", 784-d) whose class structure the paper's MLP can
learn. Draws come from a CPU ``torch.Generator`` and are moved to
``device``; they differ from the reference's ``jax.random`` draws, but the
task has the same distribution. The token stream waits for the LLM slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
