"""Carry parameters across from the JAX reference.

``params_from_jax`` takes the reference's parameters as numpy arrays
(``np.asarray`` of each JAX leaf) in the reference's nesting: the MLP's flat
``{name: array}``, or the LLM's nested dicts with the period axis leading
every block leaf. It returns the same tree of tensors, same names, shapes
and dtypes, so that both packages compute the same function from the same
starting point.

A JAX bf16 array comes out of ``np.asarray`` with ``ml_dtypes``' bfloat16
dtype, which torch does not take; its bits are reinterpreted (uint16 ->
``torch.bfloat16``), so the tensor is bit for bit the array.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.utils.tree import tree_map


def _tensor(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def params_from_jax(params_np: Any, device=None) -> Any:
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), params_np)
