"""Carry parameters and training state across from the JAX reference.

``params_from_jax`` takes the reference's parameters as numpy arrays
(``np.asarray`` of each JAX leaf) in the reference's nesting: the MLP's flat
``{name: array}``, or the LLM's nested dicts with the period axis leading
every block leaf. It returns the same tree of tensors, same names, shapes
and dtypes, so that both packages compute the same function from the same
starting point. ``opt_state_from_jax`` carries an optimizer state (the
reference's ``OptState(step, m, v)`` of numpy trees) into the port's
``OptState``, and ``worker_m_from_jax`` the stacked worker momenta
(leaves ``[W, ...]``; ``{}`` when worker momentum is off), so a train step
can start from any reference state.

A JAX bf16 array comes out of ``np.asarray`` with ``ml_dtypes``' bfloat16
dtype, which torch does not take; its bits are reinterpreted (uint16 ->
``torch.bfloat16``), so the tensor is bit for bit the array.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim import OptState
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


def opt_state_from_jax(opt_state_np: Any, device=None) -> OptState:
    step, m, v = opt_state_np
    dev = resolve_device(device)
    return OptState(step=torch.tensor(np.asarray(step), dtype=torch.int32, device=dev),
                    m=params_from_jax(m, dev),
                    v=None if v is None else params_from_jax(v, dev))


def worker_m_from_jax(worker_m_np: Any, device=None) -> Any:
    return params_from_jax(worker_m_np, device)
