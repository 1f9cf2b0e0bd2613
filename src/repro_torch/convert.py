"""Carry parameters across from the JAX reference.

``params_from_jax`` takes the reference's MLP parameters as numpy arrays
(``{name: np.asarray(jax_array)}``) and returns the port's dict of
tensors, same names, shapes and dtypes, so that both packages compute the
same function from the same starting point.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_jax(params_np: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {name: torch.tensor(np.asarray(v), device=dev) for name, v in params_np.items()}
