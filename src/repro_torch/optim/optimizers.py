"""Hand-rolled optimizers (port of ``repro/optim/optimizers.py``).

Both return ``(new_params, new_state)`` and keep their state as plain
trees of tensors (``utils/tree.py``). SGD-M is the framework default for
Byzantine training (Algorithm 2's server-side update when worker momentum
is active, and the Remark-7 server momentum otherwise); AdamW is provided
for standard LLM pretraining runs.

The arithmetic and its casts are the reference's, operation for operation:
``(p.float() - lr * m.float()).to(p.dtype)`` and the same for AdamW. An
update CONSUMES the state it is given: the moments are written in place
(a full-width model cannot hold a second copy of them beside the worker
momenta) and returned in the new ``OptState``, as the reference returns
its new moments. The parameters are not written; new ones are returned.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_map


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any  # first moment / momentum
    v: Any  # second moment (None for sgdm)


def _step0(params) -> torch.Tensor:
    device = tree_flatten(params)[0][0].device
    return torch.zeros((), dtype=torch.int32, device=device)


# ------------------------------------------------------------------ SGD-M
def sgdm_init(params, m_dtype=torch.float32) -> OptState:
    """``m_dtype``: momentum storage dtype. bfloat16 halves optimizer-state
    memory; the update still accumulates in fp32."""
    return OptState(step=_step0(params),
                    m=tree_map(lambda p: torch.zeros_like(p, dtype=m_dtype), params), v=None)


def sgdm_update(grads, state: OptState, params, lr: float, beta: float = 0.9,
                weight_decay: float = 0.0) -> Tuple[Any, OptState]:
    """One SGD-M step; ``state.m`` is updated in place (module docstring)."""
    def mom(mi, g):
        if mi.dtype == torch.float32:
            return mi.mul_(beta).add_(g.float())
        return mi.copy_((beta * mi.float() + g.float()).to(mi.dtype))

    m = tree_map(mom, state.m, grads)

    def upd(p, mi):
        delta = lr * mi.float()
        if weight_decay:
            delta = delta + lr * weight_decay * p.float()
        return (p.float() - delta).to(p.dtype)

    return tree_map(upd, params, m), OptState(state.step + 1, m, None)


# ------------------------------------------------------------------ AdamW
def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(step=_step0(params), m=tree_map(zeros, params), v=tree_map(zeros, params))


def adamw_update(grads, state: OptState, params, lr: float, beta1: float = 0.9,
                 beta2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> Tuple[Any, OptState]:
    """One AdamW step with bias correction; ``state.m`` and ``state.v`` are
    updated in place (module docstring)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t
    m = tree_map(lambda mi, g: mi.mul_(beta1).add_((1 - beta1) * g.float()), state.m, grads)
    v = tree_map(lambda vi, g: vi.mul_(beta2).add_((1 - beta2) * torch.square(g.float())),
                 state.v, grads)

    def upd(p, mi, vi):
        delta = lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
        if weight_decay:
            delta = delta + lr * weight_decay * p.float()
        return (p.float() - delta).to(p.dtype)

    return tree_map(upd, params, m, v), OptState(step, m, v)


def make_optimizer(name: str, **hp) -> Tuple[Callable, Callable]:
    """Returns (init_fn(params), update_fn(grads, state, params) -> (params, state))."""
    name = name.lower()
    m_dtype = getattr(torch, hp.get("m_dtype", "float32"))
    if name in ("sgdm", "sgd"):
        beta = hp.get("beta1", 0.9) if name == "sgdm" else 0.0

        def init(params):
            return sgdm_init(params, m_dtype=m_dtype)

        def update(g, s, p, lr=hp.get("lr", 1e-3)):
            return sgdm_update(g, s, p, lr, beta, hp.get("weight_decay", 0.0))
        return init, update
    if name == "adamw":
        def update(g, s, p, lr=hp.get("lr", 1e-3)):
            return adamw_update(g, s, p, lr, hp.get("beta1", 0.9), hp.get("beta2", 0.95),
                                hp.get("eps", 1e-8), hp.get("weight_decay", 0.0))
        return adamw_init, update
    raise KeyError(f"unknown optimizer {name!r}")
