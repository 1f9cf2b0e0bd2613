"""Byzantine-robust training loop (Algorithm 2), simulation path (port of
``repro/training/byzantine.py``).

Simulates ``n`` workers on one device: per-worker gradients via ``vmap``,
worker momentum, message-level attacks, mixing + robust aggregation, server
update. Workers ``[0, f)`` are Byzantine (convention used by the attack
masks and the partitioner). This is the harness behind the paper's tables
and figures.

Aggregation goes through ``RobustAggregator`` on the stacked ``[W, d]``
momenta, as in the reference: this loop launches no kernel of
``repro_torch.kernels`` (the packed engine serves ``CrossDeviceSim`` and
the distributed sync).

Randomness: a step's draws (batch indices, mixing matrix) are a ``Draws``
that ``step`` takes as an argument; ``run`` draws them from its
``torch.Generator`` with ``draw``. A test can hand ``step`` the reference's
draws instead. No attack draws randomness.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, vmap

from repro_torch import ieee_fp32, resolve_device
from repro_torch.configs.base import ByzConfig
from repro_torch.core.attacks import get_attack
from repro_torch.data.pipeline import draw_batch_idx, sample_worker_batches
from repro_torch.telemetry.inflight import stack_series
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


class SimState(NamedTuple):
    params: Any
    momentum: torch.Tensor         # [W, d] worker momentum (flattened)
    attack_state: Any
    step: int


class Draws(NamedTuple):
    idx: torch.Tensor  # [n_workers, batch_size] sample ids per worker
    mix: torch.Tensor  # [m, n_workers] mixing matrix


def stack_flatten_workers(tree) -> torch.Tensor:
    """Stacked grad tree (leaves [W, ...]) -> [W, d], leaves in the
    reference's order."""
    leaves, _ = tree_flatten(tree)
    W = leaves[0].shape[0]
    return torch.cat([x.reshape(W, -1) for x in leaves], dim=1)


def unflatten_like(vec: torch.Tensor, tree) -> Any:
    leaves, treedef = tree_flatten(tree)
    out, off = [], 0
    for leaf in leaves:
        size = leaf.numel()
        out.append(vec[off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return tree_unflatten(treedef, out)


@dataclasses.dataclass(eq=False)
class ByzantineSim:
    """Paper-experiment harness.

    Args:
        loss_fn: (params, x, y) -> scalar loss for ONE worker batch.
        byz: ByzConfig (aggregator, mixing, attack, momentum, delta ...).
        n_workers: total workers n.
        n_byzantine: f (workers [0, f) are Byzantine).
        lr: server step size eta.
        batch_size: per-worker batch size.
        telemetry: surface the aggregator's stats (clip fractions,
            Weiszfeld residuals, Krum scores, trim masks — repro_torch/
            telemetry) in the step metrics and run history.
        device: where the step runs; None means "cuda" (raises without a GPU).
    """

    loss_fn: Callable
    byz: ByzConfig
    n_workers: int
    n_byzantine: int
    lr: float = 0.01
    batch_size: int = 32
    telemetry: bool = False
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.aggregator = self.byz.make_aggregator(self.n_workers)
        self.attack = get_attack(self.byz.attack, **dict(self.byz.attack_kwargs))
        self.byz_mask = torch.arange(self.n_workers, device=self.device) < self.n_byzantine
        # per-worker gradients: the counterpart of jax.vmap(jax.grad(loss))
        self.grad_fn = vmap(grad(self.loss_fn), in_dims=(None, 0, 0))

    # ------------------------------------------------------------- states
    def init_state(self, params) -> SimState:
        d = sum(p.numel() for p in tree_flatten(params)[0])
        return SimState(
            params=params,
            momentum=torch.zeros((self.n_workers, d), dtype=torch.float32, device=self.device),
            attack_state=self.attack.init_state(self.n_workers, d, device=self.device),
            step=0,
        )

    def draw(self, generator: torch.Generator, n_samples: int) -> Draws:
        """One step's random draws: batch indices and mixing matrix."""
        idx = draw_batch_idx(generator, self.n_workers, n_samples, self.batch_size)
        mix = self.aggregator.mixing_matrix(self.n_workers, generator, device=self.device)
        return Draws(idx, mix)

    # --------------------------------------------------------------- step
    def step(self, state: SimState, data_x: torch.Tensor, data_y: torch.Tensor,
             draws: Draws) -> Tuple[SimState, Dict]:
        bx, by = sample_worker_batches(draws.idx, data_x, data_y)

        # per-worker gradients (vmap over the worker axis)
        with ieee_fp32():  # forward and backward: cuDNN's convolutions default to TF32
            grads = self.grad_fn(state.params, bx, by)
        g_flat = stack_flatten_workers(grads).float()  # [W, d]

        # worker momentum (Algorithm 2); step 0 initializes m = g
        beta = self.byz.worker_momentum
        if state.step == 0:
            m = g_flat
        elif self.byz.momentum_convention == "ema":
            m = beta * state.momentum + (1.0 - beta) * g_flat
        else:  # pytorch
            m = beta * state.momentum + g_flat

        # message-level attack on the stacked momenta
        sent, attack_state = self.attack(m, self.byz_mask, state.attack_state)

        # mixing + robust aggregation
        if self.telemetry:
            agg, agg_stats = self.aggregator.aggregate_with_stats(sent, mix=draws.mix)
        else:
            agg = self.aggregator(sent, mix=draws.mix)

        # server update
        new_params = tree_map(lambda p, u: (p.float() - self.lr * u).to(p.dtype),
                              state.params, unflatten_like(agg, state.params))

        good = g_flat[self.n_byzantine:]
        metrics = {
            "grad_norm_mean": torch.mean(torch.linalg.norm(g_flat, dim=1)),
            "agg_norm": torch.linalg.norm(agg),
            "zeta_sq": torch.mean(torch.sum(
                torch.square(good - torch.mean(good, dim=0, keepdim=True)), dim=1)),
        }
        if self.telemetry:
            tmtree = dict(agg_stats)
            tmtree["byz_mask"] = self.byz_mask
            tmtree["grad_norm_mean"] = metrics["grad_norm_mean"]
            tmtree["agg_norm"] = metrics["agg_norm"]
            tmtree["zeta_sq"] = metrics["zeta_sq"]
            metrics["telemetry"] = tmtree
        return SimState(new_params, m, attack_state, state.step + 1), metrics

    # ---------------------------------------------------------------- run
    def run(self, params0, data_x, data_y, n_steps: int, generator: torch.Generator,
            eval_fn: Optional[Callable] = None, eval_every: int = 50
            ) -> Tuple[SimState, Dict[str, Any]]:
        """Run ``n_steps``, drawing each step from ``generator``. With
        ``telemetry=True`` the history additionally carries
        ``history["telemetry"]``: each metric stacked across steps into one
        numpy array (leading step axis). The metrics stay on the device
        during the loop and are copied to the host once, at the end."""
        state = self.init_state(params0)
        history: Dict[str, Any] = {"step": [], "eval": [], "zeta_sq": []}
        per_step: Dict[str, list] = {}
        for t in range(n_steps):
            state, metrics = self.step(state, data_x, data_y,
                                       self.draw(generator, data_x.shape[1]))
            if self.telemetry:
                for name, v in metrics["telemetry"].items():
                    per_step.setdefault(name, []).append(v)
            if eval_fn is not None and ((t + 1) % eval_every == 0 or t == n_steps - 1):
                history["step"].append(t + 1)
                history["eval"].append(float(eval_fn(state.params)))
                history["zeta_sq"].append(float(metrics["zeta_sq"]))
        if self.telemetry:
            history["telemetry"] = stack_series(per_step)
        return state, history


def label_flip_targets(y: torch.Tensor, n_classes: int = 10) -> torch.Tensor:
    """The paper's label-flipping transform T(y) = 9 - y (data-level attack:
    apply to the Byzantine workers' dataset rows before training)."""
    return (n_classes - 1) - y
