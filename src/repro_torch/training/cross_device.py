"""Cross-device federated learning mode (paper Remark 7).

Port of ``repro/training/cross_device.py``. Clients are sampled online and
never seen twice, so they carry no momentum: they send raw gradients, the
server robust-aggregates them with an agnostic ARAGG (the packed engine,
``distributed/packing.py``) and applies *server* momentum to the aggregate.

``CrossDeviceSim`` simulates a pool of ``n_clients`` with a ``byz_frac``
fraction Byzantine; each round samples ``clients_per_round`` clients with
replacement, runs the message-level attack over the cohort, mixes and
robust-aggregates, then applies server momentum and the SGD step.

Randomness: a round's draws (cohort, batch indices, mixing matrix) are a
``Draws`` that ``step`` takes as an argument; ``run`` draws them from its
``torch.Generator`` with ``draw``. A test can hand ``step`` the reference's
draws instead.

``telemetry=True`` adds the packed engine's metrics (``packing.py``) to the
step metrics and, stacked over the rounds, to the run history.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, vmap

from repro_torch import ieee_fp32, resolve_device
from repro_torch.configs.base import ByzConfig
from repro_torch.core.attacks import get_attack
from repro_torch.distributed.packing import packed_aggregate
from repro_torch.telemetry.inflight import stack_series
from repro_torch.training.byzantine import stack_flatten_workers, unflatten_like


class CrossDeviceState(NamedTuple):
    params: Any
    server_m: torch.Tensor  # [d] server momentum (Remark 7)
    step: int


class Draws(NamedTuple):
    cohort: torch.Tensor  # [clients_per_round] client ids
    idx: torch.Tensor     # [clients_per_round, batch_size] sample ids per client
    mix: torch.Tensor     # [m, clients_per_round] mixing matrix


@dataclasses.dataclass(eq=False)
class CrossDeviceSim:
    loss_fn: Callable           # (params, x, y) -> scalar, one client batch
    byz: ByzConfig
    n_clients: int              # pool size
    byz_frac: float             # fraction of the POOL that is Byzantine
    clients_per_round: int
    lr: float = 0.1
    batch_size: int = 32
    server_momentum: float = 0.9
    telemetry: bool = False     # the packed engine's metrics in metrics / history
    device: Any = None          # None means "cuda"; raises without a GPU

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.aggregator = self.byz.make_aggregator(self.clients_per_round)
        self.attack = get_attack(self.byz.attack, **dict(self.byz.attack_kwargs))
        self.n_byz_pool = int(self.byz_frac * self.n_clients)
        # per-client gradients: the counterpart of jax.vmap(jax.grad(loss))
        self.grad_fn = vmap(grad(self.loss_fn), in_dims=(None, 0, 0))

    def init_state(self, params) -> CrossDeviceState:
        d = sum(p.numel() for p in params.values())
        return CrossDeviceState(
            params=params,
            server_m=torch.zeros((d,), dtype=torch.float32, device=self.device),
            step=0,
        )

    def draw(self, generator: torch.Generator, n_samples: int) -> Draws:
        """One round's random draws: cohort, batch indices, mixing matrix."""
        C = self.clients_per_round
        cohort = torch.randint(0, self.n_clients, (C,), generator=generator)
        idx = torch.randint(0, n_samples, (C, self.batch_size), generator=generator)
        mix = self.aggregator.mixing_matrix(C, generator, device=self.device)
        return Draws(cohort, idx, mix)

    def step(self, state: CrossDeviceState, data_x: torch.Tensor,
             data_y: torch.Tensor, draws: Draws) -> Tuple[CrossDeviceState, Dict]:
        dev = self.device
        cohort = draws.cohort.to(dev)
        idx = draws.idx.to(dev)
        byz_mask = cohort < self.n_byz_pool

        bx = data_x[cohort[:, None], idx]
        by = data_y[cohort[:, None], idx]
        with ieee_fp32():  # forward and backward: cuDNN's convolutions default to TF32
            grads = self.grad_fn(state.params, bx, by)
        g_flat = stack_flatten_workers(grads).float()

        # attacks are stateless here (no persistent cohort across rounds)
        sent, _ = self.attack(g_flat, byz_mask, None)
        if self.telemetry:
            agg, info = packed_aggregate(sent, self.aggregator, mix=draws.mix,
                                         telemetry=True, with_info=True)
        else:
            agg = packed_aggregate(sent, self.aggregator, mix=draws.mix)

        # Remark 7: SERVER momentum on the robust aggregate
        beta = self.server_momentum
        server_m = agg if state.step == 0 else beta * state.server_m + (1.0 - beta) * agg

        update = unflatten_like(server_m, state.params)
        new_params = {k: (p.float() - self.lr * update[k]).to(p.dtype)
                      for k, p in state.params.items()}
        metrics = {
            "byz_in_cohort": torch.sum(byz_mask),
            "agg_norm": torch.linalg.norm(agg),
        }
        if self.telemetry:
            tmtree = dict(info.get("telemetry", {}))
            tmtree["byz_mask"] = byz_mask
            tmtree["byz_in_cohort"] = metrics["byz_in_cohort"]
            tmtree["agg_norm"] = metrics["agg_norm"]
            metrics["telemetry"] = tmtree
        return CrossDeviceState(new_params, server_m, state.step + 1), metrics

    def run(self, params0, data_x, data_y, n_rounds: int,
            generator: torch.Generator,
            eval_fn: Optional[Callable] = None, eval_every: int = 50):
        """Run ``n_rounds``, drawing each round from ``generator``. Returns
        ``(state, history)`` with the eval rounds and values; with
        ``telemetry=True`` also ``history["telemetry"]``, each metric
        stacked across rounds into one numpy array (leading round axis),
        copied from the device once, at the end."""
        state = self.init_state(params0)
        history: Dict[str, Any] = {"round": [], "eval": []}
        per_round: Dict[str, list] = {}
        for t in range(n_rounds):
            state, metrics = self.step(state, data_x, data_y,
                                       self.draw(generator, data_x.shape[1]))
            if self.telemetry:
                for name, v in metrics["telemetry"].items():
                    per_round.setdefault(name, []).append(v)
            if eval_fn is not None and ((t + 1) % eval_every == 0
                                        or t == n_rounds - 1):
                history["round"].append(t + 1)
                history["eval"].append(float(eval_fn(state.params)))
        if self.telemetry:
            history["telemetry"] = stack_series(per_round)
        return state, history
