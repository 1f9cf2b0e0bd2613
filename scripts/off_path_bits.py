#!/usr/bin/env python3
"""Outputs of the port's aggregation paths with telemetry off, for a
bitwise A/B of two trees on the CPU.

    python scripts/off_path_bits.py --root <tree> --out <tree>.npz
    python scripts/off_path_bits.py --against a.npz b.npz

The first form imports ``repro_torch`` from ``<tree>/src`` and saves, from
seeded inputs: ``packed_aggregate`` (and its ``info``), both engines of
``robust_gradient_sync`` on a two-leaf tree, and ``RobustAggregator`` on
the stack, for every rule under no mixing, bucketing and resampling; and
five ``CrossDeviceSim`` rounds' parameters for five rules. The second
compares two such files array by array, bit for bit, and exits 1 if any
array differs. Run both trees in the same process settings (threads).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

RULES = [("rfa", {}), ("cm", {}), ("tm", {"n_trim": 2}), ("cclip", {"tau": 3.0}),
         ("krum", {"n_byzantine": 2}), ("acclip", {}), ("mean", {})]


def outputs() -> dict:
    import torch

    from repro_torch.configs.base import ByzConfig
    from repro_torch.core.aragg import RobustAggregator
    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test
    from repro_torch.distributed.packing import packed_aggregate
    from repro_torch.distributed.robust_sync import robust_gradient_sync
    from repro_torch.models.mlp import init_mlp, nll_loss
    from repro_torch.training.cross_device import CrossDeviceSim

    torch.set_num_threads(4)
    out = {}
    xs = torch.tensor(np.random.default_rng(0).standard_normal((12, 5000)).astype(np.float32))
    tree = {"a": xs[:, :3000].reshape(12, 30, 100).contiguous(), "b": xs[:, 3000:].contiguous()}
    for agg, kw in RULES:
        for mixing in ("none", "bucketing", "resampling"):
            ra = RobustAggregator.from_spec(agg, mixing=mixing, s=2, **kw)
            mix = ra.mixing_matrix(12, torch.Generator().manual_seed(1), device="cpu")
            o, info = packed_aggregate(xs, ra, mix=mix, with_info=True)
            out[f"packed-{agg}-{mixing}"] = o.numpy()
            for k, v in info.items():
                out[f"packed-{agg}-{mixing}-{k}"] = v.numpy()
            for engine in ("packed", "per_leaf"):
                synced, _ = robust_gradient_sync(tree, ra, mix=mix, engine=engine)
                for k, v in synced.items():
                    out[f"sync-{engine}-{agg}-{mixing}-{k}"] = v.numpy()
            out[f"stacked-{agg}-{mixing}"] = ra(xs, mix=mix).numpy()
    X, Y, _, _ = make_train_test(torch.Generator().manual_seed(0), n_train=1000, n_test=10,
                                 device="cpu")
    wx, wy = worker_datasets(X.numpy(), Y.numpy(), n_good=18, n_byz=2, noniid=True)
    for agg in ("rfa", "cm", "tm", "acclip", "krum"):
        byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2, attack="bitflip",
                        n_byzantine=1)
        sim = CrossDeviceSim(loss_fn=nll_loss, byz=byz, n_clients=20, byz_frac=0.1,
                             clients_per_round=10, lr=0.5, batch_size=16, device="cpu")
        state, _ = sim.run(init_mlp(torch.Generator().manual_seed(1), device="cpu"),
                           torch.tensor(wx), torch.tensor(wy), 5, torch.Generator().manual_seed(2))
        for k, v in state.params.items():
            out[f"xdev-{agg}-{k}"] = v.numpy()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, help="the tree whose src/ is imported")
    ap.add_argument("--out", type=Path, help="where to save the outputs (.npz)")
    ap.add_argument("--against", type=Path, nargs=2, help="two saved files to compare")
    args = ap.parse_args()
    if args.against:
        a, b = (np.load(p) for p in args.against)
        if sorted(a.files) != sorted(b.files):
            print(f"the files hold different arrays: {sorted(set(a.files) ^ set(b.files))}")
            return 1
        differ = [k for k in a.files if a[k].tobytes() != b[k].tobytes()]
        print(f"{len(a.files)} arrays; {len(differ)} differ: {differ}")
        return 1 if differ else 0
    if args.root is None or args.out is None:
        ap.error("give --root and --out, or --against")
    sys.path.insert(0, str(args.root.resolve() / "src"))
    np.savez(args.out, **outputs())
    return 0


if __name__ == "__main__":
    sys.exit(main())
