"""Telemetry smoke of the PyTorch port: 5 telemetry-on rounds (the
counterpart of ``scripts/telemetry_smoke.py``).

Runs a tiny cross-device simulation (ALIE cohort attack, RFA + bucketing)
with the packed engine's telemetry on, writes every round's metrics as
``round`` events through ``repro_torch.telemetry.EventLog``, then re-reads
the file with ``validate_jsonl`` — the producer -> JSONL -> schema loop.
Exits nonzero if any metric is missing, unregistered, or non-finite where
finiteness is required.

Usage:  PYTHONPATH=src python scripts/telemetry_smoke_torch.py [out.jsonl] [--device cpu]

Runs on the card unless given ``--device cpu``; one process, no ranks.
"""

import argparse
import math
import os
import sys

N_ROUNDS = 5


def main(argv=None):
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="telemetry_smoke_torch.jsonl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from repro_torch.configs.base import ByzConfig
    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test
    from repro_torch.models.mlp import init_mlp, nll_loss
    from repro_torch.telemetry import EventLog, validate_jsonl
    from repro_torch.training.cross_device import CrossDeviceSim

    dev = torch.device(args.device)
    X, Y, _, _ = make_train_test(torch.Generator().manual_seed(0), n_train=1200, n_test=100,
                                 device=dev)
    wx, wy = worker_datasets(X.cpu().numpy(), Y.cpu().numpy(), n_good=18, n_byz=2,
                             noniid=True)
    byz = ByzConfig(aggregator="rfa", mixing="bucketing", s=2, attack="alie",
                    attack_kwargs=(("n", 10), ("f", 2)), n_byzantine=0)
    sim = CrossDeviceSim(loss_fn=nll_loss, byz=byz, n_clients=20, byz_frac=0.1,
                         clients_per_round=10, lr=0.5, batch_size=16, telemetry=True,
                         device=dev)
    params = init_mlp(torch.Generator().manual_seed(1), device=dev)
    if os.path.exists(args.out):
        os.remove(args.out)
    with EventLog(args.out, run_id="telemetry_smoke_torch") as log:
        log.run_meta(script="telemetry_smoke_torch", device=str(dev), rounds=N_ROUNDS,
                     aggregator=byz.aggregator, mixing=byz.mixing, attack=byz.attack)
        _, hist = sim.run(params, torch.tensor(wx, device=dev), torch.tensor(wy, device=dev),
                          N_ROUNDS, torch.Generator().manual_seed(2))
        tele = hist["telemetry"]
        assert tele, "telemetry-on run produced an empty metrics tree"
        for t in range(N_ROUNDS):
            log.round(t, {name: arr[t] for name, arr in tele.items()})

    events = validate_jsonl(args.out)
    rounds = [e for e in events if e["kind"] == "round"]
    assert len(rounds) == N_ROUNDS, (len(rounds), N_ROUNDS)
    names = sorted(rounds[0]["metrics"])
    for must in ("agg_norm", "byz_in_cohort", "byz_mask", "rfa_residual",
                 "sync_egress_bytes", "worker_weights"):
        assert must in names, f"round events missing metric {must!r}"
    for e in rounds:
        agg_norm = e["metrics"]["agg_norm"]
        assert math.isfinite(agg_norm), f"non-finite agg_norm: {agg_norm}"
    print(f"telemetry smoke OK: {len(events)} events ({len(rounds)} rounds) -> {args.out}")
    print(f"round metrics: {', '.join(names)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
