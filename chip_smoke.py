#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda`` or ``CUDA_HOME``). Phases, each fatal on failure:

1. Build every CUDA kernel of the main path from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once).
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (cohort W = 10, m = 5 buckets, d = 106,496: the
   784-128-10 MLP packed) and at the paper's n (W = 25, m = 13) with
   d = 16,777,216; time kernel, plain version and a one-call PyTorch
   yardstick, and compute each call's bound from bytes and operations.
3. Drive the main path: ``CrossDeviceSim`` trains the MLP for 120 rounds
   under four rule/attack pairs. For each pair the kernel launch counts are
   set to 0 just before its run and read just after: each kernel of its
   route (Gram: ``pairwise_gram`` + ``bucket_mix``; CM or TM: ``bucket_mix``
   + the rule's kernel) must have launched once a round, every other
   kernel never. rfa+bitflip and acclip+ipm must pass 0.7 test accuracy.
   One round on the card is also held against the same round on the CPU.
4. Hold the residual-norm and centered-clipping kernels (``residual_norms``,
   ``cclip_fused_iter``, ``cclip_combine``) against their plain versions at
   the per-rank shape of the sharded sync ([5, 26,624]), the one-device
   main shape ([10, 106,496]) and the paper's ([25, 16,777,216]), timed and
   bounded as in phase 2.
5. Drive the one-device compositions ``ops.rfa_aggregate``, ``ops.cclip_aggregate``
   and ``ops.cclip_aggregate_unfused`` against their vector-space oracles,
   each with its exact launch counts, and time them at the paper's shape.
6. Drive the multi-rank sync: 4 ranks share the card under gloo
   (``launch.mesh.spawn_ranks``) and run ``robust_gradient_sync`` over the
   group on the MLP's per-worker gradients (W = 10, bucketing s = 2,
   d = 101,770) for rfa, cclip, cm, tm, krum and acclip. Each rank checks
   its exact launch counts per rule and its result against the one-device
   packed engine on the card (CM/TM bit for bit, the rest to 5e-4); every
   rank's result must be the same bit for bit. Host time per sync over 20
   syncs is printed, for 4 ranks sharing one card.

The last two lines are the ``kernels`` JSON and the result JSON. Exits
non-zero, without a result line, when CUDA is unavailable or any check
fails, in any rank.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 (non-tensor) op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

MAIN_D = 106_496          # the MLP's packed width (4 leaves padded to 2048)
PAPER_D = 16_777_216      # 1.68 GB at W = 25: above launch latency
ROUNDS = 120
SYNC_RANKS = 4            # ranks of the sharded sync, all on cuda:0
RANK_D = MAIN_D // SYNC_RANKS
SYNC_REPS = 20
#: exact launches of one sync over the group, per rank (the aggregators'
#: defaults: RFA T = 8, CCLIP T = 3)
SYNC_ROUTE = {
    "rfa": {"bucket_mix": 2, "residual_norms": 8},
    "cclip": {"bucket_mix": 2, "residual_norms": 1, "cclip_fused_iter": 3},
    "cm": {"bucket_mix": 1, "cwise_median": 1},
    "tm": {"bucket_mix": 1, "cwise_trimmed_mean": 1},
    "krum": {"pairwise_gram": 1, "bucket_mix": 1},
    "acclip": {"pairwise_gram": 1, "bucket_mix": 1},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, batch: int) -> float:
    """Device time of one call: ``batch`` calls captured in one CUDA graph,
    the graph replayed ``reps`` times between CUDA events; the median
    replay over ``batch``. The graph keeps the host's per-call overhead
    (argument checks, allocation, the launch itself) out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    del graph
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_phase():
    from repro_torch.kernels import (_build, bucket_mix, cclip_fused, cwise_median,
                                     pairwise_gram, trimmed_mean, weiszfeld_norms)

    # every library the ranks of phase 6 load is built here, before they start
    sources = (bucket_mix.sources() + pairwise_gram.sources()
               + cwise_median.sources(5) + cwise_median.sources(13)
               + trimmed_mean.sources(5, 1) + trimmed_mean.sources(13, 5)
               + trimmed_mean.sources(5, 2) + weiszfeld_norms.sources()
               + cclip_fused.sources())
    seconds = _build.build_all(sources)
    log(f"build: {len(sources)} CUDA sources for sm_90a ready in {seconds:.1f} s "
        f"({_build.BUILD_DIR})")


def measure(results, name, label, kernel, plain, library, n_bytes, n_ops, timing, check):
    """Hold ``kernel()`` against ``plain()`` with ``check``, time kernel, plain
    version and library call, and append the row to ``results[name]``. A
    kernel with several outputs returns a tuple, checked by a tuple of checks;
    the error is the largest."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want, check = (got,), (want,), (check,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w, c in zip(got, want, check):
        c(g, w)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    row = dict(shape=label, max_abs_err=err, ms=time_ms(kernel, *timing),
               plain_ms=time_ms(plain, *timing),
               library_ms=None if library is None else time_ms(library, *timing),
               bound_ms=b_ms, bound_by=b_by)
    results[name].append(row)
    lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    log(f"kernel {name} [{label}]: max_abs_err {err:.3g}  ms {row['ms']:.4f}  "
        f"bound_ms {b_ms:.4f} ({b_by})  plain_ms {row['plain_ms']:.4f}  library_ms {lib}")


def close(rtol, atol):
    import torch

    return lambda got, want: torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def kernel_cases(dev):
    """Inputs at the shapes the path gives each kernel."""
    import torch

    from repro_torch.core.mixing import Bucketing

    cases = []
    # (reps, batch) for time_ms: many calls per graph where a call is short
    for W, m_rows, b, d, timing in [(10, 5, 1, MAIN_D, (20, 50)),
                                    (25, 13, 5, PAPER_D, (10, 1))]:
        gen = torch.Generator(dev).manual_seed(W)
        x = torch.randn((W, d), device=dev, generator=gen)
        perm = torch.randperm(W, generator=torch.Generator().manual_seed(W))
        mix = Bucketing(2).matrix(W, perm=perm, device=dev)
        assert mix.shape == (m_rows, W)
        weights = torch.rand((1, W), device=dev, generator=gen)
        weights = weights / weights.sum()
        cases.append(dict(W=W, m=m_rows, b=b, d=d, timing=timing, x=x, mix=mix,
                          weights=weights))
    return cases


def kernel_phase(dev):
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.cwise_median import cwise_median
    from repro_torch.kernels.pairwise_gram import TILE_D, pairwise_gram
    from repro_torch.kernels.selection_network import (median_ranks, selection_program,
                                                       trim_ranks)
    from repro_torch.kernels.trimmed_mean import cwise_trimmed_mean

    results = {name: [] for name in ("bucket_mix", "pairwise_gram", "cwise_median",
                                     "cwise_trimmed_mean")}
    record = functools.partial(measure, results)

    def gram_close(x):
        # fp32 summation error scales with sum_k |x_ik x_jk|, not with the
        # value: off-diagonal terms cancel, and at d = 16.7 M an entry of a
        # few thousand carries rounding of ~1e-2 in any fp32 order. So the
        # reference's rtol 1e-5 is taken against |X| |X|^T, atol 1e-3.
        scale = x.abs() @ x.abs().T

        def check(got, want):
            excess = (got - want).abs() - (1e-3 + 1e-5 * scale)
            if bool((excess > 0).any()):
                raise AssertionError(f"pairwise_gram off by {float(excess.max())} "
                                     "beyond 1e-3 + 1e-5 |X||X|^T")
        return check

    def bitwise(got, want):
        if not torch.equal(got, want):
            raise AssertionError("kernel and plain version differ bitwise")

    for case in kernel_cases(dev):
        W, m, b, d = case["W"], case["m"], case["b"], case["d"]
        timing = case["timing"]
        x, mix, weights = case["x"], case["mix"], case["weights"]
        for what, M in (("mix", mix), ("combine", weights)):
            rows = M.shape[0]
            record("bucket_mix", f"{what} M[{rows},{W}] X[{W},{d}]",
                   lambda M=M: bucket_mix(M, x), lambda M=M: ref.bucket_mix(M, x),
                   lambda M=M: torch.matmul(M, x),
                   (W * d + rows * W + rows * d) * 4, 2 * rows * W * d, timing,
                   close(1e-5, 1e-4))
        record("pairwise_gram", f"X[{W},{d}]", lambda: pairwise_gram(x),
               lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
               (W * d + W * W) * 4, W * (W + 1) * d, timing, gram_close(x))
        exact = x.double() @ x.double().T
        errs = {k: float((g.double() - exact).abs().max()) for k, g in
                (("kernel", pairwise_gram(x)), ("plain", ref.pairwise_gram(x)))}
        results["pairwise_gram"][-1]["err_vs_fp64"] = errs
        log(f"check pairwise_gram X[{W},{d}]: max |error| against an fp64 Gram: "
            f"kernel {errs['kernel']:.4g}, plain fp32 {errs['plain']:.4g}")
        del exact

        g1, g2 = pairwise_gram(x), pairwise_gram(x)
        if not (torch.equal(g1, g2) and torch.equal(g1, g1.T)):
            raise AssertionError("pairwise_gram is not bitwise repeatable and symmetric")
        cuts = [0, TILE_D, 2 * TILE_D, d - TILE_D, d] if d == MAIN_D else \
            [0, 7 * TILE_D, d // 2, d]
        acc = None
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            acc = pairwise_gram(x[:, lo:hi].contiguous(), acc)
        if not torch.equal(acc, g1):
            raise AssertionError("pairwise_gram acc chain differs from one call")
        log(f"check pairwise_gram X[{W},{d}]: bitwise repeatable, symmetric, "
            f"{len(cuts) - 1}-call acc chain == one call")

        mixed = bucket_mix(mix, x)
        n_med = len(selection_program(m, median_ranks(m)))
        record("cwise_median", f"X[{m},{d}]", lambda: cwise_median(mixed),
               lambda: ref.cwise_median(mixed),
               lambda: torch.median(mixed, dim=0).values,
               (m + 1) * d * 4, 2 * n_med * d, timing, bitwise)
        band = trim_ranks(m, b)
        n_tm = len(selection_program(m, band))
        record("cwise_trimmed_mean", f"X[{m},{d}] b={b}",
               lambda: cwise_trimmed_mean(mixed, b),
               lambda: ref.cwise_trimmed_mean(mixed, b),
               lambda: torch.sort(mixed, dim=0).values[b:m - b].mean(dim=0),
               (m + 1) * d * 4, (2 * n_tm + len(band)) * d, timing, bitwise)

        if d == MAIN_D:
            poisoned = mixed.clone()
            poisoned[2, 7] = float("nan")
            med, want = cwise_median(poisoned), ref.cwise_median(poisoned)
            if not (torch.isnan(med[7]) and torch.isnan(want[7])
                    and torch.equal(torch.cat([med[:7], med[8:]]),
                                    torch.cat([want[:7], want[8:]]))):
                raise AssertionError("cwise_median does not propagate a NaN column")
            log("check cwise_median: a NaN column comes out NaN, the rest bitwise")
        del x, mixed
        torch.cuda.empty_cache()
    return results


def slice_phase(dev):
    import numpy as np
    import torch

    from repro_torch.configs.base import ByzConfig
    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.mlp import accuracy, init_mlp, nll_loss
    from repro_torch.training.cross_device import CrossDeviceSim

    X, Y, Xt, Yt = make_train_test(torch.Generator().manual_seed(0), n_train=3000,
                                   n_test=500, device=dev)
    wx, wy = worker_datasets(X.cpu().numpy(), Y.cpu().numpy(), n_good=45, n_byz=5,
                             noniid=True)
    wx, wy = torch.tensor(wx, device=dev), torch.tensor(wy, device=dev)
    runs = [("rfa", "bitflip", 0.7), ("acclip", "ipm", 0.7), ("cm", "bitflip", None),
            ("tm", "alie", None)]

    def make_sim(agg, attack, device):
        kwargs = (("n", 10), ("f", 2)) if attack == "alie" else ()
        byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2, attack=attack,
                        attack_kwargs=kwargs, n_byzantine=0)
        return CrossDeviceSim(loss_fn=nll_loss, byz=byz, n_clients=50, byz_frac=0.1,
                              clients_per_round=10, lr=1.0, batch_size=16,
                              server_momentum=0.9, device=device)

    # one round on the card against the same round on the CPU (plain versions)
    for agg, attack, _ in runs:
        sim_gpu, sim_cpu = make_sim(agg, attack, dev), make_sim(agg, attack, "cpu")
        params = init_mlp(torch.Generator().manual_seed(1), device="cpu")
        draws = sim_cpu.draw(torch.Generator().manual_seed(5), wx.shape[1])
        s_cpu, _ = sim_cpu.step(sim_cpu.init_state(params), wx.cpu(), wy.cpu(), draws)
        s_gpu, _ = sim_gpu.step(sim_gpu.init_state({k: v.to(dev) for k, v in params.items()}),
                                wx, wy, draws._replace(mix=draws.mix.to(dev)))
        for k in params:
            torch.testing.assert_close(s_gpu.params[k].cpu(), s_cpu.params[k],
                                       rtol=1e-4, atol=1e-5)
        log(f"check {agg}+{attack}: one round on the card == the round on the CPU "
            "(rtol 1e-4, atol 1e-5)")

    # Each path is counted on its own: counts set to 0 just before its run,
    # read just after. A round launches each of its route's kernels once (the
    # Gram route folds the mixing into the combine weights) and no other.
    route = {"rfa": ("pairwise_gram", "bucket_mix"), "acclip": ("pairwise_gram", "bucket_mix"),
             "cm": ("bucket_mix", "cwise_median"), "tm": ("bucket_mix", "cwise_trimmed_mean")}
    round_us, launches = {}, {}
    for agg, attack, threshold in runs:
        label = f"{agg}+{attack}"
        sim = make_sim(agg, attack, dev)
        params = init_mlp(torch.Generator().manual_seed(1), device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, hist = sim.run(params, wx, wy, ROUNDS, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        launches[label] = counts
        acc = float(accuracy(state.params, Xt, Yt))
        flat = torch.cat([p.reshape(-1) for p in state.params.values()])
        if not bool(torch.isfinite(flat).all()):
            raise AssertionError(f"{label}: non-finite parameters")
        round_us[(agg, attack)] = seconds / ROUNDS * 1e6
        log(f"slice {label}: {ROUNDS} rounds, test accuracy {acc:.4f}, "
            f"{ROUNDS / seconds:.1f} rounds/s, launches {json.dumps(counts)}")
        want = {k: ROUNDS if k in route[agg] else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"{label}: kernel launches {counts}, expected {want}")
        if threshold is not None and not acc > threshold:
            raise AssertionError(f"{label}: accuracy {acc} <= {threshold}")
    for (agg, attack), us in round_us.items():
        profile_rounds(make_sim(agg, attack, dev), wx, wy, dev, f"{agg}+{attack}", us)
    return launches


def norm_kernel_phase(dev):
    """Phase 4: the residual-norm and centered-clipping kernels against their
    plain versions, timed, at the three shapes. The path's own shape comes
    first in each kernel's rows."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.cclip_combine import cclip_combine
    from repro_torch.kernels.cclip_fused import cclip_fused_iter
    from repro_torch.kernels.weiszfeld_norms import residual_norms

    results = {name: [] for name in ("residual_norms", "cclip_fused_iter", "cclip_combine")}
    record = functools.partial(measure, results)
    shapes = [(5, RANK_D, (20, 50)), (10, MAIN_D, (20, 50)), (25, PAPER_D, (10, 1))]
    for W, d, timing in shapes:
        gen = torch.Generator(dev).manual_seed(100 + W)
        x = torch.randn((W, d), device=dev, generator=gen)
        c = torch.softmax(torch.randn(W, device=dev, generator=gen), 0)
        v = x.mean(0)
        norms = torch.sqrt(ref.residual_norms(x, center=v))
        lam = torch.clamp(0.5 * norms.median() / norms, max=1.0)  # about half clipped
        beta = 1.0 - float(lam.mean())
        label = f"X[{W},{d}]"
        # sums of W d terms in another order than the plain version's: the
        # reference's tolerances (tests/test_kernels.py)
        record("residual_norms", f"coeffs {label}", lambda: residual_norms(x, c),
               lambda: ref.residual_norms(x, c), None,
               (W * d + 2 * W) * 4, 5 * W * d, timing, close(1e-4, 1e-3))
        record("residual_norms", f"center {label}", lambda: residual_norms(x, center=v),
               lambda: ref.residual_norms(x, center=v),
               lambda: torch.cdist(x, v[None, :]),
               (W * d + d + W) * 4, 3 * W * d, timing, close(1e-4, 1e-3))
        record("cclip_fused_iter", label, lambda: cclip_fused_iter(x, v, lam),
               lambda: ref.cclip_fused_iter(x, v, lam), None,
               (W * d + 2 * d + 2 * W) * 4, 6 * W * d, timing,
               (close(1e-5, 1e-4), close(1e-4, 1e-3)))
        record("cclip_combine", label, lambda: cclip_combine(x, v, lam),
               lambda: ref.cclip_combine(x, v, lam),
               lambda: torch.addmv(v, x.T, lam, beta=beta, alpha=1.0 / W),
               (W * d + 2 * d + W) * 4, 3 * W * d, timing, close(1e-5, 1e-4))
        for what, call in (("coeffs", lambda: residual_norms(x, c)),
                           ("center", lambda: residual_norms(x, center=v)),
                           ("fused", lambda: cclip_fused_iter(x, v, lam)[1])):
            if not torch.equal(call(), call()):
                raise AssertionError(f"residual norms ({what}) not bitwise repeatable")
        log(f"check residual norms {label}: coefficient, centre and fused forms "
            "bitwise repeatable")
        del x, v, norms
        torch.cuda.empty_cache()
    # the combine's path is a one-device composition: its main shape first
    results["cclip_combine"].insert(0, results["cclip_combine"].pop(1))
    return results


def ops_phase(dev):
    """Phase 5: the one-device compositions, counted, checked and timed."""
    import torch

    from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches

    launches = {}
    for W, d, tau, timing in [(10, MAIN_D, 500.0, (20, 10)), (25, PAPER_D, 2000.0, (5, 1))]:
        x = torch.randn((W, d), device=dev, generator=torch.Generator(dev).manual_seed(W)) * 3
        compositions = [
            ("rfa_aggregate", lambda: ops.rfa_aggregate(x), lambda: ref.rfa_aggregate(x),
             {"residual_norms": 8, "bucket_mix": 1}),
            ("cclip_aggregate", lambda: ops.cclip_aggregate(x, tau),
             lambda: ref.cclip_aggregate(x, tau),
             {"bucket_mix": 1, "residual_norms": 1, "cclip_fused_iter": 3}),
            ("cclip_aggregate_unfused", lambda: ops.cclip_aggregate_unfused(x, tau),
             lambda: ref.cclip_aggregate(x, tau),
             {"bucket_mix": 1, "residual_norms": 3, "cclip_combine": 3}),
        ]
        for name, compose, oracle, route in compositions:
            label = f"ops.{name} X[{W},{d}]"
            torch.cuda.synchronize()
            reset_launches()
            got = compose()
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            want = {k: route.get(k, 0) for k in counts}
            if counts != want:
                raise AssertionError(f"{label}: kernel launches {counts}, expected {want}")
            expect = oracle()
            err = float((got - expect).abs().max())
            torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)
            if d == MAIN_D:
                launches[f"ops.{name}"] = counts
            log(f"ops {label}: launches {json.dumps(route)}, max_abs_err vs oracle {err:.3g}, "
                f"{time_ms(compose, *timing):.4f} ms per call")
        del x
        torch.cuda.empty_cache()
    return launches


def mlp_worker_grads(device):
    """Per-worker gradients of the 784-128-10 MLP (W = 10 workers, leaves
    [10, ...]), workers 8 and 9 sending them sign-flipped: the same on every
    rank (made on the CPU from fixed seeds), then moved to ``device``."""
    import torch
    from torch.func import grad, vmap

    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test
    from repro_torch.models.mlp import init_mlp, nll_loss

    X, Y, _, _ = make_train_test(torch.Generator().manual_seed(0), n_train=3000, n_test=10,
                                 device="cpu")
    wx, wy = worker_datasets(X.numpy(), Y.numpy(), n_good=8, n_byz=2, noniid=True)
    wx, wy = torch.tensor(wx), torch.tensor(wy)
    idx = torch.randint(0, wx.shape[1], (10, 16), generator=torch.Generator().manual_seed(2))
    rows = torch.arange(10)[:, None]
    params = init_mlp(torch.Generator().manual_seed(1), device="cpu")
    grads = vmap(grad(nll_loss), in_dims=(None, 0, 0))(params, wx[rows, idx], wy[rows, idx])
    return {k: torch.cat([g[:8], -g[8:]]).contiguous().to(device) for k, g in grads.items()}


def sync_rank(rank, group, device):
    """Phase 6, in each rank: every rule's sync over the group, with its
    launch counts, its check against the one-device engine and its time."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.robust_sync import robust_gradient_sync
    from repro_torch.kernels import LAUNCHES, reset_launches

    tree = mlp_worker_grads(device)
    out = {}
    for rule, route in SYNC_ROUTE.items():
        ra = ByzConfig(aggregator=rule, mixing="bucketing", s=2,
                       n_byzantine=2).make_aggregator(10)
        mix = ra.mixing_matrix(10, torch.Generator().manual_seed(7), device=device)

        def sync(mesh):
            return robust_gradient_sync(tree, ra, mix=mix, mesh=mesh)[0]

        torch.cuda.synchronize()
        dist.barrier(group)
        reset_launches()
        got = sync(group)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        want = {k: route.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"rank {rank} {rule}: launches {counts}, expected {want}")
        single = sync(None)
        err = max(float((got[k] - single[k]).abs().max()) for k in got)
        for k in got:
            if rule in ("cm", "tm"):
                if not torch.equal(got[k], single[k]):
                    raise AssertionError(f"rank {rank} {rule}: {k} differs from the "
                                         "one-device engine")
            else:
                torch.testing.assert_close(got[k], single[k], rtol=5e-4, atol=5e-4)
        if not all(bool(torch.isfinite(t).all()) for t in got.values()):
            raise AssertionError(f"rank {rank} {rule}: non-finite result")
        ms = {}
        for label, mesh in (("group", group), ("one_device", None)):
            dist.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SYNC_REPS):
                sync(mesh)
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) / SYNC_REPS * 1e3
        out[rule] = dict(result=got, counts=counts, max_abs_err=err, ms=ms)
    return out


def sync_phase():
    """Phase 6: SYNC_RANKS ranks on cuda:0 under gloo, results compared
    across ranks."""
    import numpy as np

    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(sync_rank, SYNC_RANKS, backend="gloo",
                        devices=["cuda:0"] * SYNC_RANKS, timeout_s=600)
    log(f"sync: {SYNC_RANKS} ranks on cuda:0 under gloo ran in "
        f"{time.perf_counter() - t0:.1f} s, spawn included")
    launches = {}
    for rule in SYNC_ROUTE:
        first = ranks[0][rule]["result"]
        for rank, r in enumerate(ranks):
            for k, v in r[rule]["result"].items():
                if not np.array_equal(v, first[k]):
                    raise AssertionError(f"sync {rule}: rank {rank} differs from rank 0 in {k}")
        counts = [r[rule]["counts"] for r in ranks]
        launches[f"sync.{rule}"] = {k: sum(c[k] for c in counts) for k in counts[0]}
        log(f"sync {rule}: every rank bitwise equal; launches per rank "
            f"{json.dumps(SYNC_ROUTE[rule])}; max |group - one device| "
            f"{max(r[rule]['max_abs_err'] for r in ranks):.3g}; host ms per sync, "
            f"{SYNC_RANKS} ranks sharing one card under gloo: "
            + ", ".join(f"{r[rule]['ms']['group']:.3f}" for r in ranks)
            + "; one-device engine in the same ranks: "
            + ", ".join(f"{r[rule]['ms']['one_device']:.3f}" for r in ranks))
    return launches


def profile_rounds(sim, wx, wy, dev, label, round_us: float, rounds: int = 20) -> None:
    """Device busy time per round and its largest kernels, from the
    profiler's CUDA kernel records; the busy share is taken against
    ``round_us``, the round time measured without the profiler (which slows
    the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(3)
    state = sim.init_state(init_mlp(torch.Generator().manual_seed(1), device=dev))
    for _ in range(5):
        state, _ = sim.step(state, wx, wy, sim.draw(gen, wx.shape[1]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, _ = sim.step(state, wx, wy, sim.draw(gen, wx.shape[1]))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"profile {label}: {rounds} rounds, device busy {busy_us / rounds:.1f} us/round "
        f"= {100 * busy_us / rounds / round_us:.2f} % of the unprofiled round "
        f"({round_us:.0f} us; {wall_us / rounds:.0f} us under the profiler), "
        f"{sum(e.count for e in kernels) / rounds:.0f} kernels/round; largest: " + "; ".join(
            f"{e.key[:48]} x{e.count / rounds:g} {e.self_device_time_total / rounds:.1f} us"
            for e in top))
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    log(f"profile {label} host self time per round (under the profiler): " + "; ".join(
        f"{e.key[:40]} x{e.count / rounds:g} {e.self_cpu_time_total / rounds:.0f} us"
        for e in host))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    build_phase()
    results = kernel_phase(dev)
    results.update(norm_kernel_phase(dev))
    launches = slice_phase(dev)
    launches.update(ops_phase(dev))
    launches.update(sync_phase())

    src = {"bucket_mix": "bucket_mix.cu", "pairwise_gram": "pairwise_gram.cu",
           "cwise_median": "selection.cu", "cwise_trimmed_mean": "selection.cu",
           "residual_norms": "residual_norms.cu", "cclip_fused_iter": "cclip.cu",
           "cclip_combine": "cclip.cu"}
    tpu = {"bucket_mix": "src/repro/kernels/bucket_mix.py:28",
           "pairwise_gram": "src/repro/kernels/pairwise_gram.py:47",
           "cwise_median": "src/repro/kernels/cwise_median.py:47",
           "cwise_trimmed_mean": "src/repro/kernels/trimmed_mean.py:43",
           "residual_norms": "src/repro/kernels/weiszfeld_norms.py:68",
           "cclip_fused_iter": "src/repro/kernels/cclip_fused.py:50",
           "cclip_combine": "src/repro/kernels/cclip_combine.py:33"}
    kernels = []
    for name, rows in results.items():
        main_row = rows[0]  # the main path's shape comes first
        by_path = {label: counts[name] for label, counts in launches.items()}
        if not sum(by_path.values()):
            raise AssertionError(f"{name} never launched on the main paths")
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src[name]}",
            replaces=tpu[name], launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=main_row["max_abs_err"],
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"], cases=rows))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
