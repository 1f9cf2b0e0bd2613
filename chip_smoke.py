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
7. Hold ``flash_attention`` against its plain version (``ref.attention``) on
   the card: the reference test's four cases in fp32 (2e-4), and in bf16
   (torch's bf16 tolerance, with the fp64 error of kernel and plain version
   printed) the attention shapes of the ported configs at B = 1, S = 4096
   (TinyLlama H 32 / KV 4 / dh 64, qwen2.5-14b 40 / 8 / 128, gemma-7b
   16 / 16 / 256), a chunked prefill (Sq = 512 against Skv = 4096) and a
   window of 1024; timed and bounded as in phase 2 (bf16 operations against
   the tensor-core peak), with ``scaled_dot_product_attention`` as the
   yardstick where ``Sq == Skv`` and there is no window.
8. Serve TinyLlama-1.1B at full width (22 layers, bf16, random weights from
   a seeded generator on the card): (a) ``make_prefill_step`` on B = 2,
   S = 4096 gives finite next-token logits [2, 1, 32000], timed and
   profiled (device busy share); (b) layer
   0's q/k/v, made by the model's own ``rmsnorm`` and ``_project_qkv`` from
   that prefill's embeddings, go through ``flash_attention`` (exactly one
   launch, counted on its own) and are held against the plain version, the
   model's ``_attn_blockwise`` and ``_attn_xla``, and an fp64 attention;
   (c) a ``ServeEngine`` with 4 slots serves 6 seeded requests (prompts of
   16-96 tokens, 16 new tokens each, greedy) to completion, and request 0's
   tokens equal a sequential greedy loop over ``decode_step`` run at the
   engine's batch width (the one-row loop's agreement is printed); decode
   ms per step and tokens/s are printed, and 20 steps with all 4 slots busy
   are timed and profiled; (d) in fp32 at full width, the last
   prompt position's logits of the prefill and of token-by-token decode
   agree within the reference's bar (rtol and atol 2e-3). The serving
   path's own modules launch no kernel, as in the reference (counted).

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

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) op/s
#: and dense bf16 tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12

MAIN_D = 106_496          # the MLP's packed width (4 leaves padded to 2048)
PAPER_D = 16_777_216      # 1.68 GB at W = 25: above launch latency
ROUNDS = 120
SYNC_RANKS = 4            # ranks of the sharded sync, all on cuda:0
RANK_D = MAIN_D // SYNC_RANKS
SYNC_REPS = 20
ATTN_S = 4096             # the attention and serving phases' sequence length
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


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_phase():
    from repro_torch.kernels import (_build, bucket_mix, cclip_fused, cwise_median,
                                     flash_attention, pairwise_gram, trimmed_mean,
                                     weiszfeld_norms)

    # every library the ranks of phase 6 load is built here, before they start
    sources = (bucket_mix.sources() + pairwise_gram.sources()
               + cwise_median.sources(5) + cwise_median.sources(13)
               + trimmed_mean.sources(5, 1) + trimmed_mean.sources(13, 5)
               + trimmed_mean.sources(5, 2) + weiszfeld_norms.sources()
               + cclip_fused.sources() + flash_attention.sources())
    seconds = _build.build_all(sources)
    log(f"build: {len(sources)} CUDA sources for sm_90a ready in {seconds:.1f} s "
        f"({_build.BUILD_DIR})")


def measure(results, name, label, kernel, plain, library, n_bytes, n_ops, timing, check,
            peak_ops=PEAK_FP32_PER_S):
    """Hold ``kernel()`` against ``plain()`` with ``check``, time kernel, plain
    version and library call, and append the row to ``results[name]``. A
    kernel with several outputs returns a tuple, checked by a tuple of checks;
    the error is the largest. ``peak_ops`` is the card's peak for the inputs'
    type (fp32 on the CUDA cores unless given)."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want, check = (got,), (want,), (check,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w, c in zip(got, want, check):
        c(g, w)
    b_ms, b_by = bound_ms(n_bytes, n_ops, peak_ops)
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


def visible_pairs(Sq: int, Skv: int, window: int, q_offset: int) -> int:
    """Query-key pairs the causal (and windowed) mask lets through."""
    import numpy as np

    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, qpos + 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros_like(qpos)
    return int(np.maximum(0, hi - lo).sum())


def attention_fp64(q, k, v, window: int = 0, q_offset=None):
    """``ref.attention`` in fp64: the yardstick of both bf16 versions' error."""
    from repro_torch.kernels import ref

    return ref.attention(q.double(), k.double(), v.double(), window=window, q_offset=q_offset)


def attention_row(results, label, q, k, v, window=0, q_offset=-1, timing=(5, 2),
                  blocks=(128, 128)):
    """One ``flash_attention`` case: kernel against the plain version, timed
    and bounded; for bf16 inputs the fp64 error of both is printed. ``blocks``
    are the caller's (block_q, block_kv), which must divide Sq and Skv."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    off = Skv - Sq if q_offset == -1 else q_offset
    library = None
    if Sq == Skv and window == 0:  # SDPA's is_causal aligns top-left: only then the same
        def library():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), is_causal=True,
                                                  enable_gqa=True)
    bf16 = q.dtype == torch.bfloat16
    # fp32 at the reference's 2e-4; bf16: both do fp32 math and round the
    # output to bf16 once, so torch's bf16 tolerance (rtol 1.6e-2, atol 1e-5)
    check = close(1.6e-2, 1e-5) if bf16 else close(2e-4, 2e-4)
    n_bytes = (2 * B * Sq * H * dh + 2 * B * Skv * KV * dh) * q.element_size()
    n_ops = 4 * B * H * dh * visible_pairs(Sq, Skv, window, off)
    measure(results, "flash_attention", label,
            lambda: flash_attention(q, k, v, window=window, q_offset=q_offset,
                                    block_q=blocks[0], block_kv=blocks[1]),
            lambda: ref.attention(q, k, v, window=window, q_offset=off), library,
            n_bytes, n_ops, timing, check, PEAK_BF16_PER_S if bf16 else PEAK_FP32_PER_S)
    if bf16:
        exact = attention_fp64(q, k, v, window, off)
        errs = {name: float((got.double() - exact).abs().max()) for name, got in
                (("kernel", flash_attention(q, k, v, window=window, q_offset=q_offset,
                                            block_q=blocks[0], block_kv=blocks[1])),
                 ("plain", ref.attention(q, k, v, window=window, q_offset=off)))}
        results["flash_attention"][-1]["err_vs_fp64"] = errs
        log(f"check flash_attention [{label}]: max |error| against fp64 attention: "
            f"kernel {errs['kernel']:.4g}, plain {errs['plain']:.4g}")
        del exact
    torch.cuda.empty_cache()


def attention_phase(dev):
    """Phase 7: ``flash_attention`` against its plain version at the reference
    test's cases (fp32) and the ported configs' attention shapes (bf16)."""
    import torch

    from repro_torch.configs import get_config

    results = {"flash_attention": []}
    gen = torch.Generator(dev).manual_seed(7)

    def qkv(B, Sq, Skv, H, KV, dh, dtype):
        return (torch.randn((B, Sq, H, dh), device=dev, generator=gen).to(dtype),
                torch.randn((B, Skv, KV, dh), device=dev, generator=gen).to(dtype),
                torch.randn((B, Skv, KV, dh), device=dev, generator=gen).to(dtype))

    # tests/test_kernels.py's cases: B = 2, dh = 32, fp32
    for Sq, Skv, H, KV, window in [(64, 64, 4, 4, 0), (64, 64, 8, 2, 0), (64, 64, 4, 2, 24),
                                   (32, 128, 4, 4, 0)]:
        attention_row(results, f"fp32 B2 Sq{Sq} Skv{Skv} H{H} KV{KV} dh32 w{window}",
                      *qkv(2, Sq, Skv, H, KV, 32, torch.float32), window=window,
                      timing=(20, 50), blocks=(16, 32))
    S = ATTN_S
    cases = [(name, get_config(name)) for name in ("tinyllama-1.1b", "qwen2.5-14b", "gemma-7b")]
    for name, cfg in cases:
        H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        attention_row(results, f"bf16 {name} B1 S{S} H{H} KV{KV} dh{dh}",
                      *qkv(1, S, S, H, KV, dh, torch.bfloat16))
    tiny = cases[0][1]
    H, KV, dh = tiny.n_heads, tiny.n_kv_heads, tiny.head_dim_
    attention_row(results, f"bf16 tinyllama-1.1b chunked B1 Sq512 Skv{S}",
                  *qkv(1, 512, S, H, KV, dh, torch.bfloat16))
    attention_row(results, f"bf16 tinyllama-1.1b B1 S{S} window 1024",
                  *qkv(1, S, S, H, KV, dh, torch.bfloat16), window=1024)
    return results


def greedy_decode(cfg, params, prompt, max_new, batch, dev):
    """Sequential greedy decode of one request over ``decode_step`` (the
    loop of tests/test_serving.py::reference_decode), the request in row 0
    of a ``batch``-row step whose other rows feed token 0."""
    import torch

    from repro_torch.models import transformer as tfm

    cache = tfm.init_cache(cfg, batch, 256, device=dev)
    out = []
    for t in range(len(prompt) + max_new - 1):
        feed = torch.zeros(batch, dtype=torch.long, device=dev)
        feed[0] = prompt[t] if t < len(prompt) else out[-1]
        logits, cache = tfm.decode_step(params, cfg, cache, feed, t)
        if t >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0])))
    return out[:max_new]


def serve_phase(dev, results):
    """Phase 8: TinyLlama-1.1B at full width through the serving path; adds
    the kernel's row on the model's own q/k/v at the front of ``results``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rmsnorm
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.utils.tree import tree_flatten, tree_map

    cfg = get_config("tinyllama-1.1b")
    V, S = cfg.vocab_size, ATTN_S
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    log(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, {cfg.dtype}): {n_params:,} parameters on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}

    def counted(label, fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[label] = dict(LAUNCHES)
        return out

    # (a) the serving prefill, B = 2, S = 4096 (auto -> blockwise attention)
    tokens = torch.randint(0, V, (2, S), device=dev, generator=torch.Generator(dev).manual_seed(1))
    prefill = make_prefill_step(cfg, device=dev)
    logits = counted("serve.prefill", lambda: prefill(params, {"tokens": tokens}))
    if tuple(logits.shape) != (2, 1, V) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"serve prefill B2 S{S}: logits [2, 1, {V}] finite; host ms per prefill "
        f"{', '.join(f'{t:.1f}' for t in times)} (median {statistics.median(times):.1f}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_steps(lambda: prefill(params, {"tokens": tokens}), f"serve.prefill B2 S{S}",
                  statistics.median(times) * 1e3, 1, "prefill")

    # (b) the kernel on layer 0's own q/k/v
    lp = tree_map(lambda t: t[0], params["blocks"])["0"]
    x = tfm.embed_tokens(params, cfg, tokens)
    q, k, v = attn._project_qkv(lp["mixer"], rmsnorm(lp["norm1"], x, cfg.norm_eps), cfg,
                                torch.arange(S, device=dev)[None, :])
    got = counted("serve.layer0_attention", lambda: flash_attention(q, k, v))
    want = {name: int(name == "flash_attention") for name in LAUNCHES}
    if launches["serve.layer0_attention"] != want:
        raise AssertionError(f"layer 0 attention: launches "
                             f"{launches['serve.layer0_attention']}, expected {want}")
    scale = cfg.head_dim_ ** -0.5
    exact = attention_fp64(q, k, v)
    others = {"plain": ref.attention(q, k, v),
              "blockwise": attn._attn_blockwise(q, k, v, scale, True, 0, cfg.attn_block_q,
                                                cfg.attn_block_kv),
              "xla": attn._attn_xla(q, k, v, scale, True, 0)}
    errs = {name: float((t.double() - exact).abs().max())
            for name, t in [("kernel", got)] + list(others.items())}
    diffs = {name: float((got.float() - t.float()).abs().max()) for name, t in others.items()}
    log(f"check flash_attention on layer 0's q/k/v {tuple(q.shape)} {q.dtype}: max |error| "
        f"against fp64 attention: " + ", ".join(f"{n} {e:.4g}" for n, e in errs.items())
        + "; max |kernel - other|: " + ", ".join(f"{n} {d:.4g}" for n, d in diffs.items()))
    # the model's impls round the logits (xla the probabilities too) to bf16
    # before the softmax, so they stand further from the exact value than
    # the kernel and the plain version, which keep them in fp32: 2^-5
    for name in ("blockwise", "xla"):
        torch.testing.assert_close(got, others[name], rtol=2**-5, atol=2**-5)
    del exact, others
    torch.cuda.empty_cache()
    rows = {"flash_attention": []}
    attention_row(rows, f"serve layer 0 q/k/v bf16 B2 S{S} H{cfg.n_heads} KV{cfg.n_kv_heads} "
                  f"dh{cfg.head_dim_}", q, k, v,
                  timing=(3, 1))
    results["flash_attention"].insert(0, rows["flash_attention"][0])
    del q, k, v, x, got
    torch.cuda.empty_cache()

    # (c) continuous batching: 4 slots, 6 requests
    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 97, (6,), generator=rng).tolist()
    prompts = [torch.randint(0, V, (n,), generator=rng).tolist() for n in lens]
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=256, device=dev)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=16))
    t0 = time.perf_counter()
    done = counted("serve.engine", eng.run_until_drained)
    wall = time.perf_counter() - t0
    if sorted(done) != list(range(6)) or any(len(r.output) != 16 for r in done.values()):
        raise AssertionError(f"engine: finished {sorted(done)}, outputs "
                             f"{[len(r.output or []) for r in done.values()]}")
    stats = eng.stats()
    log(f"serve engine: 6 requests (prompts {lens}) x 16 new tokens in {eng.steps_total} steps, "
        f"{wall:.2f} s; decode ms per step mean {stats['serve_decode_step_s'] * 1e3:.2f}, "
        f"median {eng.step_timer.summary()['p50_s'] * 1e3:.2f}; "
        f"{eng.tokens_total / wall:.1f} tokens/s "
        f"over the run ({stats.get('serve_tokens_per_s', float('nan')):.1f} over the "
        f"timer's window)")
    # bf16 GEMMs of another batch size may sum in another order, and greedy
    # argmax follows any last-bit change of near-tied logits: the loop runs
    # the request in a batch of the engine's width, where row 0's arithmetic
    # is the engine's own; the one-row loop's agreement is printed
    seq = greedy_decode(cfg, params, prompts[0], 16, eng.B, dev)
    if done[0].output != seq:
        raise AssertionError(f"engine request 0 {done[0].output} != sequential greedy {seq}")
    one_row = greedy_decode(cfg, params, prompts[0], 16, 1, dev)
    log(f"check engine request 0 == sequential greedy decode over decode_step (16 tokens); "
        f"the one-row loop agrees on {sum(a == b for a, b in zip(one_row, seq))} of 16")

    # decode steps with all 4 slots in one cohort, unprofiled then profiled
    busy = ServeEngine(cfg, params, batch_slots=4, max_len=256, device=dev)
    for uid in range(4):
        busy.submit(Request(uid=uid, prompt=prompts[uid][:8], max_new_tokens=200))
    for _ in range(5):
        busy.step()
    t0 = time.perf_counter()
    for _ in range(20):
        busy.step()
    step_us = (time.perf_counter() - t0) / 20 * 1e6
    log(f"serve decode, 4 slots busy: {step_us / 1e3:.2f} ms per step, "
        f"{4e6 / step_us:.1f} tokens/s")
    profile_steps(busy.step, "serve.decode 4 slots", step_us, 20)
    del busy

    # (d) prefill against decode in fp32 at full width
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    prompt = torch.randint(0, V, (1, 32), device=dev, generator=torch.Generator(dev).manual_seed(4))
    last = make_prefill_step(cfg32, device=dev)(params32, {"tokens": prompt})[:, 0]
    cache = tfm.init_cache(cfg32, 1, 32, device=dev)
    for t in range(32):
        step, cache = tfm.decode_step(params32, cfg32, cache, prompt[:, t], t)
    err = float((step - last).abs().max())
    torch.testing.assert_close(step, last, rtol=2e-3, atol=2e-3)
    log(f"check fp32 prefill vs decode (32 tokens, full width): last-position logits agree, "
        f"max |diff| {err:.3g} (bar: rtol and atol 2e-3)")
    del params32, cache
    torch.cuda.empty_cache()
    for label in ("serve.prefill", "serve.engine"):
        if any(launches[label].values()):
            raise AssertionError(f"{label} launched {launches[label]}; the serving path's "
                                 "own modules call no kernel")
    return launches


def profile_rounds(sim, wx, wy, dev, label, round_us: float, rounds: int = 20) -> None:
    """Profile ``rounds`` rounds of ``sim`` after 5 warm-up rounds."""
    import torch

    from repro_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(3)
    state = sim.init_state(init_mlp(torch.Generator().manual_seed(1), device=dev))
    for _ in range(5):
        state, _ = sim.step(state, wx, wy, sim.draw(gen, wx.shape[1]))

    def one_round():
        nonlocal state
        state, _ = sim.step(state, wx, wy, sim.draw(gen, wx.shape[1]))

    profile_steps(one_round, label, round_us, rounds, "round")


def profile_steps(step, label, step_us: float, steps: int, unit: str = "step") -> None:
    """Device busy time per step and its largest kernels, from the
    profiler's CUDA kernel records; the busy share is taken against
    ``step_us``, the step time measured without the profiler (which slows
    the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"profile {label}: {steps} {unit}s, device busy {busy_us / steps:.1f} us/{unit} "
        f"= {100 * busy_us / steps / step_us:.2f} % of the unprofiled {unit} "
        f"({step_us:.0f} us; {wall_us / steps:.0f} us under the profiler), "
        f"{sum(e.count for e in kernels) / steps:.0f} kernels/{unit}; largest: " + "; ".join(
            f"{e.key[:48]} x{e.count / steps:g} {e.self_device_time_total / steps:.1f} us"
            for e in top))
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    log(f"profile {label} host self time per {unit} (under the profiler): " + "; ".join(
        f"{e.key[:40]} x{e.count / steps:g} {e.self_cpu_time_total / steps:.0f} us"
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
    results.update(attention_phase(dev))
    launches.update(serve_phase(dev, results))

    src = {"bucket_mix": "bucket_mix.cu", "pairwise_gram": "pairwise_gram.cu",
           "cwise_median": "selection.cu", "cwise_trimmed_mean": "selection.cu",
           "residual_norms": "residual_norms.cu", "cclip_fused_iter": "cclip.cu",
           "cclip_combine": "cclip.cu", "flash_attention": "flash_attention.cu"}
    tpu = {"bucket_mix": "src/repro/kernels/bucket_mix.py:28",
           "pairwise_gram": "src/repro/kernels/pairwise_gram.py:47",
           "cwise_median": "src/repro/kernels/cwise_median.py:47",
           "cwise_trimmed_mean": "src/repro/kernels/trimmed_mean.py:43",
           "residual_norms": "src/repro/kernels/weiszfeld_norms.py:68",
           "cclip_fused_iter": "src/repro/kernels/cclip_fused.py:50",
           "cclip_combine": "src/repro/kernels/cclip_combine.py:33",
           "flash_attention": "src/repro/kernels/flash_attention.py:74"}
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
