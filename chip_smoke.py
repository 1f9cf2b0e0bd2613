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

The last two lines are the ``kernels`` JSON and the result JSON. Exits
non-zero, without a result line, when CUDA is unavailable or any check fails.
"""

from __future__ import annotations

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
    from repro_torch.kernels import _build, bucket_mix, cwise_median, pairwise_gram, trimmed_mean

    sources = (bucket_mix.sources() + pairwise_gram.sources()
               + cwise_median.sources(5) + cwise_median.sources(13)
               + trimmed_mean.sources(5, 1) + trimmed_mean.sources(13, 5))
    seconds = _build.build_all(sources)
    log(f"build: {len(sources)} CUDA sources for sm_90a ready in {seconds:.1f} s "
        f"({_build.BUILD_DIR})")


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

    def record(name, label, kernel, plain, library, n_bytes, n_ops, timing, check):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(got, want)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        row = dict(shape=label, max_abs_err=err, ms=time_ms(kernel, *timing),
                   plain_ms=time_ms(plain, *timing),
                   library_ms=None if library is None else time_ms(library, *timing),
                   bound_ms=b_ms, bound_by=b_by)
        results[name].append(row)
        log(f"kernel {name} [{label}]: max_abs_err {err:.3g}  ms {row['ms']:.4f}  "
            f"bound_ms {b_ms:.4f} ({b_by})  plain_ms {row['plain_ms']:.4f}  "
            f"library_ms {row['library_ms']:.4f}")

    def close(rtol, atol):
        return lambda got, want: torch.testing.assert_close(got, want, rtol=rtol, atol=atol)

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
    launches = slice_phase(dev)

    src = {"bucket_mix": "bucket_mix.cu", "pairwise_gram": "pairwise_gram.cu",
           "cwise_median": "selection.cu", "cwise_trimmed_mean": "selection.cu"}
    tpu = {"bucket_mix": "src/repro/kernels/bucket_mix.py:28",
           "pairwise_gram": "src/repro/kernels/pairwise_gram.py:47",
           "cwise_median": "src/repro/kernels/cwise_median.py:47",
           "cwise_trimmed_mean": "src/repro/kernels/trimmed_mean.py:43"}
    kernels = []
    for name, rows in results.items():
        main_row = rows[0]  # the main path's shape comes first
        by_path = {label: counts[name] for label, counts in launches.items()}
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
