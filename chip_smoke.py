#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda`` or ``CUDA_HOME``). Phases, each fatal on failure:

1. Build every CUDA kernel of the main path from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), and print the registers and spills
   ``ptxas`` reports for each instance of the tensor-core attention kernel
   (``flash_attention_wgmma.cu``), the Gram kernel (``pairwise_gram.cu``),
   ``bucket_mix.cu``, ``residual_norms.cu`` (which ``cclip_fused_iter``
   launches too), ``cclip.cu`` and every instance of the selection kernels
   it builds (W = 5 .. 128); a spill in any of them fails the phase.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (cohort W = 10, m = 5 buckets, d = 106,496: the
   784-128-10 MLP packed) and at the paper's n (W = 25, m = 13) with
   d = 16,777,216; time kernel, plain version and a one-call PyTorch
   yardstick, and compute each call's bound from bytes and operations.
   The Gram is also timed at a rank's slice of the 4-rank sync
   (X[10, 26,624]); it must be bitwise repeatable, symmetric and equal to
   its chain over 2048-aligned cuts, and it must stage X by TMA at these
   shapes (``VARIANT_LAUNCHES``), and by predicated loads at an unaligned
   X[10, 100,003], whose Gram equals bit for bit the TMA call on the same
   columns padded to 2048. Above 64 workers (W = 65 and 128, d = 106,496)
   the mix and combine and the Gram (one launch per pair of 32-row groups:
   symmetric, bitwise repeatable) are held, timed and bounded the same way.
   CM and TM (``SELECTION_SHAPES``: X[5, 106,496] with b = 1, 2; a rank's
   X[5, 26,624]; X[13, 16.7 M] and X[27, 16.7 M] with b = 5; X[65 / 128,
   106,496] with b = W // 4) are held bit for bit, on random values and on
   the same values with NaN, signed-zero and infinite columns, and bounded
   by min / max and add instruction rates (``selection_ops``).
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
   main shape ([10, 106,496]), the paper's n = 25 and 53 ([25 / 53,
   16,777,216]) and above 64 workers ([65, 106,496], [128, 106,496]),
   timed and bounded as in phase 2. At each shape the v' of
   ``cclip_fused_iter`` equals ``cclip_combine``'s bit for bit (the same
   fmaf chain), every norm repeats bit for bit, and a ``cclip_fused_iter``
   call is one CUDA kernel (profiler).
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
   yardstick (``is_causal`` where ``Sq == Skv`` and there is no window, else
   an explicit boolean ``attn_mask``). Each row prints the kernel that ran
   (``VARIANT_LAUNCHES``): every bf16 row must take ``wgmma``, every fp32
   row ``simt``; each bf16 row also checks and times the CUDA-core kernel on
   the same inputs, as the earlier design's time in the same run.
8. Serve TinyLlama-1.1B at full width (22 layers, bf16, random weights from
   a seeded generator on the card): (a) ``make_prefill_step`` on B = 2,
   S = 4096 gives finite next-token logits [2, 1, 32000], timed and
   profiled (device busy share); (b) layer
   0's q/k/v, made by the model's own ``rmsnorm`` and ``_project_qkv`` from
   that prefill's embeddings, go through ``flash_attention`` (exactly one
   launch, of the ``wgmma`` kernel, counted on its own) and are held against
   the plain version, the model's ``_attn_blockwise`` and ``_attn_xla`` (2^-5),
   and an fp64 attention (the kernel's error no larger than blockwise's);
   (c) a ``ServeEngine`` with 4 slots serves 6 seeded requests (prompts of
   16-96 tokens, 16 new tokens each, greedy) to completion, and request 0's
   tokens equal a sequential greedy loop over ``decode_step`` run at the
   engine's batch width (the one-row loop's agreement is printed); decode
   ms per step and tokens/s are printed, and 20 steps with all 4 slots busy
   are timed and profiled; (d) in fp32 at full width, the last
   prompt position's logits of the prefill and of token-by-token decode
   agree within the reference's bar (rtol and atol 2e-3). The serving
   path's own modules launch no kernel, as in the reference (counted).
9. Drive the paper's experiment loop, ``ByzantineSim``, at the benchmark's
   scale: the 784-128-10 MLP on SynthMNIST (4,000 train / 1,000 test) split
   non-iid over n = 25 workers, f = 5 Byzantine (0 in the unattacked runs),
   batch 32, 300 steps (``PAPER_RUNS``: mean; Krum without and with
   bucketing; CM under mimic without and with bucketing; RFA under
   bit-flipping; CCLIP under IPM with worker momentum 0.9, lr 0.5). One
   step of each on the card equals the same step on the CPU with the same
   draws (rtol 1e-4, atol 1e-6); the accuracies must pass the thresholds of
   ``tests/test_sim.py``, which the JAX reference meets at this scale
   (``PAPER_REFERENCE``, from ``scripts/paper_loop_reference.py``, printed
   beside them). Each run is counted on its own and launches no kernel, as
   in the reference; steps/s and the profiled busy share are printed beside
   the card's name and power limit.
10. Telemetry on the card: (a) ``ByzantineSim(telemetry=True)`` under ALIE
   (n = 25, f = 5, 15 steps): the Byzantine rows' ``cm_worker_dev`` is
   below 0.6 times the honest rows' and their Krum scores are lower; (b)
   for each of phase 3's pairs, 20 ``CrossDeviceSim`` rounds with telemetry
   on and off from the same draws launch the same kernels and end on the
   same parameters bit for bit, every metric finite and catalogued; (c) in
   each rank of phase 6, ``robust_gradient_sync(telemetry=True)`` for RFA
   and CCLIP launches what off did and keeps its bits, the metrics are
   equal bit for bit on every rank, and ``rfa_resid_norms`` /
   ``cclip_lam`` are within 1e-4 of the one-device engine's; (d) phase
   8(c)'s engine writes one ``serve`` event a step to a log on disk that
   ``validate_jsonl`` accepts.
11. LLM training (``distributed/steps.py::make_train_step``): (a)
   TinyLlama-1.1B at full width (22 layers, bf16, 1,100,048,384 random
   parameters from a seed) trained by W = 4 workers, one 1024-token
   sequence each from ``make_token_stream`` (one affine-bigram law a
   worker), sgdm lr 1e-2, worker momentum 0.9: RFA with bucketing s = 2
   for 3 steps, 3 more under the profiler (device busy share), then CM for
   1 step. Each step launches exactly ``TRAIN_ROUTE``'s kernels at
   X[4, n_pad], n_pad = 1,100,048,384 + padding; its loss is finite and the
   parameters move; its aggregate, recomputed on the same worker momenta,
   equals the plain route's (``TRAIN_AGG_RTOL`` of the largest row norm),
   and the kernel's Gram agrees with an fp64 Gram (``TRAIN_GRAM_RTOL`` of
   sqrt(G_ii G_jj)). Host ms a step, tokens/s, device ms by phase (CUDA
   events: forward + backward, worker momentum, pack, each kernel's phase,
   the optimizer) and each step's peak memory are printed; then
   ``pairwise_gram``, ``bucket_mix`` (mix [2, 4], combine [1, 4]) and
   ``cwise_median`` (X[2, n_pad]) are held and timed on the packed momenta,
   as in phase 2. (b) ``tests/test_system.py``'s run at smoke width (30
   steps, RFA + bucketing, lr 0.3) at W = 1 and 4 meets its gate (last loss
   below 0.8 x the first). (c) 4 gloo ranks on the card run the
   worker-sharded step (one worker a rank; the rows go to column slices
   through one ``all_to_all``) for 3 steps of RFA and of CM: launches per
   rank as phase 6's, every rank's parameters equal rank 0's bit for bit
   and the one-device step's within rtol 1e-4 / atol 1e-6.
12. The MoE family (``models/moe.py``): (a) OLMoE-1B-7B served at its
   published width and depth (16 layers, 64 experts top-8, d_ff_expert
   1024, bf16; 6,919,096,320 random parameters from a seed, the count
   asserted): ``make_prefill_step`` on B = 2, S = 4096 (C = 1280) timed
   and profiled, its drop fraction printed; phase 8's 6-request
   ``ServeEngine`` run, request 0 equal to the greedy loop at the engine's
   width (C = 8 >= 4 decode tokens: none dropped); 20 decode steps with 4
   slots busy timed and profiled beside their bound (every expert's
   weights are read each step); no kernel of ours launches (counted). (b)
   phase 11(a)'s training at OLMoE's full width with the depth cut to 2
   layers (d = 1,045,178,368): the same steps, exact launches, checks and
   prints, then each worker's routing on the trained model (drop fraction,
   experts that got no token from some worker). (c) The smoke-width gate
   of phase 11(b) for OLMoE at W = 4, and one Kimi K2 smoke step of RFA
   and of CM (fsdp on one rank, server momentum, bf16 optimizer momentum)
   with exact launches.

The last two lines are the ``kernels`` JSON and the result JSON. Exits
non-zero, without a result line, when CUDA is unavailable or any check
fails, in any rank.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) op/s
#: and dense bf16 tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
#: Instruction rates behind the fp32 peak (132 SMs x 128 FMA a clock x 2 flops
#: x 1.98 GHz): the CUDA C++ Programming Guide's throughput table for
#: compute capability 9.0 gives 128 results a clock an SM for fp32 add /
#: multiply / FMA and 64 for compare / minimum / maximum, so a min or a max
#: costs two fp32 flops' time and an add one.
PEAK_FADD_PER_S = PEAK_FP32_PER_S / 2
PEAK_MINMAX_PER_S = PEAK_FP32_PER_S / 4

MAIN_D = 106_496          # the MLP's packed width (4 leaves padded to 2048)
PAPER_D = 16_777_216      # 1.68 GB at W = 25: above launch latency
ROUNDS = 120
SYNC_RANKS = 4            # ranks of the sharded sync, all on cuda:0
RANK_D = MAIN_D // SYNC_RANKS
SYNC_REPS = 20
WIDE_W = (65, 128)        # workers above the 64 the register arrays hold
#: phase 4's (W, d, (reps, batch)): a rank's slice of the sync, the
#: one-device path, the paper's n = 25 and 53, and the wide rows
NORM_SHAPES = [(5, RANK_D, (20, 50)), (10, MAIN_D, (20, 50)), (25, PAPER_D, (10, 1)),
               (53, PAPER_D, (5, 1))] + [(W, MAIN_D, (20, 20)) for W in WIDE_W]
#: selection rows (W, d, n_trim values, (reps, batch)): the path (5 buckets of
#: the W = 10 cohort), a rank's slice of the 4-rank sync, the paper's n = 25
#: and n = 53 in buckets (13 / 27 rows), and the wide rows trimming W // 4;
#: the path's own shape first
SELECTION_SHAPES = [(5, MAIN_D, (1, 2), (20, 50)), (5, RANK_D, (1,), (20, 50)),
                    (13, PAPER_D, (5,), (10, 1)), (27, PAPER_D, (5,), (10, 1))] + [
    (W, MAIN_D, (W // 4,), (20, 10)) for W in WIDE_W]
#: phase 3's rule/attack pairs and their accuracy thresholds
SLICE_RUNS = [("rfa", "bitflip", 0.7), ("acclip", "ipm", 0.7), ("cm", "bitflip", None),
              ("tm", "alie", None)]
#: phase 9: the paper's experiment loop at benchmarks/common.py's scale,
#: (label, f, lr, ByzConfig fields) with n = 25 workers, batch 32, 300 steps;
#: scripts/paper_loop_reference.py runs the same list through the JAX
#: reference on the CPU
PAPER_N, PAPER_STEPS = 25, 300
PAPER_RUNS = [
    ("mean/none", 0, 0.1, dict(aggregator="mean", attack="none")),
    ("krum/none vanilla", 0, 0.1, dict(aggregator="krum", mixing="none", attack="none")),
    ("krum/none s=2", 0, 0.1, dict(aggregator="krum", mixing="bucketing", s=2,
                                   attack="none")),
    ("cm+mimic vanilla", 5, 0.1, dict(aggregator="cm", mixing="none", attack="mimic")),
    ("cm+mimic s=2", 5, 0.1, dict(aggregator="cm", mixing="bucketing", s=2, attack="mimic")),
    ("rfa+bitflip s=2", 5, 0.1, dict(aggregator="rfa", mixing="bucketing", s=2,
                                     attack="bitflip")),
    ("cclip+ipm s=2", 5, 0.5, dict(aggregator="cclip", mixing="bucketing", s=2,
                                   worker_momentum=0.9, attack="ipm",
                                   attack_kwargs=(("eps", 0.1),))),
]
#: the JAX reference's test accuracy for each run, on the CPU with the same
#: n, f, steps and seeds (scripts/paper_loop_reference.py); printed beside
#: the card's, the gates are tests/test_sim.py's (``paper_gates``)
PAPER_REFERENCE = {"mean/none": 1.0, "krum/none vanilla": 0.2, "krum/none s=2": 0.806,
                   "cm+mimic vanilla": 0.938, "cm+mimic s=2": 0.989,
                   "rfa+bitflip s=2": 0.994, "cclip+ipm s=2": 1.0}
#: phase 10(c): the sync rules run again with telemetry on, in each rank
SYNC_TELEMETRY = {"rfa": "rfa_resid_norms", "cclip": "cclip_lam"}
ATTN_S = 4096             # the attention and serving phases' sequence length
#: phase 11: TinyLlama-1.1B trained at full width by TRAIN_W workers, one
#: TRAIN_S-token sequence each; (rule, steps) in order, the state carried on
TRAIN_W, TRAIN_S, TRAIN_LR = 4, 1024, 1e-2
TRAIN_RUNS = [("rfa", 3), ("cm", 1)]
TRAIN_M = 2               # buckets of W = 4 at s = 2: CM's selection rows
#: exact launches of one one-device train step (the Gram route folds the
#: mixing into the combine weights; CM mixes, then selects)
TRAIN_ROUTE = {"rfa": {"pairwise_gram": 1, "bucket_mix": 1},
               "cm": {"bucket_mix": 1, "cwise_median": 1}}
#: the kernel aggregate against the plain route's, on the same worker
#: momenta, relative to the largest row norm; the Gram against an fp64
#: Gram relative to sqrt(G_ii G_jj). At n_pad = 1.1e9 the kernel's fold of
#: ~537,000 unit partials in column order (the reference's order) is off by
#: 2.4e-4, torch.matmul by 2.3e-3 (NVIDIA H100 80GB HBM3, 700 W)
TRAIN_AGG_RTOL, TRAIN_GRAM_RTOL = 1e-4, 1e-3
#: phase 11(b)/(c): tests/test_system.py's run at smoke width (30 steps, lr
#: 0.3, global batch 8 x 64 tokens), and the group's steps
SMOKE_STEPS, SMOKE_LR, GROUP_STEPS = 30, 0.3, 3
#: phase 12: OLMoE-1B-7B served at its published width and depth, and
#: trained at its width with the depth cut to MOE_TRAIN_LAYERS, which puts
#: d near phase 11's TinyLlama (1.1e9); Kimi K2 at smoke width only
MOE_ARCH, MOE_PARAMS = "olmoe-1b-7b", 6_919_096_320
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS = 2, 1_045_178_368
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


def selection_ops(W: int, d: int, n_trim=None) -> float:
    """Operations of a CM (``n_trim`` None) or TM call, as min / max
    instructions at ``PEAK_MINMAX_PER_S``: per column, each min or max of
    the program whose result is read again (``live_minmax``), and the adds
    and the multiply that form the result (TM's band, the even median's
    midpoint) at ``PEAK_FADD_PER_S``. Min / max and add run on separate
    pipes, so the larger of the two counts."""
    from repro_torch.kernels.selection_network import median_ranks, trim_ranks

    if n_trim is None:
        ranks = median_ranks(W)
        n_minmax, n_add = live_minmax(W, ranks), 2 * (len(ranks) - 1)
    else:
        n_minmax = live_minmax(W, trim_ranks(W, n_trim)) if n_trim else 0
        n_add = W - 2 * n_trim
    return max(n_minmax, n_add * PEAK_MINMAX_PER_S / PEAK_FADD_PER_S) * d


def live_minmax(W: int, ranks) -> int:
    """Mins and maxes of ``selection_program(W, ranks)`` whose result a later
    comparator or the result reads: a comparator whose lower (upper) slot
    is dead afterwards needs no min (max); ptxas drops those."""
    from repro_torch.kernels.selection_network import selection_program

    live, n = set(ranks), 0
    for i, j in reversed(selection_program(W, tuple(ranks))):
        need = (i in live) + (j in live)
        n += need
        if need:
            live |= {i, j}
    return n


def build_phase():
    from repro_torch.kernels import (_build, bucket_mix, cclip_combine, cclip_fused,
                                     cwise_median, flash_attention, pairwise_gram,
                                     trimmed_mean, weiszfeld_norms)

    # every library the ranks of phase 6 load is built here, before they start
    selection = {
        "cwise_median": list(dict.fromkeys(
            src for W in [w for w, _, _, _ in SELECTION_SHAPES] + [TRAIN_M]
            for src in cwise_median.sources(W))),
        "cwise_trimmed_mean": list(dict.fromkeys(
            src for W, _, trims, _ in SELECTION_SHAPES for b in trims
            for src in trimmed_mean.sources(W, b)))}
    # cclip_fused_iter launches the residual_norms library: each source once
    sources = list(dict.fromkeys(
        bucket_mix.sources() + pairwise_gram.sources() + weiszfeld_norms.sources()
        + cclip_fused.sources() + cclip_combine.sources() + flash_attention.sources()
        + selection["cwise_median"] + selection["cwise_trimmed_mean"]))
    seconds = _build.build_all(sources)
    log(f"build: {len(sources)} CUDA sources for sm_90a ready in {seconds:.1f} s "
        f"({_build.BUILD_DIR})")
    ptxas = {}
    # each instance's registers and spills: the tensor-core attention and
    # the Gram, bucket_mix, residual_norms (all three centre forms), the
    # combine and every selection instance built here (all at W <= 128).
    # A spill in any instance fails the phase.
    checked = [("flash_attention_wgmma", "DH"), ("pairwise_gram", "L"), ("bucket_mix", ""),
               ("residual_norms", ""), ("cclip", "")] + [
        (n, "") for srcs in selection.values() for n, _ in srcs]
    for name, param in checked:
        (text,) = [t for n, t in sources if n == name]
        ptxas[name] = res = ptxas_resources(_build.build_log(name, text), param)
        for inst, r in res.items():
            log(f"build {name} {inst}: {r['registers']} registers, spill "
                f"stores {r['spill_stores']} B, spill loads {r['spill_loads']} B")
        if not res or any(r["spill_stores"] or r["spill_loads"] for r in res.values()):
            raise AssertionError(f"{name}: ptxas resources {res} (a spill, or no report)")
    for kernel, srcs in selection.items():
        ptxas[kernel] = {n: ptxas[n] for n, _ in srcs}
    return ptxas


def ptxas_resources(text: str, param: str = ""):
    """Registers and spill bytes per kernel instance from ``ptxas -v``
    output, keyed by the instance's template arguments: ``DH=64`` for a
    ``param`` of one argument, else ``name<16,1>`` (bools as 0 / 1), or
    the kernel's name where it has none."""
    import re

    out, inst = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            head = re.match(r"_Z(\d+)", mangled)
            name = mangled[head.end():head.end() + int(head.group(1))] if head else mangled
            args = re.search(r"I((?:L[a-z]\d+E)+)E", mangled)
            vals = re.findall(r"L[a-z](\d+)E", args.group(1)) if args else []
            if param and len(vals) == 1:
                inst = f"{param}={vals[0]}"
            else:
                inst = f"{name}<{','.join(vals)}>" if vals else name
            out[inst] = dict(registers=None, spill_stores=None, spill_loads=None)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and inst:
            out[inst].update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and inst:
            out[inst]["registers"] = int(regs.group(1))
    return out


def measure(results, name, label, kernel, plain, library, n_bytes, n_ops, timing, check,
            peak_ops=PEAK_FP32_PER_S, extra=None):
    """Hold ``kernel()`` against ``plain()`` with ``check``, time kernel, plain
    version and library call, and append the row (with ``extra``'s keys) to
    ``results[name]``. A kernel with several outputs returns a tuple, checked
    by a tuple of checks; the error is the largest. ``peak_ops`` is the
    card's peak for the inputs' type (fp32 on the CUDA cores unless given)."""
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
               bound_ms=b_ms, bound_by=b_by, bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
               ops_ms=n_ops / peak_ops * 1e3, **(extra or {}))
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
    for W, m_rows, d, timing in [(10, 5, MAIN_D, (20, 50)), (25, 13, PAPER_D, (10, 1))]:
        gen = torch.Generator(dev).manual_seed(W)
        x = torch.randn((W, d), device=dev, generator=gen)
        perm = torch.randperm(W, generator=torch.Generator().manual_seed(W))
        mix = Bucketing(2).matrix(W, perm=perm, device=dev)
        assert mix.shape == (m_rows, W)
        weights = torch.rand((1, W), device=dev, generator=gen)
        weights = weights / weights.sum()
        cases.append(dict(W=W, d=d, timing=timing, x=x, mix=mix, weights=weights))
    return cases


def kernel_phase(dev):
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.pairwise_gram import TILE_D, pairwise_gram

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

    for case in kernel_cases(dev):
        W, d = case["W"], case["d"]
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

        g1, kind = gram_variant(lambda: pairwise_gram(x))
        if kind != "gram_tma":
            raise AssertionError(f"pairwise_gram X[{W},{d}] ran {kind}, not gram_tma")
        g2 = pairwise_gram(x)
        if not (torch.equal(g1, g2) and torch.equal(g1, g1.T)):
            raise AssertionError("pairwise_gram is not bitwise repeatable and symmetric")
        cuts = [0, TILE_D, 2 * TILE_D, d - TILE_D, d] if d == MAIN_D else \
            [0, 7 * TILE_D, d // 2, d]
        acc = None
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            acc = pairwise_gram(x[:, lo:hi].contiguous(), acc)
        if not torch.equal(acc, g1):
            raise AssertionError("pairwise_gram acc chain differs from one call")
        log(f"check pairwise_gram X[{W},{d}]: {kind}, bitwise repeatable, symmetric, "
            f"{len(cuts) - 1}-call acc chain == one call")
        del x
        torch.cuda.empty_cache()

    # the Gram at a rank's slice of the 4-rank sync (krum, acclip)
    x = torch.randn((10, RANK_D), device=dev, generator=torch.Generator(dev).manual_seed(4))
    record("pairwise_gram", f"X[10,{RANK_D}]", lambda: pairwise_gram(x),
           lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
           (10 * RANK_D + 100) * 4, 110 * RANK_D, (20, 50), gram_close(x))
    g1, kind = gram_variant(lambda: pairwise_gram(x))
    if kind != "gram_tma" or not (torch.equal(g1, pairwise_gram(x)) and torch.equal(g1, g1.T)):
        raise AssertionError(f"pairwise_gram X[10,{RANK_D}]: {kind}, or not bitwise "
                             "repeatable and symmetric")
    log(f"check pairwise_gram X[10,{RANK_D}]: {kind}, bitwise repeatable, symmetric")
    # an unaligned X (the per-leaf chain's leaves) takes the predicated loads
    # and gives the bits of the same values padded to TILE_D, which take TMA
    d_odd = 100_003
    x = torch.randn((10, d_odd), device=dev, generator=torch.Generator(dev).manual_seed(5))
    g_odd, kind = gram_variant(lambda: pairwise_gram(x))
    gram_close(x)(g_odd, ref.pairwise_gram(x))
    padded = torch.nn.functional.pad(x, (0, -d_odd % TILE_D)).contiguous()
    g_pad, kind_pad = gram_variant(lambda: pairwise_gram(padded))
    if (kind, kind_pad) != ("gram_ldg", "gram_tma") or not torch.equal(g_odd, g_pad):
        raise AssertionError(f"pairwise_gram X[10,{d_odd}] ran {kind} (padded: {kind_pad}); "
                             "expected gram_ldg and gram_tma with the same bits")
    log(f"check pairwise_gram X[10,{d_odd}]: gram_ldg, within tolerance, bitwise equal to "
        "the TMA call on the same columns padded to 2048")
    del x, padded
    wide_kernel_rows(dev, record, gram_close)
    selection_rows(dev, record)
    return results


def plant_specials(x):
    """A copy of ``x`` [W, d] with a NaN in one row of a column, eight NaN
    columns among one warp's columns and an all-NaN one, columns of mixed
    +0 / -0 (alone and among other values), and +-inf (with a NaN in one
    column)."""
    import torch

    W, d = x.shape
    x = x.clone()
    nan, inf = float("nan"), float("inf")
    even = torch.arange(W, device=x.device) % 2 == 0
    signed_zeros = torch.where(even, -0.0, 0.0)
    x[W // 2, 7 % d] = nan
    for j in range(8):
        x[(3 * j) % W, (32 + j) % d] = nan
    x[:, 40 % d] = nan
    x[:, 64 % d] = signed_zeros
    x[: (W + 1) // 2, 65 % d] = signed_zeros[: (W + 1) // 2]
    x[0, 96 % d] = inf
    x[W - 1, 97 % d] = -inf
    x[:, 98 % d] = inf
    x[:, 99 % d] = torch.where(even, -inf, inf)
    x[:, 100 % d] = torch.where(torch.arange(W, device=x.device) % 3 == 0, -inf, inf)
    x[W - 1, 100 % d] = nan
    return x


def same_bits(got, want) -> bool:
    """Bit-for-bit equality, NaN payloads and signed zeros included."""
    import torch

    return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


def selection_rows(dev, record):
    """Phase 2's CM and TM rows (``SELECTION_SHAPES``): bit for bit against
    the plain version, timed beside ``torch.median`` and a sort with the band's
    mean, bounded by ``selection_ops``; then the same values with
    ``plant_specials``' NaN, signed-zero and infinite columns, bit for bit."""
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cwise_median import cwise_median, threads_for
    from repro_torch.kernels.trimmed_mean import cwise_trimmed_mean

    def bitwise(got, want):
        if not same_bits(got, want):
            raise AssertionError("kernel and plain version differ bitwise")

    for W, d, trims, timing in SELECTION_SHAPES:
        x = torch.randn((W, d), device=dev, generator=torch.Generator(dev).manual_seed(W + d))
        # one column a thread, in blocks of the wrapper's size
        geometry = dict(threads=threads_for(W, d, _build.sm_count(torch.cuda.current_device())))
        record("cwise_median", f"X[{W},{d}]", lambda: cwise_median(x),
               lambda: ref.cwise_median(x), lambda: torch.median(x, dim=0).values,
               (W + 1) * d * 4, selection_ops(W, d), timing, bitwise, PEAK_MINMAX_PER_S,
               geometry)
        rows = [("cwise_median", None)]
        for b in trims:
            record("cwise_trimmed_mean", f"X[{W},{d}] b={b}",
                   lambda b=b: cwise_trimmed_mean(x, b), lambda b=b: ref.cwise_trimmed_mean(x, b),
                   lambda b=b: torch.sort(x, dim=0).values[b:W - b].mean(dim=0),
                   (W + 1) * d * 4, selection_ops(W, d, b), timing, bitwise, PEAK_MINMAX_PER_S,
                   geometry)
            rows.append(("cwise_trimmed_mean", b))
        special = plant_specials(x)
        del x
        for name, b in rows:
            got = cwise_median(special) if b is None else cwise_trimmed_mean(special, b)
            want = ref.cwise_median(special) if b is None else ref.cwise_trimmed_mean(special, b)
            bitwise(got, want)
            if not bool(torch.isnan(got[7 % d])):
                raise AssertionError(f"{name} X[{W},{d}]: a NaN column did not come out NaN")
        log(f"check selection X[{W},{d}] ({geometry['threads']} threads a block): CM and TM "
            f"b={list(trims)} bit for bit with the plain version, NaN, +-0 and +-inf "
            "columns included")
        del special, got, want
        torch.cuda.empty_cache()


def wide_kernel_rows(dev, record, gram_close):
    """Phase 2's rows above 64 workers (W = 65, 128) at the one-device d:
    mix (bucketing s = 2) and combine, the Gram (one launch per pair of
    32-row groups); CM and TM there are ``selection_rows``'."""
    import torch

    from repro_torch.core.mixing import Bucketing
    from repro_torch.kernels import LAUNCHES, ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.pairwise_gram import pairwise_gram, row_groups

    d = MAIN_D
    for W in WIDE_W:
        gen = torch.Generator(dev).manual_seed(W)
        x = torch.randn((W, d), device=dev, generator=gen)
        perm = torch.randperm(W, generator=torch.Generator().manual_seed(W))
        weights = torch.rand((1, W), device=dev, generator=gen)
        for what, M in (("mix", Bucketing(2).matrix(W, perm=perm, device=dev)),
                        ("combine", weights / weights.sum())):
            rows = M.shape[0]
            record("bucket_mix", f"{what} M[{rows},{W}] X[{W},{d}]",
                   lambda M=M: bucket_mix(M, x), lambda M=M: ref.bucket_mix(M, x),
                   lambda M=M: torch.matmul(M, x),
                   (W * d + rows * W + rows * d) * 4, 2 * rows * W * d, (20, 50),
                   close(1e-5, 1e-4))
        before = LAUNCHES["pairwise_gram"]
        g = pairwise_gram(x)
        calls = LAUNCHES["pairwise_gram"] - before
        n_groups = len(row_groups(W))
        if calls != n_groups * (n_groups - 1) // 2 or not (
                torch.equal(g, g.T) and torch.equal(g, pairwise_gram(x))):
            raise AssertionError(f"pairwise_gram X[{W},{d}]: {calls} launches, or not "
                                 "symmetric and bitwise repeatable")
        record("pairwise_gram", f"X[{W},{d}] ({calls} launches)", lambda: pairwise_gram(x),
               lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
               (W * d + W * W) * 4, W * (W + 1) * d, (20, 10), gram_close(x))
        log(f"check W = {W}: the mix, the combine and the Gram agreed with their plain "
            f"versions (the Gram in {calls} launches, symmetric, bitwise repeatable)")
        del x, g
        torch.cuda.empty_cache()


def gram_variant(call):
    """``call()``'s result and the one ``pairwise_gram`` variant it ran."""
    from repro_torch.kernels import VARIANT_LAUNCHES

    before = dict(VARIANT_LAUNCHES)
    out = call()
    ran = [k for k in ("gram_tma", "gram_ldg") if VARIANT_LAUNCHES[k] > before[k]]
    if len(ran) != 1:
        raise AssertionError(f"pairwise_gram ran the variants {ran}")
    return out, ran[0]


def slice_task(dev):
    """The slice's pool: SynthMNIST (3,000 train / 500 test) split non-iid
    over 50 clients, 5 of them Byzantine, on the card."""
    import torch

    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test

    X, Y, Xt, Yt = make_train_test(torch.Generator().manual_seed(0), n_train=3000,
                                   n_test=500, device=dev)
    wx, wy = worker_datasets(X.cpu().numpy(), Y.cpu().numpy(), n_good=45, n_byz=5,
                             noniid=True)
    return torch.tensor(wx, device=dev), torch.tensor(wy, device=dev), Xt, Yt


def slice_sim(agg, attack, device, telemetry=False):
    from repro_torch.configs.base import ByzConfig
    from repro_torch.models.mlp import nll_loss
    from repro_torch.training.cross_device import CrossDeviceSim

    kwargs = (("n", 10), ("f", 2)) if attack == "alie" else ()
    byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2, attack=attack,
                    attack_kwargs=kwargs, n_byzantine=0)
    return CrossDeviceSim(loss_fn=nll_loss, byz=byz, n_clients=50, byz_frac=0.1,
                          clients_per_round=10, lr=1.0, batch_size=16,
                          server_momentum=0.9, telemetry=telemetry, device=device)


def slice_phase(dev):
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.mlp import accuracy, init_mlp

    wx, wy, Xt, Yt = slice_task(dev)
    # one round on the card against the same round on the CPU (plain versions)
    for agg, attack, _ in SLICE_RUNS:
        sim_gpu, sim_cpu = slice_sim(agg, attack, dev), slice_sim(agg, attack, "cpu")
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
    for agg, attack, threshold in SLICE_RUNS:
        label = f"{agg}+{attack}"
        sim = slice_sim(agg, attack, dev)
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
        profile_rounds(slice_sim(agg, attack, dev), wx, wy, dev, f"{agg}+{attack}", us)
    return launches


def norm_kernel_phase(dev):
    """Phase 4: the residual-norm and centered-clipping kernels against their
    plain versions, timed, at ``NORM_SHAPES``. The path's own shape comes
    first in each kernel's rows."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.cclip_combine import cclip_combine
    from repro_torch.kernels.cclip_fused import cclip_fused_iter
    from repro_torch.kernels.weiszfeld_norms import residual_norms

    results = {name: [] for name in ("residual_norms", "cclip_fused_iter", "cclip_combine")}
    record = functools.partial(measure, results)
    for W, d, timing in NORM_SHAPES:
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
        if not same_bits(cclip_fused_iter(x, v, lam)[0], cclip_combine(x, v, lam)):
            raise AssertionError(f"cclip_fused_iter {label}: v' differs from cclip_combine's")
        kernels = profile_kernels(lambda: cclip_fused_iter(x, v, lam), 3)
        if [launches for _, launches in kernels.values()] != [1]:
            raise AssertionError(f"cclip_fused_iter {label}: a call ran the CUDA kernels "
                                 f"{kernels}, not one")
        log(f"check residual norms {label}: coefficient, centre and fused forms "
            "bitwise repeatable; the fused v' equals cclip_combine's bit for bit; a fused "
            f"call is one CUDA kernel ({next(iter(kernels))[:60]})")
        del x, v, norms
        torch.cuda.empty_cache()
    # the combine's path is a one-device composition: its main shape first
    results["cclip_combine"].insert(0, results["cclip_combine"].pop(1))
    return results


def profile_kernels(fn, calls: int = 20):
    """Device microseconds and launches per call of each CUDA kernel ``fn``
    launches (memsets included), from the profiler's device records over
    ``calls`` calls after one call outside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / calls, e.count / calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0}


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
    from repro_torch.telemetry import get_metric

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
        if rule in SYNC_TELEMETRY:
            # phase 10(c): telemetry on over the group launches what off did,
            # keeps off's bits, and reads the kernels' own outputs
            torch.cuda.synchronize()
            dist.barrier(group)
            reset_launches()
            on, info = robust_gradient_sync(tree, ra, mix=mix, mesh=group, telemetry=True)
            torch.cuda.synchronize()
            tele_counts = dict(LAUNCHES)
            if tele_counts != counts:
                raise AssertionError(f"rank {rank} {rule} telemetry on: launches "
                                     f"{tele_counts}, off {counts}")
            if not all(torch.equal(on[k], got[k]) for k in got):
                raise AssertionError(f"rank {rank} {rule}: telemetry on changed the result")
            tele = info["telemetry"]
            for name, v in tele.items():
                get_metric(name)
                if not bool(torch.isfinite(torch.as_tensor(v, dtype=torch.float32)).all()):
                    raise AssertionError(f"rank {rank} {rule}: {name} not finite")
            name = SYNC_TELEMETRY[rule]
            single = robust_gradient_sync(tree, ra, mix=mix, mesh=None,
                                          telemetry=True)[1]["telemetry"][name]
            torch.testing.assert_close(tele[name], single, rtol=1e-4, atol=1e-4)
            out[rule].update(telemetry=tele, telemetry_counts=tele_counts,
                             telemetry_err=float((tele[name] - single).abs().max()))
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
        if rule in SYNC_TELEMETRY:
            first_t = ranks[0][rule]["telemetry"]
            for rank, r in enumerate(ranks):
                tele = r[rule]["telemetry"]
                if sorted(tele) != sorted(first_t) or not all(
                        np.array_equal(np.asarray(v), np.asarray(first_t[k]))
                        for k, v in tele.items()):
                    raise AssertionError(f"sync {rule} telemetry: rank {rank} differs from rank 0")
            tcounts = [r[rule]["telemetry_counts"] for r in ranks]
            launches[f"telemetry.sync.{rule}"] = {k: sum(c[k] for c in tcounts)
                                                  for k in tcounts[0]}
            log(f"check sync {rule} telemetry on ({len(first_t)} metrics): launches and result "
                "bits as off in every rank; the metrics equal bit for bit on every rank; "
                f"{SYNC_TELEMETRY[rule]} within 1e-4 of the one-device engine's, max |diff| "
                f"{max(r[rule]['telemetry_err'] for r in ranks):.3g}")
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

    from repro_torch.kernels import VARIANT_LAUNCHES, ref
    from repro_torch.kernels.flash_attention import flash_attention

    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    off = Skv - Sq if q_offset == -1 else q_offset
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if Sq == Skv and window == 0:  # SDPA's is_causal aligns top-left: only then the same
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    else:  # the same function through an explicit boolean mask (True: attend)
        qpos = off + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = (kpos <= qpos) & ((kpos > qpos - window) if window > 0 else True)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    bf16 = q.dtype == torch.bfloat16
    before = dict(VARIANT_LAUNCHES)
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
    ran = [kind for kind, n in VARIANT_LAUNCHES.items() if n > before[kind]]
    want = "wgmma" if bf16 else "simt"
    results["flash_attention"][-1]["variant"] = "+".join(ran)
    log(f"variant flash_attention [{label}]: {'+'.join(ran)}")
    if ran != [want]:
        raise AssertionError(f"flash_attention [{label}]: ran {ran}, expected {want}")
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
        # the CUDA-core kernel (the only one before the tensor-core redesign)
        # on the same inputs, called past the dispatch: not a launch of the path
        simt = simt_attention(q, k, v, window, off)
        check(simt(), ref.attention(q, k, v, window=window, q_offset=off))
        row = results["flash_attention"][-1]
        row["simt_ms"] = time_ms(simt, *timing)
        log(f"kernel flash_attention [{label}]: CUDA-core kernel on the same bf16 inputs "
            f"{row['simt_ms']:.4f} ms, {row['simt_ms'] / row['ms']:.1f}x the wgmma kernel")
    torch.cuda.empty_cache()


def simt_attention(q, k, v, window: int, off: int):
    """A call of ``csrc/flash_attention.cu`` on bf16 inputs that the
    wrapper would send to the tensor-core kernel."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)

    def call():
        code = fa._lib("simt").flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KV, dh,
            1, window, off, dh ** -0.5, 1, _build.stream_of(q))
        _build.check_launch("flash_attention (simt)", code)
        return out
    return call


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


def run_counted(launches, label, fn):
    """``fn()`` with every launch count set to 0 just before it and read
    just after, into ``launches[label]``."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches[label] = dict(LAUNCHES)
    return out


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
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rmsnorm
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.telemetry import EventLog, validate_jsonl
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
    counted = functools.partial(run_counted, launches)

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
    attn_variants = {k: VARIANT_LAUNCHES[k] for k in ("wgmma", "simt")}
    if launches["serve.layer0_attention"] != want or attn_variants != {"wgmma": 1, "simt": 0}:
        raise AssertionError(f"layer 0 attention: launches "
                             f"{launches['serve.layer0_attention']}, expected {want}; "
                             f"variants {VARIANT_LAUNCHES}, expected one wgmma")
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
    if errs["kernel"] > errs["blockwise"]:
        raise AssertionError(f"layer 0 attention: kernel error {errs['kernel']} above "
                             f"blockwise's {errs['blockwise']}")
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
    # phase 10(d): the engine writes one serve event a step to a log on disk
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log_path = os.path.join(tmp, "serve.jsonl")
        with EventLog(log_path, run_id="chip_smoke") as event_log:
            eng = ServeEngine(cfg, params, batch_slots=4, max_len=256, event_log=event_log,
                              device=dev)
            for uid, prompt in enumerate(prompts):
                eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=16))
            t0 = time.perf_counter()
            done = counted("serve.engine", eng.run_until_drained)
            wall = time.perf_counter() - t0
        events = validate_jsonl(log_path)
    if sorted(done) != list(range(6)) or any(len(r.output) != 16 for r in done.values()):
        raise AssertionError(f"engine: finished {sorted(done)}, outputs "
                             f"{[len(r.output or []) for r in done.values()]}")
    if len(events) != eng.steps_total or any(e["kind"] != "serve" for e in events):
        raise AssertionError(f"engine event log: {len(events)} events of kinds "
                             f"{sorted({e['kind'] for e in events})} for {eng.steps_total} steps")
    if events[-1]["metrics"]["serve_tokens_total"] != 6 * 16:
        raise AssertionError(f"engine event log: last event {events[-1]}")
    log(f"check serve event log: validate_jsonl accepts {len(events)} serve events on disk, "
        f"one a step ({eng.steps_total} steps), the last counting {6 * 16} tokens")
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


def paper_task(dev):
    """Phase 9's data: SynthMNIST at benchmarks/common.py's scale (4,000
    train / 1,000 test), split non-iid over ``PAPER_N`` workers with f of
    them Byzantine, for each f of ``PAPER_RUNS``; on the card."""
    import torch

    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test

    X, Y, Xt, Yt = make_train_test(torch.Generator().manual_seed(0), n_train=4000,
                                   n_test=1000, device=dev)
    split = {}
    for f in sorted({f for _, f, _, _ in PAPER_RUNS}):
        wx, wy = worker_datasets(X.cpu().numpy(), Y.cpu().numpy(), n_good=PAPER_N - f,
                                 n_byz=f, noniid=True)
        split[f] = (torch.tensor(wx, device=dev), torch.tensor(wy, device=dev))
    return split, Xt, Yt


def paper_sim(fields, f, lr, device, telemetry=False):
    from repro_torch.configs.base import ByzConfig
    from repro_torch.models.mlp import nll_loss
    from repro_torch.training.byzantine import ByzantineSim

    return ByzantineSim(loss_fn=nll_loss, byz=ByzConfig(n_byzantine=f, **fields),
                        n_workers=PAPER_N, n_byzantine=f, lr=lr, batch_size=32,
                        telemetry=telemetry, device=device)


def paper_gates(acc) -> None:
    """tests/test_sim.py's thresholds, which the reference meets at this
    scale (``PAPER_REFERENCE``)."""
    gates = [
        ("mean/none > 0.75", acc["mean/none"] > 0.75),
        ("krum s=2 > vanilla + 0.05", acc["krum/none s=2"] > acc["krum/none vanilla"] + 0.05),
        ("cm+mimic s=2 > vanilla - 0.07", acc["cm+mimic s=2"] > acc["cm+mimic vanilla"] - 0.07),
        ("cm+mimic s=2 > 0.5", acc["cm+mimic s=2"] > 0.5),
        ("rfa+bitflip s=2 > 0.6", acc["rfa+bitflip s=2"] > 0.6),
        ("cclip+ipm s=2 > 0.6", acc["cclip+ipm s=2"] > 0.6),
    ]
    failed = [name for name, ok in gates if not ok]
    if failed:
        raise AssertionError(f"paper loop: accuracies {acc} miss {failed}")
    log("check paper loop gates (tests/test_sim.py): " + "; ".join(n for n, _ in gates))


def paper_phase(dev, smi: str):
    """Phase 9: the paper's experiment loop, ``ByzantineSim``, at the
    benchmark's scale on the card."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.mlp import accuracy, init_mlp

    split, Xt, Yt = paper_task(dev)
    # one step on the card against the same step on the CPU, same draws
    for label, f, lr, fields in PAPER_RUNS:
        wx, wy = split[f]
        sim_gpu, sim_cpu = paper_sim(fields, f, lr, dev), paper_sim(fields, f, lr, "cpu")
        params = init_mlp(torch.Generator().manual_seed(1), device="cpu")
        draws = sim_cpu.draw(torch.Generator().manual_seed(5), wx.shape[1])
        s_cpu, _ = sim_cpu.step(sim_cpu.init_state(params), wx.cpu(), wy.cpu(), draws)
        s_gpu, _ = sim_gpu.step(sim_gpu.init_state({k: v.to(dev) for k, v in params.items()}),
                                wx, wy, draws._replace(mix=draws.mix.to(dev)))
        for k in params:
            torch.testing.assert_close(s_gpu.params[k].cpu(), s_cpu.params[k],
                                       rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(s_gpu.momentum.cpu(), s_cpu.momentum, rtol=1e-4, atol=1e-6)
    log(f"check paper loop: one step on the card == the step on the CPU with the same draws "
        f"(parameters and momenta, rtol 1e-4, atol 1e-6), for all {len(PAPER_RUNS)} runs")

    # each run counted on its own: ByzantineSim aggregates through
    # RobustAggregator, as the reference does, and launches no kernel
    acc, step_us, launches = {}, {}, {}
    for label, f, lr, fields in PAPER_RUNS:
        wx, wy = split[f]
        sim = paper_sim(fields, f, lr, dev)
        params = init_mlp(torch.Generator().manual_seed(1), device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, _ = sim.run(params, wx, wy, PAPER_STEPS, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[f"paper.{label}"] = counts = dict(LAUNCHES)
        if any(counts.values()):
            raise AssertionError(f"paper {label}: launched {counts}; the loop runs no kernel")
        flat = torch.cat([p.reshape(-1) for p in state.params.values()])
        if not bool(torch.isfinite(flat).all()) or not bool(torch.isfinite(state.momentum).all()):
            raise AssertionError(f"paper {label}: non-finite parameters or momenta")
        acc[label] = float(accuracy(state.params, Xt, Yt))
        step_us[label] = seconds / PAPER_STEPS * 1e6
        log(f"paper {label}: n {PAPER_N}, f {f}, lr {lr}, {PAPER_STEPS} steps: test accuracy "
            f"{acc[label]:.4f} (the JAX reference on the CPU: {PAPER_REFERENCE[label]:.4f}); "
            f"{PAPER_STEPS / seconds:.1f} steps/s on {smi}")
    paper_gates(acc)
    for label, f, lr, fields in PAPER_RUNS:
        wx, wy = split[f]
        profile_rounds(paper_sim(fields, f, lr, dev), wx, wy, dev, f"paper {label} ({smi})",
                       step_us[label], unit="step")
    return launches, split


def telemetry_phase(dev, split):
    """Phase 10(a) and (b): the simulators with telemetry on."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.mlp import init_mlp
    from repro_torch.telemetry import get_metric

    def checked(label, tele):
        for name, v in tele.items():
            get_metric(name)
            if not np.isfinite(np.asarray(v, dtype=np.float32)).all():
                raise AssertionError(f"{label}: telemetry {name} not finite")

    # (a) ALIE is visible in ByzantineSim's traces (tests/test_telemetry.py)
    n, f = PAPER_N, 5
    wx, wy = split[f]
    launches, hist = {}, {}
    for agg in ("cm", "krum"):
        fields = dict(aggregator=agg, mixing="none", attack="alie",
                      attack_kwargs=(("n", n), ("f", f)), worker_momentum=0.9, delta=f / n)
        sim = paper_sim(fields, f, 0.1, dev, telemetry=True)
        torch.cuda.synchronize()
        reset_launches()
        _, hist[agg] = sim.run(init_mlp(torch.Generator().manual_seed(1), device=dev), wx, wy,
                               15, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        launches[f"telemetry.paper.{agg}+alie"] = counts = dict(LAUNCHES)
        if any(counts.values()):
            raise AssertionError(f"telemetry {agg}+alie: launched {counts}")
        checked(f"telemetry {agg}+alie", hist[agg]["telemetry"])
    cm_dev = hist["cm"]["telemetry"]["cm_worker_dev"][5:]
    scores = hist["krum"]["telemetry"]["krum_scores"][5:]
    mask = hist["cm"]["telemetry"]["byz_mask"][0]
    byz_dev, good_dev = float(cm_dev[:, :f].mean()), float(cm_dev[:, f:].mean())
    byz_s, good_s = float(scores[:, :f].mean()), float(scores[:, f:].mean())
    if cm_dev.shape != (10, n) or not mask[:f].all() or mask[f:].any():
        raise AssertionError(f"telemetry cm+alie: cm_worker_dev {cm_dev.shape}, mask {mask}")
    if not byz_dev < 0.6 * good_dev or not byz_s < good_s:
        raise AssertionError(f"telemetry: ALIE not visible: cm_worker_dev {byz_dev} vs "
                             f"{good_dev}, krum_scores {byz_s} vs {good_s}")
    log(f"check ALIE visible in ByzantineSim telemetry (n {n}, f {f}, steps 6-15): "
        f"cm_worker_dev Byzantine {byz_dev:.4g} < 0.6 x honest {good_dev:.4g}; "
        f"krum_scores Byzantine {byz_s:.4g} < honest {good_s:.4g}")

    # (b) CrossDeviceSim with telemetry on and off from the same draws
    wx, wy, _, _ = slice_task(dev)
    for agg, attack, _ in SLICE_RUNS:
        label, runs = f"{agg}+{attack}", {}
        for telemetry in (False, True):
            sim = slice_sim(agg, attack, dev, telemetry=telemetry)
            torch.cuda.synchronize()
            reset_launches()
            state, hist_ = sim.run(init_mlp(torch.Generator().manual_seed(1), device=dev),
                                   wx, wy, 20, torch.Generator().manual_seed(2))
            torch.cuda.synchronize()
            runs[telemetry] = (state, hist_, dict(LAUNCHES))
        (off, _, c_off), (on, hist_on, c_on) = runs[False], runs[True]
        launches[f"telemetry.slice.{label}"] = c_on
        if c_on != c_off:
            raise AssertionError(f"telemetry {label}: launches on {c_on}, off {c_off}")
        if not all(torch.equal(on.params[k], off.params[k]) for k in off.params):
            raise AssertionError(f"telemetry {label}: parameters differ from telemetry off")
        tele = hist_on["telemetry"]
        checked(f"telemetry {label}", tele)
        log(f"check CrossDeviceSim {label} telemetry on vs off, 20 rounds: launches "
            f"{json.dumps(c_on)} both; parameters equal bit for bit; {len(tele)} metrics "
            f"catalogued and finite ({', '.join(sorted(tele))})")
    return launches


def bigram_batch(gen, V, batch, seq_len, dev):
    """tests/test_system.py's learnable stream: random first tokens, then
    ``next = (3 tok + 7) mod V``; inputs and next-token labels."""
    import torch

    seq = [torch.randint(0, V, (batch, 1), generator=gen)]
    for _ in range(seq_len):
        seq.append((seq[-1] * 3 + 7) % V)
    toks = torch.cat(seq, dim=1).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def smoke_train(dev, n_workers, agg, steps, mesh=None, arch="tinyllama-1.1b"):
    """Phase 11(b) / (c), 12(c): ``make_train_step`` at ``smoke_config``
    width on tests/test_system.py's stream, each step's mix drawn from one
    seeded generator (so every rank and the one-device run see the same
    ones). Returns the parameters, the losses and the launches of each
    step."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = smoke_config(arch)
    byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2, worker_momentum=0.9)
    step_fn, state = make_train_step(cfg, byz, mesh=mesh, lr=SMOKE_LR, n_workers=n_workers,
                                     device=dev)
    params = state["init_params"](torch.Generator().manual_seed(0))
    opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
    gen = torch.Generator().manual_seed(1)
    losses, counts = [], []
    for _ in range(steps):
        batch = bigram_batch(gen, cfg.vocab_size, 8, 64, dev)
        mix = state["aggregator"].mixing_matrix(n_workers, gen, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        params, opt_state, worker_m, metrics = step_fn(params, opt_state, worker_m, mix, batch)
        torch.cuda.synchronize()
        counts.append(dict(LAUNCHES))
        losses.append(float(metrics["loss"]))
    return params, losses, counts


def train_rank(rank, group, device):
    """Phase 11(c), in each rank: the worker-sharded train step over the
    group (this rank's worker only), RFA and CM, ``GROUP_STEPS`` steps."""
    out = {}
    for agg in ("rfa", "cm"):
        params, losses, counts = smoke_train(device, SYNC_RANKS, agg, GROUP_STEPS, mesh=group)
        want = [{k: SYNC_ROUTE[agg].get(k, 0) for k in c} for c in counts]
        if counts != want:
            raise AssertionError(f"rank {rank} train {agg}: launches {counts}, expected {want}")
        out[agg] = dict(params=params, losses=losses, counts=counts)
    return out


def train_full_width(dev, smi, cfg, note: str = ""):
    """Phase 11(a) / 12(b): ``make_train_step`` on ``cfg`` at its full width,
    W = TRAIN_W heterogeneous workers with one TRAIN_S-token sequence each,
    the steps of ``TRAIN_RUNS`` with exact launches, each step's loss,
    device ms by phase and peak memory, the first step of each rule held
    against the plain route, then the RFA steps again under the profiler.
    ``note`` (a depth cut) goes into the log lines. Returns the launch
    totals and the run's state: ``params``, ``worker_m``, ``batch``,
    ``steppers`` and the generator ``gen`` of the mixing matrices."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ByzConfig
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.distributed.packing import packer_for
    from repro_torch.distributed.robust_sync import robust_gradient_sync
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.pairwise_gram import pairwise_gram
    from repro_torch.telemetry import phase_times
    from repro_torch.utils.tree import tree_flatten

    torch.cuda.empty_cache()
    toks = make_token_stream(torch.Generator().manual_seed(11), TRAIN_W, TRAIN_S, 1,
                             cfg.vocab_size, device=dev)[:, 0]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}  # global batch W x S
    steppers = {agg: make_train_step(
        cfg, ByzConfig(aggregator=agg, mixing="bucketing", s=2, worker_momentum=0.9),
        lr=TRAIN_LR, n_workers=TRAIN_W, device=dev) for agg, _ in TRAIN_RUNS}
    state = steppers["rfa"][1]
    params = state["init_params"](torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
    torch.cuda.synchronize()
    if n_params != cfg.param_count():
        raise AssertionError(f"train {cfg.name}: {n_params:,} parameters, the config counts "
                             f"{cfg.param_count():,}")
    width = (f"{cfg.n_experts} experts, top-{cfg.experts_per_token}, d_ff_expert "
             f"{cfg.d_ff_expert}" if cfg.n_experts else f"d_ff {cfg.d_ff}")
    log(f"train: {cfg.name} ({cfg.n_layers} layers{note}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {width}, {cfg.dtype}): {n_params:,} parameters; "
        f"W {TRAIN_W} workers x 1 sequence of {TRAIN_S} tokens (make_token_stream, one law "
        f"each), sgdm lr {TRAIN_LR}, worker momentum 0.9; state on the card "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    gen = torch.Generator().manual_seed(12)
    total = {k: 0 for k in LAUNCHES}
    steps_ms, peaks = [], []
    probe = tree_flatten(params)[0][0].flatten()[:4096].clone()

    def agreement(agg, aggregator, mix):
        """The step's aggregate (kernel route) against the plain route on
        the same worker momenta; the Gram of the packed momenta, kernel
        and ``torch.matmul``, against an fp64 Gram summed in chunks."""
        buf = packer_for(worker_m).pack(worker_m)
        exact = sum(c.double() @ c.double().T for c in buf.split(1 << 26, dim=1))
        diag = torch.diagonal(exact)
        scale = torch.sqrt(torch.outer(diag, diag))
        gram_err = {name: float(((g.double() - exact).abs() / scale).max())
                    for name, g in (("kernel", pairwise_gram(buf)), ("matmul", buf @ buf.T))}
        row_norm = float(torch.sqrt(diag.max()))
        del buf, exact
        got = robust_gradient_sync(worker_m, aggregator, mix=mix)[0]
        k_row = torch.cat([t.reshape(-1) for t in tree_flatten(got)[0]])
        del got
        want = robust_gradient_sync(worker_m, aggregator, mix=mix, use_kernels=False)[0]
        p_row = torch.cat([t.reshape(-1) for t in tree_flatten(want)[0]])
        del want
        comb_err = float(torch.linalg.vector_norm(k_row - p_row)) / row_norm
        del k_row, p_row
        torch.cuda.empty_cache()
        log(f"check train {agg} aggregate, kernel route vs plain route on the same worker "
            f"momenta: |agg_kernel - agg_plain|_2 / max_i |x_i|_2 = {comb_err:.3g} "
            f"(bar {TRAIN_AGG_RTOL}); Gram of the packed momenta against fp64, max "
            f"|G - G64|_ij / sqrt(G64_ii G64_jj): kernel {gram_err['kernel']:.3g} (bar "
            f"{TRAIN_GRAM_RTOL}), torch.matmul {gram_err['matmul']:.3g}")
        if not comb_err <= TRAIN_AGG_RTOL or not gram_err["kernel"] <= TRAIN_GRAM_RTOL:
            raise AssertionError(f"train {agg}: kernel aggregate off the plain route's, or "
                                 "its Gram off the fp64 Gram")

    def one_step(agg, step_fn, aggregator):
        nonlocal params, opt_state, worker_m
        mix = aggregator.mixing_matrix(TRAIN_W, gen, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with phase_times() as ms:
            params, opt_state, worker_m, metrics = step_fn(params, opt_state, worker_m, mix,
                                                          batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peaks.append(torch.cuda.max_memory_allocated())
        counts = dict(LAUNCHES)
        want = {k: TRAIN_ROUTE[agg].get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"train {agg}: launches {counts}, expected {want}")
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"train {agg}: loss {loss}")
        return mix, wall, ms, counts, loss

    for agg, n_steps in TRAIN_RUNS:
        step_fn, st = steppers[agg]
        for i in range(n_steps):
            mix, wall, ms, counts, loss = one_step(agg, step_fn, st["aggregator"])
            for k, v in counts.items():
                total[k] += v
            steps_ms.append(wall)
            fb = ms.get("forward_backward", 0.0)
            split = {k: round(v, 3) for k, v in ms.items()}
            log(f"train {cfg.name} {agg} step {i + 1}: loss {loss:.5f}; host ms {wall:.1f}, "
                f"{TRAIN_W * TRAIN_S / wall * 1e3:.0f} tokens/s; device ms by phase (CUDA "
                f"events) {json.dumps(split)}; forward + backward per worker "
                f"{fb / TRAIN_W:.1f}; launches {json.dumps({k: v for k, v in counts.items() if v})}")
            if i == 0:
                moved = float((tree_flatten(params)[0][0].flatten()[:4096].float()
                               - probe.float()).abs().max())
                if not moved > 0:
                    raise AssertionError(f"train {agg}: the parameters did not move")
                agreement(agg, st["aggregator"], mix)
        if agg == "rfa":
            rfa_ms = statistics.median(steps_ms)
            profile_steps(lambda: one_step("rfa", step_fn, st["aggregator"]),
                          f"train rfa {cfg.name} W{TRAIN_W} S{TRAIN_S} ({smi})",
                          rfa_ms * 1e3, n_steps)
    log(f"train {cfg.name}{note}: host ms per step {', '.join(f'{t:.1f}' for t in steps_ms)} "
        f"(rfa median {rfa_ms:.1f}, {TRAIN_W * TRAIN_S / rfa_ms * 1e3:.0f} tokens/s); peak "
        f"device memory in a step {', '.join(f'{b / 1e9:.2f}' for b in peaks)} GB "
        f"(max_memory_allocated) on {smi}")
    return total, dict(params=params, worker_m=worker_m, batch=batch, steppers=steppers,
                       gen=gen)


def train_phase(dev, smi):
    """Phase 11: LLM training. (a) TinyLlama-1.1B at full width on the
    card; (b) the reference test's run at smoke width; (c) the
    worker-sharded step over 4 ranks. Returns the launch counts by path and
    the kernels' rows at the training shape."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.packing import packer_for
    from repro_torch.kernels import LAUNCHES, ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.cwise_median import cwise_median
    from repro_torch.kernels.pairwise_gram import pairwise_gram
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.utils.tree import tree_flatten

    # (a) full width: W = 4 heterogeneous workers, one sequence each
    total, run = train_full_width(dev, smi, get_config("tinyllama-1.1b"))
    worker_m, steppers, gen = run["worker_m"], run["steppers"], run["gen"]
    del run

    # the kernels at the training shape: X[W, n_pad], the packed momenta
    x = packer_for(worker_m).pack(worker_m)
    del worker_m
    torch.cuda.empty_cache()
    W_, d = x.shape
    kernel_rows = {"bucket_mix": [], "pairwise_gram": [], "cwise_median": []}
    record = functools.partial(measure, kernel_rows)
    mix = steppers["cm"][1]["aggregator"].mixing_matrix(TRAIN_W, gen, device=dev)
    weights = torch.full((1, W_), 1.0 / W_, device=dev)
    timing = (2, 1)  # the plain Gram loops over ~537,000 tiles a call
    for what, M in (("mix", mix), ("combine", weights)):
        m = M.shape[0]
        record("bucket_mix", f"train {what} M[{m},{W_}] X[{W_},{d}]",
               lambda M=M: bucket_mix(M, x), lambda M=M: ref.bucket_mix(M, x),
               lambda M=M: torch.matmul(M, x), (W_ * d + m * W_ + m * d) * 4,
               2 * m * W_ * d, timing, close(1e-5, 1e-4))
    record("pairwise_gram", f"train X[{W_},{d}]", lambda: pairwise_gram(x),
           lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
           (W_ * d + W_ * W_) * 4, W_ * (W_ + 1) * d, timing,
           lambda got, want: torch.testing.assert_close(
               got, want, rtol=0, atol=TRAIN_GRAM_RTOL * float(torch.diagonal(want).max())))
    mixed = bucket_mix(mix, x)
    del x
    torch.cuda.empty_cache()
    record("cwise_median", f"train X[{TRAIN_M},{d}]", lambda: cwise_median(mixed),
           lambda: ref.cwise_median(mixed), lambda: torch.median(mixed, dim=0).values,
           3 * d * 4, selection_ops(TRAIN_M, d), timing, close(0, 0))
    del mixed
    torch.cuda.empty_cache()

    # (b) smoke width, tests/test_system.py's gate, W = 1 and 4
    launches = {"train": total}
    smoke = {}
    for n in (1, TRAIN_W):
        t0 = time.perf_counter()
        params_b, losses, counts = smoke_train(dev, n, "rfa", SMOKE_STEPS)
        sec = time.perf_counter() - t0
        launches[f"train.smoke W{n}"] = {k: sum(c[k] for c in counts) for k in counts[0]}
        if any(c != {k: TRAIN_ROUTE["rfa"].get(k, 0) for k in c} for c in counts):
            raise AssertionError(f"train smoke W{n}: launches {counts}")
        if not all(np.isfinite(losses)) or not losses[-1] < 0.8 * losses[0]:
            raise AssertionError(f"train smoke W{n}: losses {losses[::10]} miss the gate")
        smoke[n] = params_b
        log(f"train smoke W{n} (smoke_config, rfa + bucketing, lr {SMOKE_LR}, "
            f"{SMOKE_STEPS} steps): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(gate < 0.8 x first); {SMOKE_STEPS / sec:.1f} steps/s")

    # (c) the worker-sharded step over 4 ranks on cuda:0, against one device
    t0 = time.perf_counter()
    ranks = spawn_ranks(train_rank, SYNC_RANKS, backend="gloo",
                        devices=["cuda:0"] * SYNC_RANKS, timeout_s=600)
    log(f"train group: {SYNC_RANKS} ranks on cuda:0 under gloo ran in "
        f"{time.perf_counter() - t0:.1f} s, spawn included")
    launches["train_group"] = {k: 0 for k in LAUNCHES}
    for agg in ("rfa", "cm"):
        one_params, one_losses, _ = smoke_train(dev, SYNC_RANKS, agg, GROUP_STEPS)
        one = [t.cpu().numpy() for t in tree_flatten(one_params)[0]]
        first = tree_flatten(ranks[0][agg]["params"])[0]
        err = 0.0
        for rank, r in enumerate(ranks):
            leaves = tree_flatten(r[agg]["params"])[0]
            if not all(np.array_equal(a, b) for a, b in zip(leaves, first)):
                raise AssertionError(f"train group {agg}: rank {rank} differs from rank 0")
            for c in r[agg]["counts"]:
                for k, v in c.items():
                    launches["train_group"][k] += v
        for a, b in zip(first, one):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
            err = max(err, float(np.abs(a - b).max()))
        log(f"check train group {agg}, {GROUP_STEPS} steps: every rank bitwise equal; "
            f"launches per rank and step {json.dumps(SYNC_ROUTE[agg])}; max |group - one "
            f"device| of the parameters {err:.3g} (bar rtol 1e-4, atol 1e-6); losses "
            f"{[round(x, 5) for x in ranks[0][agg]['losses']]} vs one device "
            f"{[round(x, 5) for x in one_losses]}")
    return launches, kernel_rows


def decode_bytes(params, cache, batch: int, vocab: int) -> int:
    """Bytes one decode step must move: every parameter but the embedding
    table read once (a MoE layer's products read every expert's weights),
    ``batch`` embedding rows, the cache read once and the logits written."""
    from repro_torch.utils.tree import tree_flatten

    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])  # noqa: E731
    embed = params["embed"]
    return (nbytes(params) - nbytes(embed) + batch * embed.shape[1] * embed.element_size()
            + nbytes(cache) + batch * vocab * 4)


def moe_routing(params, cfg, batch):
    """Each worker's routing on the trained model: the top-k assignments
    per expert of each MoE layer ([W, n_layers, E], from the router as the
    layer computes it) and the drop fraction per layer, from one forward of
    each worker's rows."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    counts, drops = [], []
    layer = moe_mod.moe_layer

    def recording(p, x, c):
        gates = torch.softmax(x.reshape(-1, c.d_model).float() @ p["router"], dim=-1)
        top = torch.sort(gates, dim=-1, descending=True, stable=True).indices
        counts.append(torch.bincount(top[:, :c.experts_per_token].reshape(-1),
                                     minlength=c.n_experts))
        return layer(p, x, c)

    moe_mod.moe_layer = recording
    try:
        with torch.no_grad():
            for w in range(batch["tokens"].shape[0]):
                _, aux = tfm.forward(params, cfg, batch["tokens"][w:w + 1])
                drops.append(float(aux["moe_drop_frac"]) / cfg.n_layers)
    finally:
        moe_mod.moe_layer = layer
    return torch.stack(counts).reshape(len(drops), cfg.n_layers, cfg.n_experts), drops


def moe_phase(dev, smi):
    """Phase 12: the MoE family. (a) OLMoE-1B-7B served at full width and
    depth; (b) trained at full width, depth cut to MOE_TRAIN_LAYERS; (c)
    the smoke-width gate for OLMoE and one Kimi K2 step (fsdp on one rank,
    server momentum, bf16 optimizer momentum). Returns the launch counts by
    path."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_prefill_step, make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.utils.tree import tree_flatten

    launches = {}
    counted = functools.partial(run_counted, launches)

    # (a) serving at full width and depth
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH)
    V, S = cfg.vocab_size, ATTN_S
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    if not n_params == cfg.param_count() == MOE_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params:,} parameters on the card, the config "
                             f"counts {cfg.param_count():,}, expected {MOE_PARAMS:,}")
    log(f"moe serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token}, d_ff_expert {cfg.d_ff_expert}, "
        f"vocab {V}, {cfg.dtype}): {n_params:,} parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, V, (2, S), device=dev, generator=torch.Generator(dev).manual_seed(1))
    prefill = make_prefill_step(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    logits = counted("moe.serve.prefill", lambda: prefill(params, {"tokens": tokens}))
    if tuple(logits.shape) != (2, 1, V) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"moe prefill: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        _, aux = tfm.forward_hidden(params, cfg, tokens)
    C = expert_capacity(2 * S, cfg)
    log(f"moe serve prefill B2 S{S}: logits [2, 1, {V}] finite; host ms per prefill "
        f"{', '.join(f'{t:.1f}' for t in times)} (median {statistics.median(times):.1f}); "
        f"capacity C = {C}, buffer [{cfg.n_experts}, {C}, {cfg.d_model}]; drop fraction a "
        f"layer {float(aux['moe_drop_frac']) / cfg.n_layers:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    profile_steps(lambda: prefill(params, {"tokens": tokens}), f"moe.serve.prefill B2 S{S}",
                  statistics.median(times) * 1e3, 1, "prefill")
    del logits, aux

    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 97, (6,), generator=rng).tolist()
    prompts = [torch.randint(0, V, (n,), generator=rng).tolist() for n in lens]
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=256, device=dev)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=16))
    t0 = time.perf_counter()
    done = counted("moe.serve.engine", eng.run_until_drained)
    wall = time.perf_counter() - t0
    if sorted(done) != list(range(6)) or any(len(r.output) != 16 for r in done.values()):
        raise AssertionError(f"moe engine: finished {sorted(done)}, outputs "
                             f"{[len(r.output or []) for r in done.values()]}")
    log(f"moe serve engine: 6 requests (prompts {lens}) x 16 new tokens in {eng.steps_total} "
        f"steps, {wall:.2f} s; decode ms per step mean "
        f"{eng.stats()['serve_decode_step_s'] * 1e3:.2f}, median "
        f"{eng.step_timer.summary()['p50_s'] * 1e3:.2f}; {eng.tokens_total / wall:.1f} tokens/s")
    seq = greedy_decode(cfg, params, prompts[0], 16, eng.B, dev)
    if done[0].output != seq:
        raise AssertionError(f"moe engine request 0 {done[0].output} != sequential greedy {seq}")
    one_row = greedy_decode(cfg, params, prompts[0], 16, 1, dev)
    log(f"check moe engine request 0 == sequential greedy decode over decode_step (16 tokens; "
        f"C = {expert_capacity(eng.B, cfg)} >= {eng.B} decode tokens, none dropped); the "
        f"one-row loop agrees on {sum(a == b for a, b in zip(one_row, seq))} of 16")
    busy = ServeEngine(cfg, params, batch_slots=4, max_len=256, device=dev)
    for uid in range(4):
        busy.submit(Request(uid=uid, prompt=prompts[uid][:8], max_new_tokens=200))
    for _ in range(5):
        busy.step()
    t0 = time.perf_counter()
    for _ in range(20):
        busy.step()
    step_us = (time.perf_counter() - t0) / 20 * 1e6
    n_bytes = decode_bytes(params, busy.cache, busy.B, V)
    log(f"moe serve decode, 4 slots busy: {step_us / 1e3:.2f} ms per step, "
        f"{4e6 / step_us:.1f} tokens/s; every expert's weights read each step: "
        f"{n_bytes / 1e9:.2f} GB, bound {n_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms "
        f"(bytes at 3.35 TB/s) on {smi}")
    profile_steps(busy.step, "moe.serve.decode 4 slots", step_us, 20)
    log(f"moe serve: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"since the prefill; launches of our kernels: prefill "
        f"{sum(launches['moe.serve.prefill'].values())}, engine "
        f"{sum(launches['moe.serve.engine'].values())} (none, as in the reference)")
    del busy, eng, params
    torch.cuda.empty_cache()
    for label in ("moe.serve.prefill", "moe.serve.engine"):
        if any(launches[label].values()):
            raise AssertionError(f"{label} launched {launches[label]}; the serving path "
                                 "calls no kernel")

    # (b) training at full width, the depth cut
    cfg_t = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    if cfg_t.param_count() != MOE_TRAIN_PARAMS:
        raise AssertionError(f"{cfg.name} at {MOE_TRAIN_LAYERS} layers: "
                             f"{cfg_t.param_count():,} parameters")
    launches["moe.train"], run = train_full_width(
        dev, smi, cfg_t, note=f" of {cfg.n_layers}: depth cut, full width")
    per, drops = moe_routing(run["params"], cfg_t, run["batch"])
    del run
    torch.cuda.empty_cache()
    starved = (per == 0).any(dim=0).sum(dim=-1).tolist()  # per layer
    log(f"moe train routing after the steps, W {TRAIN_W} workers (one token law each): drop "
        f"fraction a layer per worker {[round(d, 4) for d in drops]}, mean "
        f"{statistics.mean(drops):.4f}; experts that got no token from some worker, per "
        f"layer: {starved} of {cfg.n_experts}; assignments per expert and worker, min "
        f"{int(per.min())} / max {int(per.max())} of {TRAIN_S * cfg.experts_per_token}")

    # (c) smoke width: the reference test's gate for OLMoE; one Kimi K2 step
    t0 = time.perf_counter()
    _, losses, counts = smoke_train(dev, TRAIN_W, "rfa", SMOKE_STEPS, arch=MOE_ARCH)
    sec = time.perf_counter() - t0
    launches["moe.train.smoke"] = {k: sum(c[k] for c in counts) for k in counts[0]}
    if any(c != {k: TRAIN_ROUTE["rfa"].get(k, 0) for k in c} for c in counts):
        raise AssertionError(f"moe train smoke: launches {counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < 0.8 * losses[0]:
        raise AssertionError(f"moe train smoke: losses {losses[::10]} miss the gate")
    log(f"moe train smoke W{TRAIN_W} ({MOE_ARCH} smoke_config, rfa + bucketing, lr "
        f"{SMOKE_LR}, {SMOKE_STEPS} steps): loss {losses[0]:.4f} -> {losses[-1]:.4f} (gate < "
        f"0.8 x first); {SMOKE_STEPS / sec:.1f} steps/s")
    kcfg = smoke_config("kimi-k2-1t-a32b")
    if not (kcfg.fsdp and kcfg.momentum_mode == "server" and kcfg.opt_m_dtype == "bfloat16"):
        raise AssertionError(f"kimi smoke config: {kcfg}")
    gen = torch.Generator().manual_seed(13)
    for agg in ("rfa", "cm"):
        step_fn, state = make_train_step(
            kcfg, ByzConfig(aggregator=agg, mixing="bucketing", s=2, worker_momentum=0.9),
            lr=SMOKE_LR, n_workers=TRAIN_W, device=dev)
        params = state["init_params"](torch.Generator().manual_seed(0))
        opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
        batch = bigram_batch(gen, kcfg.vocab_size, 8, 64, dev)
        mix = state["aggregator"].mixing_matrix(TRAIN_W, gen, device=dev)
        params, opt_state, worker_m, metrics = counted(
            f"moe.kimi {agg}", lambda: step_fn(params, opt_state, worker_m, mix, batch))
        got = launches[f"moe.kimi {agg}"]
        m_dtypes = {t.dtype for t in tree_flatten(opt_state.m)[0]}
        if (got != {k: TRAIN_ROUTE[agg].get(k, 0) for k in got} or worker_m
                or m_dtypes != {torch.bfloat16} or not np.isfinite(float(metrics["loss"]))):
            raise AssertionError(f"kimi smoke {agg}: launches {got}, worker_m "
                                 f"{bool(worker_m)}, m {m_dtypes}, loss {metrics['loss']}")
        log(f"moe kimi smoke step {agg} ({kcfg.name} smoke_config: fsdp on one rank, server "
            f"momentum, bf16 optimizer momentum): loss {float(metrics['loss']):.4f}; launches "
            f"{json.dumps({k: v for k, v in got.items() if v})}")
    return launches


def profile_rounds(sim, wx, wy, dev, label, round_us: float, rounds: int = 20,
                   unit: str = "round") -> None:
    """Profile ``rounds`` rounds (steps) of ``sim`` after 5 warm-up rounds."""
    import torch

    from repro_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(3)
    state = sim.init_state(init_mlp(torch.Generator().manual_seed(1), device=dev))
    for _ in range(5):
        state, _ = sim.step(state, wx, wy, sim.draw(gen, wx.shape[1]))

    def one_round():
        nonlocal state
        state, _ = sim.step(state, wx, wy, sim.draw(gen, wx.shape[1]))

    profile_steps(one_round, label, round_us, rounds, unit)


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
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    ptxas = build_phase()
    results = kernel_phase(dev)
    results.update(norm_kernel_phase(dev))
    launches = slice_phase(dev)
    launches.update(ops_phase(dev))
    launches.update(sync_phase())
    results.update(attention_phase(dev))
    launches.update(serve_phase(dev, results))
    paper, split = paper_phase(dev, smi)
    launches.update(paper)
    launches.update(telemetry_phase(dev, split))
    train, train_rows = train_phase(dev, smi)
    launches.update(train)
    launches.update(moe_phase(dev, smi))
    for name, rows in train_rows.items():
        results[name].extend(rows)

    src = {"bucket_mix": "bucket_mix.cu", "pairwise_gram": "pairwise_gram.cu",
           "cwise_median": "selection.cu", "cwise_trimmed_mean": "selection.cu",
           "residual_norms": "residual_norms.cu", "cclip_fused_iter": "residual_norms.cu",
           "cclip_combine": "cclip.cu", "flash_attention": "flash_attention_wgmma.cu"}
    # flash_attention: the tensor-core kernel (bf16, the main path's rows) and
    # the CUDA-core one (fp32 and the bf16 inputs TMA refuses)
    # bucket_mix, residual_norms, cclip_fused_iter and cclip_combine: every
    # instance's ptxas report (residual_norms_kernel<RC,NSUB,FORM,ALIGNED>:
    # FORM 0 the given centre, 1 the coefficients, 2 the CCLIP update)
    # the selection kernels: each built instance's report (its name gives W
    # and n_trim); each case row gives its block size
    norms = ptxas["residual_norms"]
    other = {"bucket_mix": {"ptxas": ptxas["bucket_mix"]},
             "residual_norms": {"ptxas": {i: r for i, r in norms.items()
                                          if i.split(",")[2] != "2"}},
             "cclip_fused_iter": {"ptxas": {i: r for i, r in norms.items()
                                            if i.split(",")[2] == "2"}},
             "cclip_combine": {"ptxas": ptxas["cclip"]},
             "cwise_median": {"ptxas": ptxas["cwise_median"]},
             "cwise_trimmed_mean": {"ptxas": ptxas["cwise_trimmed_mean"]},
             "flash_attention": {"sources": [
        "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro_torch/kernels/csrc/tma.cuh"], "ptxas": ptxas["flash_attention_wgmma"]},
        # pairwise_gram: one kernel, X staged by TMA (aligned rows, the main
        # path's) or by predicated loads (the per-leaf chain's unaligned leaves)
        "pairwise_gram": {"sources": [
            "src/repro_torch/kernels/csrc/pairwise_gram.cu",
            "src/repro_torch/kernels/csrc/tma.cuh"], "variants": ["gram_tma", "gram_ldg"],
            "ptxas": ptxas["pairwise_gram"]}}
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
            library_ms=main_row["library_ms"], shape=main_row["shape"], cases=rows,
            **other.get(name, {})))
    log(f"chip_smoke: phases 1-12 passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
