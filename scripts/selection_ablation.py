#!/usr/bin/env python3
"""Times of the selection kernels (``cwise_median``, ``cwise_trimmed_mean``)
on one CUDA card.

    python3 scripts/selection_ablation.py [--root DIR] [--out FILE] [--against FILE]
                                          [--variants] [--rates] [--sass]

Run from the root of a checkout on a machine with an H100 and ``nvcc``.
At ``chip_smoke.SELECTION_SHAPES`` (the one-device path X[5, 106,496] with
n_trim 1 and 2; a rank's slice of the 4-rank sync, X[5, 26,624]; the
paper's n = 25 and n = 53 in buckets, X[13 / 27, 16,777,216] with n_trim 5;
X[65 / 128, 106,496] with n_trim W // 4) it holds each kernel bit for bit
against its plain version, on random values and on the same values with
``chip_smoke.plant_specials``' NaN, signed-zero and infinite columns, and on
both in a view whose rows start 4 bytes off a 16-byte boundary. It times
the kernel (a CUDA graph of back-to-back calls, as ``chip_smoke.py``) beside
``torch.median(dim=0)`` or ``torch.sort`` and the band's mean, twice in
turns, and profiles 20 calls with ``torch.profiler`` to count the CUDA
kernels a call launches. Bounds: ``repro_torch.kernels.cost.selection_ops``.

Inputs come from seeded generators on the card, so two runs on one card
see the same values. Every output's SHA-256 is written to ``--out``
(default ``chip_scratch/selection_ablation/<label>.json``, a directory git
ignores); ``--against FILE`` compares this run's digests with a file an
earlier run wrote and fails on any difference: the check that new kernels
give an earlier tree's bits.

``--root DIR`` imports ``repro_torch`` from ``DIR/src`` in place of this
checkout's (another commit unpacked with ``git archive``), so two versions
are compared in one call by running the script once for each, in turns.
``--variants`` also times this checkout's kernels in other blocks or with
their source text edited (``VARIANTS``): the design choices that were
tried. ``--rates`` measures the card's fp32 min / max and add rates with
long unrolled loops of independent operations (``RATE_SOURCE``), the rates
behind ``chip_smoke.PEAK_MINMAX_PER_S`` / ``PEAK_FADD_PER_S``; ``--sass``
counts each built library's machine instructions by opcode (``cuobjdump``).
The time of a W = 1, d = 4 median (one thread loads and stores 16 bytes)
is printed as the floor of a launch in a CUDA graph. Imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: name -> ([(old text, new text)], the W it applies to, threads a block or
#: None for the wrapper's); each keeps the kernels' arithmetic (the same
#: bits) but those in TIMED_ONLY
VARIANTS = {
    # the other side of the block-size rule: 64 threads up to 32 rows, 256
    # above
    "t64": ([], lambda W: W <= 32, 64),
    "t256": ([], lambda W: W > 32, 256),
    # every comparator NaN-aware (the previous kernel's instruction count)
    "nan_always": ([("    if (nan) {\n", "    if (true) {\n")], lambda W: True, None),
    # timed only: every thread reads the first 128 columns (loads from the
    # caches)
    "hot_loads": ([("v[w] = __ldg(xs + (long long)w * d + col);",
                    "v[w] = __ldg(xs + (long long)w * d + (col & 127));")],
                  lambda W: W > 32, None),
}
TIMED_ONLY = {"hot_loads"}
#: fp32 min / max and add rates: every thread runs rounds of 64 min / max
#: (an odd-even transposition round over 32 registers, 31 compare-exchanges,
#: and two more) or of 32 adds (32 independent chains)
RATE_SOURCE = r"""
#include <cuda_runtime.h>

template <bool MINMAX>
__global__ void __launch_bounds__(256) rate_kernel(float* out, int iters, float inc) {
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = (float)((threadIdx.x * 37 + k * 101) % 97);
    for (int it = 0; it < iters; ++it) {
        if constexpr (MINMAX) {
#pragma unroll
            for (int k = 0; k < 32; k += 2) {
                const float lo = fminf(v[k], v[k + 1]), hi = fmaxf(v[k], v[k + 1]);
                v[k] = lo;
                v[k + 1] = hi;
            }
#pragma unroll
            for (int k = 1; k < 31; k += 2) {
                const float lo = fminf(v[k], v[k + 1]), hi = fmaxf(v[k], v[k + 1]);
                v[k] = lo;
                v[k + 1] = hi;
            }
            v[0] = fminf(v[0], v[31]);
            v[31] = fmaxf(v[31], inc);
        } else {
#pragma unroll
            for (int k = 0; k < 32; ++k) v[k] = __fadd_rn(v[k], inc);
        }
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k) s = __fadd_rn(s, v[k]);
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int rate_launch(int minmax, float* out, int iters, int blocks, int threads,
                           cudaStream_t stream) {
    if (minmax) {
        rate_kernel<true><<<blocks, threads, 0, stream>>>(out, iters, 0.5f);
    } else {
        rate_kernel<false><<<blocks, threads, 0, stream>>>(out, iters, 0.5f);
    }
    return (int)cudaGetLastError();
}
"""
RATE_OPS = {1: 64, 0: 32}  # operations a thread a round


def measure_rates(torch, _build, n_sm: int) -> None:
    """Print the fp32 min / max and add rates the card sustains, at 8 and
    at 32 warps an SM."""
    import ctypes

    lib = _build.load("selection_rates", RATE_SOURCE, {"rate_launch": (
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p)})
    iters = 4096
    for warps in (8, 32):
        blocks, threads = n_sm * warps // 8, 256
        out = torch.empty(blocks * threads, device="cuda")
        for minmax, what in ((1, "min/max"), (0, "add")):
            def run():
                code = lib.rate_launch(minmax, out.data_ptr(), iters, blocks, threads,
                                       torch.cuda.current_stream().cuda_stream)
                _build.check_launch("rate_kernel", code)
            run()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                run()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3 / 10
            rate = blocks * threads * iters * RATE_OPS[minmax] / seconds
            print(f"rate fp32 {what}, {warps} warps an SM: {rate:.4e} /s = "
                  f"{rate / n_sm / 1.98e9:.1f} a clock an SM at 1.98 GHz", flush=True)


def run_variant(cm, kernel, lib, threads, xs):
    """``cm.select`` of a variant's library, in blocks of ``threads`` (None:
    the wrapper's choice)."""
    rule = cm.threads_for
    if threads is not None:
        cm.threads_for = lambda W, d, n_sm: threads
    try:
        return cm.select(kernel, lib, xs)
    finally:
        cm.threads_for = rule


def sass_counts(lib_path) -> str:
    """Machine instructions of each kernel in a built library, by opcode."""
    import collections
    import re

    cuda = Path("/usr/local/cuda/bin/cuobjdump")
    tool = str(cuda) if cuda.exists() else "cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300).stdout
    out, counts, fn = [], None, None
    for line in text.splitlines() + ["Function : end"]:
        head = re.search(r"Function : (\S+)", line)
        if head:
            if counts:
                total = sum(counts.values())
                out.append(f"{fn} {total} instructions: " + ", ".join(
                    f"{op} {n}" for op, n in counts.most_common(10)))
            fn, counts = head.group(1), collections.Counter()
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op and counts is not None:
            counts[op.group(1).split(".")[0]] += 1
    return "; ".join(out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--out", type=Path, default=None,
                        help="where the digests go (JSON)")
    parser.add_argument("--against", type=Path, default=None,
                        help="digests of an earlier run that this run must equal")
    parser.add_argument("--variants", action="store_true",
                        help="also time the variants in VARIANTS")
    parser.add_argument("--rates", action="store_true",
                        help="measure the card's fp32 min / max and add rates")
    parser.add_argument("--sass", action="store_true",
                        help="count each library's machine instructions by opcode")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("selection_ablation: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "scripts"))
    from chip_smoke import (PEAK_BYTES_PER_S, PEAK_MINMAX_PER_S, SELECTION_SHAPES, bound_ms,
                            plant_specials, profile_kernels, ptxas_resources, same_bits,
                            time_ms)
    # the bounds' counts from this checkout's kernels/cost.py, loaded by path:
    # a --root tree (the parent) may predate it
    spec = importlib.util.spec_from_file_location(
        "kernel_cost", ROOT / "src" / "repro_torch" / "kernels" / "cost.py")
    kernel_cost = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kernel_cost)
    selection_ops = kernel_cost.selection_ops
    from mix_norms_ablation import digest
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import cwise_median as cm
    from repro_torch.kernels import trimmed_mean as tm

    label = "as_is" if args.root.resolve() == ROOT else args.root.name
    out_path = args.out or ROOT / "chip_scratch" / "selection_ablation" / f"{label}.json"
    dev = torch.device("cuda")

    def source(W, b):
        """(name, text) of the library for the median (``b`` None) or TM."""
        return (cm.sources(W) if b is None else tm.sources(W, b))[0]

    # (W, n_trim or None for the median) of every case, and its libraries
    cases = [(W, b) for W, _, trims, _ in SELECTION_SHAPES for b in (None, *trims)]
    built = {case: source(*case) for case in cases}
    variants = {}  # (W, b) -> {variant: (name, text, threads)}
    if args.variants:
        for W, b in cases:
            for vname, (edits, applies, threads) in VARIANTS.items():
                if not applies(W):
                    continue
                name, text = source(W, b)
                for old, new in edits:
                    if old not in text:
                        raise RuntimeError(f"variant {vname}: edit does not apply: {old!r}")
                    text = text.replace(old, new)
                variants.setdefault((W, b), {})[vname] = (
                    f"{name}_{vname}" if edits else name, text, threads)
    floor = cm.sources(1)[0]
    libs = list(dict.fromkeys([*built.values(), floor] + [
        (n, t) for vs in variants.values() for n, t, _ in vs.values()]))
    seconds = _build.build_all(libs)
    print(f"{label}: built in {seconds:.1f} s", flush=True)
    for name, text in libs:
        res = ptxas_resources(_build.build_log(name, text))
        print(f"ptxas {name}: " + "; ".join(
            f"{i} {r['registers']} registers, spills {r['spill_stores']}/{r['spill_loads']} B"
            for i, r in res.items()), flush=True)
        if args.sass:
            print(f"sass {name}: {sass_counts(_build.library_path(name, text))}", flush=True)
    if args.rates:
        measure_rates(torch, _build, torch.cuda.get_device_properties(0).multi_processor_count)
    one = torch.randn((1, 4), device=dev)
    print(f"time floor: a W = 1, d = 4 median in a CUDA graph "
          f"{time_ms(lambda: cm.cwise_median(one), 20, 50):.6f} ms", flush=True)

    digests, failed = {}, []
    for W, d, trims, timing in SELECTION_SHAPES:
        x = torch.randn((W, d), device=dev, generator=torch.Generator(dev).manual_seed(W + d))
        special = plant_specials(x)
        buf = torch.empty(W * d + 1, device=dev)
        off = buf[1:].view(W, d)
        for b in (None, *trims):
            shape = f"X[{W},{d}]" + ("" if b is None else f" b={b}")
            kernel = "cwise_median" if b is None else "cwise_trimmed_mean"

            def call(xs, b=b):
                return cm.cwise_median(xs) if b is None else tm.cwise_trimmed_mean(xs, b)

            def plain(xs, b=b):
                return ref.cwise_median(xs) if b is None else ref.cwise_trimmed_mean(xs, b)

            runs = {label: call}
            for vname, (name, text, threads) in variants.get((W, b), {}).items():
                lib = _build.load(name, text, cm.SELECT_ARGS)
                runs[vname] = functools.partial(run_variant, cm, kernel, lib, threads)
            for what, inp in (("random", x), ("specials", special)):
                want = plain(inp)
                off.copy_(inp)
                for n, run in runs.items():
                    if n in TIMED_ONLY:
                        continue
                    for rows, xs in (("aligned", inp), ("offset", off)):
                        got = run(xs)
                        if not same_bits(got, want):
                            failed.append(f"{n} [{shape} {what} {rows}] differs from the "
                                          "plain version")
                        if n == label:
                            digests[f"{shape} {what} {rows}"] = digest(got)
                del want
            if b is None:
                library = lambda: torch.median(x, dim=0).values  # noqa: E731
            else:
                library = lambda b=b: torch.sort(x, dim=0).values[b:W - b].mean(dim=0)  # noqa: E731
            times = {n: [] for n in runs}
            times["library"] = []
            for _ in range(2):
                for n, run in runs.items():
                    times[n].append(time_ms(lambda run=run: run(x), *timing))
                times["library"].append(time_ms(library, *timing))
            n_bytes, n_ops = (W + 1) * d * 4, selection_ops(W, d, b)
            b_ms, b_by = bound_ms(n_bytes, n_ops, PEAK_MINMAX_PER_S)
            print(f"time {kernel} [{shape}] (ms, two turns; bound {b_ms:.6f} {b_by}, bytes "
                  f"{n_bytes / PEAK_BYTES_PER_S * 1e3:.6f}, ops "
                  f"{n_ops / PEAK_MINMAX_PER_S * 1e3:.6f}): " + "; ".join(
                      f"{n} {t[0]:.6f} {t[1]:.6f}" for n, t in times.items()), flush=True)
            split = profile_kernels(lambda: call(x))
            print(f"profile {kernel} {label} [{shape}] (device us, launches per call): "
                  + "; ".join(f"{k[:60]} {us:.3f} x{cnt:g}" for k, (us, cnt) in split.items()),
                  flush=True)
            # one kernel, once a call (the profiler may drop a record of 20)
            if len(split) != 1 or not 0.9 <= sum(cnt for _, cnt in split.values()) <= 1:
                failed.append(f"{kernel} [{shape}] launches {split}, not one kernel a call")
        del x, special, buf, off
        torch.cuda.empty_cache()

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(digests, indent=1))
    print(f"selection digests of {label} ({len(digests)} outputs) -> {out_path}", flush=True)
    if args.against is not None:
        earlier = json.loads(args.against.read_text())
        same = [k for k in earlier if earlier[k] == digests.get(k)]
        print(f"selection bits against {args.against}: {len(same)} of {len(earlier)} outputs "
              "equal", flush=True)
        if len(same) != len(earlier) or set(earlier) != set(digests):
            failed.append(f"bits differ from {args.against} at "
                          f"{sorted(set(earlier) ^ set(same))}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for f in failed:
        print(f"FAIL {f}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
