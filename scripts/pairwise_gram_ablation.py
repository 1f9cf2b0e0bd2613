#!/usr/bin/env python3
"""Times of the ``pairwise_gram`` kernel on one CUDA card, phase by phase.

    python3 scripts/pairwise_gram_ablation.py [--root DIR] [--variants]

Run from the root of a checkout on a machine with an H100 and ``nvcc``.
At the three shapes the Gram runs at (X[10, 106,496], the one-device path;
X[10, 26,624], a rank's slice in the 4-rank sync; X[25, 16,777,216], the
paper's W) it holds the kernel against its plain version
(``1e-3 + 1e-5 |X||X|^T``), times it (CUDA graph of back-to-back calls, as
``chip_smoke.py``) beside ``torch.matmul(x, x.T)`` in turns, and profiles
20 calls with ``torch.profiler`` to split the device time by CUDA kernel
(the partial sums and the fold, where they are apart).

``--root DIR`` imports ``repro_torch`` from ``DIR/src`` in place of this
checkout's (another commit unpacked with ``git archive``), so two versions
are compared in one call by running the script once for each, in turns.
``--variants`` also builds variants of this checkout's
``csrc/pairwise_gram.cu`` made by editing its text (``EDITS``) and times
each against the source as it is: ring depth 2 and 8, one cluster size for
every W (4, 2 or 1 CTAs a unit), one unit per cluster barrier, 8 or 32
pairs a folding CTA, and no fold (timed only: the fold's share of the call
is the difference). Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(10, 106_496, (20, 50)), (10, 26_624, (20, 50)), (25, 16_777_216, (10, 1))]
#: variants of csrc/pairwise_gram.cu: name -> [(old text, new text)]. Each
#: keeps its own fixed order (another cluster size sums a unit in another
#: order, so it is held to the tolerance, not to the kernel's bits).
_CS = "static constexpr int CS = L == 32 ? 4 : 2;"
EDITS = {
    "ring_2": [("#define GR_STAGES 4 ", "#define GR_STAGES 2 ")],
    "ring_8": [("#define GR_STAGES 4 ", "#define GR_STAGES 8 ")],
    "cluster_4": [(_CS, "static constexpr int CS = 4;")],
    "cluster_2": [(_CS, "static constexpr int CS = 2;")],
    "cluster_1": [(_CS, "static constexpr int CS = 1;"),
                  ("static constexpr int MAXE = 32 / L;", "static constexpr int MAXE = 64 / L;")],
    "group_1": [("#define GR_GROUP_MAX 8 ", "#define GR_GROUP_MAX 1 ")],
    "fold_8": [("#define GR_FOLD_PAIRS 4 ", "#define GR_FOLD_PAIRS 8 ")],
    "fold_32": [("#define GR_FOLD_PAIRS 4 ", "#define GR_FOLD_PAIRS 32 ")],
    # no CTA folds: G is left unwritten. Timed only, for the partial phase
    # alone (the fold's share of the call is the difference)
    "no_fold": [("    if (s_fold < 0) return;", "    return;")],
}
TIMED_ONLY = {"no_fold"}


def variant_source(base: str, edits) -> str:
    for old, new in edits:
        if old not in base:
            raise RuntimeError(f"edit does not apply: {old!r}")
        base = base.replace(old, new)
    return base


def profile_kernels(fn, calls: int = 20):
    """Device microseconds per call of each CUDA kernel ``fn`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--variants", action="store_true",
                        help="also time the text variants in EDITS")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pairwise_gram_ablation: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound_ms, ptxas_resources, time_ms
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import pairwise_gram as pg

    label = "as_is" if args.root.resolve() == ROOT else str(args.root)
    (name, base), = pg.sources()
    libs = {label: pg._lib}
    if args.variants:
        texts = {n: variant_source(base, e) for n, e in EDITS.items()}
        _build.build_all([(f"gram_ablation_{n}", t) for n, t in texts.items()])
        for n, text in texts.items():
            libs[n] = (lambda n=n, text=text: _build.load(f"gram_ablation_{n}", text,
                                                          pg._ARGS))
    pg._lib()
    for n, lib in libs.items():
        text = base if n == label else texts[n]
        res = ptxas_resources(_build.build_log(name if n == label else f"gram_ablation_{n}",
                                               text), "L")
        print(f"{n}: ptxas " + "; ".join(
            f"{inst} {r['registers']} registers, spills {r['spill_stores']}/{r['spill_loads']} B"
            for inst, r in res.items()), flush=True)
    dev = torch.device("cuda")
    for W, d, timing in SHAPES:
        x = torch.randn((W, d), device=dev, generator=torch.Generator(dev).manual_seed(W))
        scale = x.abs() @ x.abs().T
        want = ref.pairwise_gram(x)
        b_ms, b_by = bound_ms((W * d + W * W) * 4, W * (W + 1) * d)
        times = {n: [] for n in libs}
        times["matmul"] = []
        for n, lib in libs.items():
            if n in TIMED_ONLY:
                continue
            pg._lib = lib
            excess = float(((pg.pairwise_gram(x) - want).abs() - 1e-3 - 1e-5 * scale).max())
            print(f"{n} X[{W},{d}]: error beyond 1e-3 + 1e-5 |X||X|^T: "
                  f"{max(excess, 0.0):.3g}", flush=True)
            if excess > 0:
                raise AssertionError(f"{n}: pairwise_gram out of tolerance at X[{W},{d}]")
        for _ in range(2):
            for n, lib in libs.items():
                pg._lib = lib
                times[n].append(time_ms(lambda: pg.pairwise_gram(x), *timing))
            times["matmul"].append(time_ms(lambda: torch.matmul(x, x.T), *timing))
        print(f"time X[{W},{d}] (ms, two turns; bound {b_ms:.6f} {b_by}): " + "; ".join(
            f"{n} {t[0]:.6f} {t[1]:.6f}" for n, t in times.items()), flush=True)
        for n, lib in libs.items():
            pg._lib = lib
            split = profile_kernels(lambda: pg.pairwise_gram(x))
            print(f"profile {n} X[{W},{d}] (device us per call): " + "; ".join(
                f"{k[:60]} {v:.3f}" for k, v in split.items()), flush=True)
        pg._lib = libs[label]
        del x, scale, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
