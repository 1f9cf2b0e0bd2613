#!/usr/bin/env python3
"""Times of the ``pairwise_gram`` kernel on one CUDA card, phase by phase.

    python3 scripts/pairwise_gram_ablation.py [--root DIR] [--variants]
                                              [--dtype {fp32,bf16,fp16}] [--shapes path,...]

Run from the root of a checkout on a machine with an H100 and ``nvcc``.
At the shapes the Gram runs at (``SHAPES``: X[10, 106,496], the one-device
path; X[10, 26,624], a rank's slice in the 4-rank sync; X[25, 16,777,216],
the paper's W; X[4, n_pad], TinyLlama-1.1B's packed training buffer; and
TinyLlama-1.1B's 12 leaves at W = 4, chained through ``acc`` as the
per-leaf engine calls it) it holds the kernel on rows of ``--dtype`` to the
bits of the same rows staged by predicated loads (copies one element off
16-byte alignment: ``gram_ldg``) and, for a 16-bit X, to the bits of the
fp32 call on ``X.float()``; up to X[25, 16,777,216] also to the plain
version (``1e-3 + 1e-5 |X||X|^T``). A variant that sums in another order
is held to that tolerance: around the plain version up to X[25,
16,777,216], around the fp32 call above. Then it times, in turns, the kernel
(``gram_tma``), the predicated loads on the offset copies, the fp32 kernel
on ``X.float()`` and ``torch.matmul`` on it (CUDA graph of back-to-back
calls, as ``chip_smoke.py``), and profiles 20 calls of each with
``torch.profiler`` to split the device time by CUDA kernel.

``--root DIR`` imports ``repro_torch`` from ``DIR/src`` in place of this
checkout's (another commit unpacked with ``git archive``), so two versions
are compared in one call by running the script once for each, in turns.
``--variants`` also builds variants of this checkout's
``csrc/pairwise_gram.cu`` made by editing its text (``EDITS``) and times
each against the source as it is: ring depth 2 and 8 (in fp32 stages), one
cluster size for every W (4, 2 or 1 CTAs a unit), one unit per cluster
barrier, 8 or 32 pairs a folding CTA, and, timed only,
no fold (the partial phase alone: staging, products and the cluster sums;
the fold's share of the call is the difference) and no products either
(the staging and the reductions: the consumers release each stage
unread). ``--root`` and ``--variants`` do not go together: the edits are
this checkout's. Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_PAD = 1_100_048_384  # TinyLlama-1.1B's packed width (chip_smoke.train_n_pad)
#: name -> (W, d, (reps, batch) of time_ms); d None: TinyLlama-1.1B's leaves
#: (``leaf_widths``), the Gram chained over them through ``acc``
SHAPES = {"path": (10, 106_496, (20, 50)), "rank": (10, 26_624, (20, 50)),
          "paper": (25, 16_777_216, (10, 1)), "n_pad": (4, N_PAD, (3, 2)),
          "leaves": (4, None, (3, 2))}
DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}
#: variants of csrc/pairwise_gram.cu: name -> [(old text, new text)]. Each
#: keeps its own fixed order (another cluster size sums a unit in another
#: order, so it is held to the tolerance, not to the kernel's bits).
_CS = "static constexpr int CS = L == 32 ? 4 : 2;"
_NO_FOLD = ("    if (s_fold < 0) return;", "    return;")
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
    "no_fold": [_NO_FOLD],
    # the consumers release each stage unread, and no fold. Timed only
    "no_products": [_NO_FOLD, ("                if (active) {\n                    const xt* ra",
                               "                if (active && W < 0) {\n"
                               "                    const xt* ra")],
}
TIMED_ONLY = {"no_fold", "no_products"}
ORDER_CHANGING = {"cluster_4", "cluster_2", "cluster_1"}


def leaf_widths():
    """Columns of each of TinyLlama-1.1B's parameter leaves: the per-leaf
    engine's Gram calls on its tree, in the tree's order."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_flatten

    specs = tree_flatten(tfm.params_shape(get_config("tinyllama-1.1b")))[0]
    return [math.prod(s.shape) for s in specs if math.prod(s.shape)]


def abs_gram(xs, chunk: int = 1 << 24):
    """|X||X|^T of the row blocks ``xs`` side by side, in column chunks
    (the Gram's tolerance scale without a copy of X's size)."""
    total = 0.0
    for x in xs:
        for c in x.split(chunk, dim=1):
            a = c.abs()
            total = total + a @ a.T
    return total


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
    parser.add_argument("--dtype", choices=list(DTYPES), default="fp32",
                        help="element type of the rows X")
    parser.add_argument("--shapes", default=",".join(SHAPES),
                        help="comma-separated names of SHAPES to run")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pairwise_gram_ablation: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound_ms, offset_copy, ptxas_resources, same_bits, time_ms
    from repro_torch.kernels import VARIANT_LAUNCHES, _build, cost, ref
    from repro_torch.kernels import pairwise_gram as pg

    dtype = getattr(torch, DTYPES[args.dtype])
    label = "as_is" if args.root.resolve() == ROOT else str(args.root)
    (name, base), = pg.sources(dtype)
    lib_of = pg._lib  # the wrapper's libraries, one per dtype
    libs = {label: lib_of(dtype)}
    texts = {}
    if args.variants:
        texts = {n: variant_source(base, e) for n, e in EDITS.items()}
        _build.build_all([(f"gram_ablation_{n}", t) for n, t in texts.items()])
        for n, text in texts.items():
            libs[n] = _build.load(f"gram_ablation_{n}", text, pg._ARGS)
    lib_of(torch.float32)
    for n in libs:
        res = ptxas_resources(_build.build_log(name if n == label else f"gram_ablation_{n}",
                                               base if n == label else texts[n]), "L")
        print(f"{n} [{args.dtype}]: ptxas " + "; ".join(
            f"{inst} {r['registers']} registers, spills {r['spill_stores']}/{r['spill_loads']} B"
            for inst, r in res.items()), flush=True)

    def use(n):
        """Route the wrapper's ``dtype`` calls to library ``n``."""
        pg._lib = lambda dt, lib=libs[n]: lib if dt == dtype else lib_of(dt)

    def gram(xs):
        """The chain of ``pg.pairwise_gram`` calls over the row blocks ``xs``
        (each seeded with the previous result, as the per-leaf engine's
        ``tree_gram``) and the variants it ran."""
        before, acc = dict(VARIANT_LAUNCHES), None
        for x in xs:
            acc = pg.pairwise_gram(x, acc)
        return acc, sorted(k for k in ("gram_tma", "gram_ldg") if VARIANT_LAUNCHES[k] > before[k])

    dev = torch.device("cuda")
    for shape in args.shapes.split(","):
        W, d, timing = SHAPES[shape]
        widths = leaf_widths() if d is None else [d]
        gen = torch.Generator(dev).manual_seed(W)
        xs = [torch.randn((W, n), device=dev, generator=gen, dtype=dtype) for n in widths]
        d = sum(widths)
        what = f"X[{W},{d}]" + (f" as {len(xs)} leaves" if len(xs) > 1 else "")
        xs_ldg = [offset_copy(x) for x in xs]
        xs32 = xs if dtype == torch.float32 else [x.float() for x in xs]
        use(label)
        want, ran32 = gram(xs32)
        ldg, ran_ldg = gram(xs_ldg)
        if ran32 != ["gram_tma"] or ran_ldg != ["gram_ldg"] or not same_bits(ldg, want):
            raise AssertionError(f"{what}: fp32 {ran32}, offset copies {ran_ldg}, or "
                                 "the predicated loads differ from the fp32 TMA call")
        small = len(xs) == 1 and d <= 16_777_216
        scale = abs_gram(xs32)
        # the plain version where it fits, else the fp32 call
        plain = ref.pairwise_gram(xs32[0]) if small else want

        def excess(g):
            """How far ``g`` is off ``plain`` beyond the Gram's tolerance."""
            return max(float(((g - plain).abs() - 1e-3 - 1e-5 * scale).max()), 0.0)

        if excess(want) > 0:
            raise AssertionError(f"{what}: off the plain version by {excess(want):.3g} "
                                 "beyond 1e-3 + 1e-5 |X||X|^T")
        c = cost.pairwise_gram(W, d, xs[0].element_size())
        b_ms, b_by = bound_ms(c.bytes, c.ops)
        for n in libs:
            if n in TIMED_ONLY:
                continue
            use(n)
            got, ran = gram(xs)
            bits = same_bits(got, want)
            print(f"{n} [{args.dtype}] {what}: ran {ran}; the bits of the fp32 TMA call "
                  f"and of the predicated loads: {bits}; beyond the tolerance: "
                  f"{excess(got):.3g}", flush=True)
            # another cluster size sums a unit in another order: held to the
            # tolerance; every other variant keeps the kernel's bits
            if not (bits or (n in ORDER_CHANGING and excess(got) == 0)):
                raise AssertionError(f"{n}: pairwise_gram wrong at {what}")
            del got
        del scale, plain
        routes = {f"tma {args.dtype}": (label, xs),
                  f"ldg {args.dtype} (offset copy)": (label, xs_ldg)}
        if dtype != torch.float32:
            routes["tma fp32 on X.float()"] = (label, xs32)
        routes.update({n: (n, xs) for n in libs if n != label})
        times = {n: [] for n in list(routes) + ["matmul fp32"]}
        for _ in range(2):
            for n in times:
                if n in routes:
                    use(routes[n][0])
                    times[n].append(time_ms(lambda: gram(routes[n][1]), *timing))
                else:
                    times[n].append(time_ms(lambda: [torch.matmul(x, x.T) for x in xs32],
                                            *timing))
        print(f"time [{args.dtype}] {what} (ms, two turns; bound {b_ms:.6f} {b_by}, "
              f"{label}): " + "; ".join(f"{n} {t[0]:.6f} {t[1]:.6f}" for n, t in times.items()),
              flush=True)
        for n, (lib, rows) in routes.items():
            if n.startswith("tma fp32"):
                continue
            use(lib)
            split = profile_kernels(lambda: gram(rows))
            print(f"profile {n} [{args.dtype}] {what} (device us per call): " + "; ".join(
                f"{k[:60]} {v:.3f}" for k, v in split.items()), flush=True)
        use(label)
        del xs, xs_ldg, xs32, want, ldg
        torch.cuda.empty_cache()
    pg._lib = lib_of
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
