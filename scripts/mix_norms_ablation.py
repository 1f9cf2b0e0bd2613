#!/usr/bin/env python3
"""Times of the ``bucket_mix`` and ``residual_norms`` kernels on one CUDA card.

    python3 scripts/mix_norms_ablation.py [--root DIR] [--against FILE] [--variants]

Run from the root of a checkout on a machine with an H100 and ``nvcc``.
At the shapes each kernel runs at (the one-device path, X[10, 106,496]; a
rank's slice of the 4-rank sync, X[10, 26,624] for the mix and
X[5, 26,624] for the norms; the paper's W = 25, X[25, 16,777,216]) it
holds each kernel against its plain version (the reference's tolerances),
times it (a CUDA graph of back-to-back calls, as ``chip_smoke.py``) beside
``torch.matmul(M, X)`` or ``torch.cdist``, twice in turns, and profiles 20
calls with ``torch.profiler`` to count the CUDA kernels a call launches and
split their device time.

Inputs come from seeded generators on the card, so two runs on one card
see the same values. Each ``bucket_mix`` output's SHA-256 is written to
``--out`` (default ``chip_scratch/mix_norms_ablation/<label>.json``, a
directory git ignores);
``--against FILE`` compares this run's digests with a file an earlier run
wrote and fails on any difference: the check that a new ``bucket_mix``
gives the earlier kernel's bits.

``--root DIR`` imports ``repro_torch`` from ``DIR/src`` in place of this
checkout's (another commit unpacked with ``git archive``), so two versions
are compared in one call by running the script once for each, in turns.
``--variants`` also times variants of this checkout's sources made by
editing their text (``EDITS``) or the launch geometry (``GEOMETRY``): the
design choices that were tried. Imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MAIN_D, RANK_D, PAPER_D = 106_496, 26_624, 16_777_216
#: (W, d, (reps, batch)) per kernel; mix rows: bucketing s = 2 and the combine.
#: W = 53 is the paper's largest worker count: m = 27 buckets, and more rows
#: than one register chunk of either kernel holds
MIX_SHAPES = [(10, MAIN_D, (20, 50)), (10, RANK_D, (20, 50)), (25, PAPER_D, (10, 1)),
              (53, PAPER_D, (10, 1))]
NORM_SHAPES = [(5, RANK_D, (20, 50)), (10, MAIN_D, (20, 50)), (25, PAPER_D, (10, 1)),
               (53, PAPER_D, (10, 1))]
#: text variants: kernel -> name -> [(old text, new text)]; each keeps the
#: arithmetic of its kernel (bucket_mix: the same bits)
EDITS = {
    "bucket_mix": {
        # 8 rows of X in flight and two blocks an SM at every MC (but 32),
        # or 16 rows and one block an SM at every MC; 8 rows at MC = 32
        "wb_8": [("#define BM_WB(MC) ((MC) == 16 ? 8 : 16)", "#define BM_WB(MC) 8"),
                 ("#define BM_MIN_BLOCKS(MC) ((MC) == 16 ? 2 : 1)",
                  "#define BM_MIN_BLOCKS(MC) ((MC) == 32 ? 1 : 2)")],
        "wb_16": [("#define BM_WB(MC) ((MC) == 16 ? 8 : 16)", "#define BM_WB(MC) 16"),
                  ("#define BM_MIN_BLOCKS(MC) ((MC) == 16 ? 2 : 1)",
                   "#define BM_MIN_BLOCKS(MC) 1")],
        "mc32_wb8": [("#define BM_WB(MC) ((MC) == 16 ? 8 : 16)",
                      "#define BM_WB(MC) ((MC) >= 16 ? 8 : 16)")],
        # no 32-row chunk: m = 17 .. 32 in two passes of 16 rows
        "mc_16": [("    if (m <= 16) return bm_launch<16>", "    return bm_launch<16>")],
        # the combine (MC = 1): all of W = 25 in one batch, or 8 rows and
        # three blocks an SM; and streaming (evict-first) loads of X
        "mc1_wb32": [("#define BM_WB(MC) ((MC) == 16 ? 8 : 16)",
                      "#define BM_WB(MC) ((MC) == 16 ? 8 : (MC) == 1 ? 32 : 16)")],
        "mc1_wb8": [("#define BM_WB(MC) ((MC) == 16 ? 8 : 16)",
                     "#define BM_WB(MC) ((MC) == 16 || (MC) == 1 ? 8 : 16)"),
                    ("#define BM_MIN_BLOCKS(MC) ((MC) == 16 ? 2 : 1)",
                     "#define BM_MIN_BLOCKS(MC) ((MC) == 16 ? 2 : (MC) == 1 ? 3 : 1)")],
        "ldcs": [("return __ldg(reinterpret_cast<const float4*>(row + c0));",
                  "return __ldcs(reinterpret_cast<const float4*>(row + c0));")],
    },
    "residual_norms": {
        # 32 rows a chunk at every W (one block an SM)
        "rc_32": [("    if (W <= 8) {\n", "    if (false) {\n"),
                  ("    } else if (W <= 16) {\n", "    } else if (false) {\n")],
        # the coefficient form above 32 rows in passes of 32 rows, each
        # streaming all W rows again for its centre
        "pass_32": [("    } else if (W <= 32 || !coeffs) {\n", "    } else if (true) {\n")],
        # above 32 rows: the pass's rows read again 32 at a time (spills), or
        # 16 rows in flight while the centre streams
        "sub_32": [("        rn_launch<16, 4, true>(RN_ARGS);", "        rn_launch<32, 2, true>(RN_ARGS);")],
        "wb_16": [("#define RN_WB 8 ", "#define RN_WB 16 ")],
        # the ticket as a fence by each writer, a relaxed atomicAdd and a
        # fence in the folding block, in place of one acquire-release add
        "fenced": [("stride] = s;\n", "stride] = s;\n        __threadfence();\n"),
                   ("s_last = rn_draw(ticket) == ", "s_last = atomicAdd(ticket, 1u) == "),
                   ("    if (!s_last) return;\n",
                    "    if (!s_last) return;\n    __threadfence();\n")],
        # timed only: no block folds (the last one sets the ticket back), or
        # no ticket at all: the partial sums alone
        "no_fold": [("    if (!s_last) return;\n",
                     "    if (s_last && threadIdx.x == 0) *ticket = 0u;\n    return;\n")],
        "no_ticket": [("    // the fold: the block that draws the last ticket adds the partials\n",
                       "    return;\n")],
    },
}
TIMED_ONLY = {"no_fold", "no_ticket"}
#: variants applied to the wrappers: name -> kernel.
#: bucket_mix: 256 threads a block at every d (not fitted to the card), or
#: 64 (the previous kernel's 256 columns a block);
#: residual_norms: threads fitted to the card as bucket_mix's (more, smaller
#: blocks at small d), half the blocks (longer ranges, fewer partials), or
#: a counter zeroed by a fill node before every call
GEOMETRY = {"threads_256": "bucket_mix", "threads_64": "bucket_mix",
            "fitted_threads": "residual_norms", "blocks_half": "residual_norms",
            "memset": "residual_norms"}
#: a text variant under a wrapper variant: name -> (EDITS name, GEOMETRY name)
COMBINED = {"mc1_wb32_t64": ("mc1_wb32", "threads_64")}


def variant_source(base: str, edits) -> str:
    for old, new in edits:
        if old not in base:
            raise RuntimeError(f"edit does not apply: {old!r}")
        base = base.replace(old, new)
    return base


def profile_kernels(fn, calls: int = 20):
    """Device microseconds and launches per call of each CUDA kernel ``fn``
    launches (memsets included)."""
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


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--out", type=Path, default=None,
                        help="where the bucket_mix digests go (JSON)")
    parser.add_argument("--against", type=Path, default=None,
                        help="digests of an earlier run that this run must equal")
    parser.add_argument("--variants", action="store_true",
                        help="also time the variants in EDITS and GEOMETRY")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mix_norms_ablation: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound_ms, close, ptxas_resources, time_ms
    from repro_torch.core.mixing import Bucketing
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bucket_mix as bm
    from repro_torch.kernels import weiszfeld_norms as wn

    label = "as_is" if args.root.resolve() == ROOT else args.root.name
    out_path = args.out or ROOT / "chip_scratch" / "mix_norms_ablation" / f"{label}.json"
    mods = {"bucket_mix": bm, "residual_norms": wn}
    # kernel -> variant -> (library loader or None, GEOMETRY name or None)
    runs = {"bucket_mix": {label: (None, None)}, "residual_norms": {label: (None, None)}}
    base_libs = {k: m._lib for k, m in mods.items()}
    if args.variants:
        for kernel, edits in EDITS.items():
            (name, base), = mods[kernel].sources()
            texts = {n: variant_source(base, e) for n, e in edits.items()}
            _build.build_all([(f"{kernel}_ablation_{n}", t) for n, t in texts.items()])
            for n, text in texts.items():
                runs[kernel][n] = (lambda n=n, text=text, kernel=kernel: _build.load(
                    f"{kernel}_ablation_{n}", text, mods[kernel]._ARGS), None)
                res = ptxas_resources(_build.build_log(f"{kernel}_ablation_{n}", text))
                print(f"{kernel} {n}: ptxas " + "; ".join(
                    f"{i} {r['registers']} registers, spills {r['spill_stores']}/"
                    f"{r['spill_loads']} B" for i, r in res.items()), flush=True)
        for n, kernel in GEOMETRY.items():
            runs[kernel][n] = (None, n)
        for n, (edit, geo) in COMBINED.items():
            kernel = GEOMETRY[geo]
            runs[kernel][n] = (runs[kernel][edit][0], geo)
    for kernel, m in mods.items():
        m._lib()
        (name, text), = m.sources()
        res = ptxas_resources(_build.build_log(name, text))
        print(f"{kernel} {label}: ptxas " + "; ".join(
            f"{i} {r['registers']} registers, spills {r['spill_stores']}/{r['spill_loads']} B"
            for i, r in res.items()), flush=True)

    # the parent tree has neither (its kernels fix their own geometry)
    fitted, geometry = getattr(_build, "fitted_threads", None), getattr(wn, "geometry", None)
    ticket = getattr(wn, "_ticket", None)

    def use(kernel, how):
        """Point the wrappers at a variant ((None, None): the checkout as it is)."""
        loader, geo = how
        mods[kernel]._lib = loader or base_libs[kernel]
        if fitted is not None:
            _build.fitted_threads = fitted
            wn.geometry = geometry
        if ticket is not None:
            wn._ticket = ticket
        if geo == "threads_256":
            _build.fitted_threads = lambda n_groups, n_sm: 256
        elif geo == "threads_64":
            _build.fitted_threads = lambda n_groups, n_sm: 64
        elif geo == "memset":
            wn._ticket = lambda device, stream: torch.zeros(1, dtype=torch.int32,
                                                            device=device)
        elif geo == "fitted_threads":
            def fitted_geometry(W, d, n_sm):
                n_vec = -(-d // 4)
                t = fitted(n_vec, n_sm)
                return t, min(-(-n_vec // t), n_sm * (2 if W <= 8 else 1))
            wn.geometry = fitted_geometry
        elif geo == "blocks_half":
            def halved(W, d, n_sm):
                t, b = geometry(W, d, n_sm)
                return t, -(-b // 2)
            wn.geometry = halved

    dev = torch.device("cuda")
    digests, failed = {}, []
    cases = []
    for W, d, timing in MIX_SHAPES:
        gen = torch.Generator(dev).manual_seed(W + d)
        x = torch.randn((W, d), device=dev, generator=gen)
        perm = torch.randperm(W, generator=torch.Generator().manual_seed(W))
        w = torch.rand((1, W), device=dev, generator=gen)
        for what, M in (("mix", Bucketing(2).matrix(W, perm=perm, device=dev)),
                        ("combine", w / w.sum())):
            rows = M.shape[0]
            cases.append(dict(
                kernel="bucket_mix", shape=f"{what} M[{rows},{W}] X[{W},{d}]", timing=timing,
                call=lambda M=M, x=x: bm.bucket_mix(M, x),
                plain=lambda M=M, x=x: ref.bucket_mix(M, x),
                library=lambda M=M, x=x: torch.matmul(M, x), check=close(1e-5, 1e-4),
                bound=bound_ms((W * d + rows * W + rows * d) * 4, 2 * rows * W * d)))
    for W, d, timing in NORM_SHAPES:
        gen = torch.Generator(dev).manual_seed(100 + W + d)
        x = torch.randn((W, d), device=dev, generator=gen)
        c = torch.softmax(torch.randn(W, device=dev, generator=gen), 0)
        v = x.mean(0)
        cases.append(dict(
            kernel="residual_norms", shape=f"coeffs X[{W},{d}]", timing=timing,
            call=lambda x=x, c=c: wn.residual_norms(x, c),
            plain=lambda x=x, c=c: ref.residual_norms(x, c), library=None,
            check=close(1e-4, 1e-3), bound=bound_ms((W * d + 2 * W) * 4, 5 * W * d)))
        cases.append(dict(
            kernel="residual_norms", shape=f"center X[{W},{d}]", timing=timing,
            call=lambda x=x, v=v: wn.residual_norms(x, center=v),
            plain=lambda x=x, v=v: ref.residual_norms(x, center=v),
            library=lambda x=x, v=v: torch.cdist(x, v[None, :]), check=close(1e-4, 1e-3),
            bound=bound_ms((W * d + d + W) * 4, 3 * W * d)))
    for case in cases:
        kernel, shape = case["kernel"], case["shape"]
        want = case["plain"]()
        for n, how in runs[kernel].items():
            if n in TIMED_ONLY:
                continue
            use(kernel, how)
            got = case["call"]()
            case["check"](got, want)
            if not torch.equal(got, case["call"]()):
                raise AssertionError(f"{kernel} {n} [{shape}] is not bitwise repeatable")
            if kernel == "bucket_mix":
                digests.setdefault(n, {})[shape] = digest(got)
        del want
        times = {n: [] for n in runs[kernel]}
        times["library"] = []
        for _ in range(2):
            for n, how in runs[kernel].items():
                use(kernel, how)
                times[n].append(time_ms(case["call"], *case["timing"]))
            if case["library"] is not None:
                times["library"].append(time_ms(case["library"], *case["timing"]))
        b_ms, b_by = case["bound"]
        print(f"time {kernel} [{shape}] (ms, two turns; bound {b_ms:.6f} {b_by}): " + "; ".join(
            f"{n} {t[0]:.6f} {t[1]:.6f}" for n, t in times.items() if t), flush=True)
        for n, how in runs[kernel].items():
            use(kernel, how)
            split = profile_kernels(case["call"])
            print(f"profile {kernel} {n} [{shape}] (device us, launches per call): " + "; ".join(
                f"{k[:60]} {us:.3f} x{cnt:g}" for k, (us, cnt) in split.items()), flush=True)
        use(kernel, (None, None))
    for n, d in digests.items():
        if n != label and d != digests[label]:
            failed.append(f"variant {n} gives other bucket_mix bits than {label}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(digests[label], indent=1))
    print(f"bucket_mix digests of {label} -> {out_path}", flush=True)
    if args.against is not None:
        earlier = json.loads(args.against.read_text())
        same = [k for k in earlier if earlier[k] == digests[label].get(k)]
        print(f"bucket_mix bits against {args.against}: {len(same)} of {len(earlier)} shapes "
              "equal", flush=True)
        if len(same) != len(earlier):
            failed.append(f"bucket_mix bits differ from {args.against} at "
                          f"{sorted(set(earlier) - set(same))}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for f in failed:
        print(f"FAIL {f}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
