#!/usr/bin/env python3
"""Times of the ``bucket_mix``, ``residual_norms`` and ``cclip_fused_iter``
kernels on one CUDA card.

    python3 scripts/mix_norms_ablation.py [--root DIR] [--against FILE] [--variants]
                                          [--kernels NAME ...]

Run from the root of a checkout on a machine with an H100 and ``nvcc``.
At the shapes each kernel runs at (the one-device path, X[10, 106,496]; a
rank's slice of the 4-rank sync, X[10, 26,624] for the mix and
X[5, 26,624] for the norms and the fused CCLIP iteration; the paper's
W = 25 and 53, X[25 / 53, 16,777,216]; the norms and CCLIP also at W = 65
and 128, X[W, 106,496]) it holds each kernel against its plain version
(the reference's tolerances; the v' of ``cclip_fused_iter`` bit for bit
against ``cclip_combine``), times it (a CUDA graph of back-to-back calls,
as ``chip_smoke.py``) beside ``torch.matmul(M, X)`` or ``torch.cdist``,
twice in turns, and profiles 20 calls with ``torch.profiler`` to count the
CUDA kernels a call launches and split their device time.

Inputs come from seeded generators on the card, so two runs on one card
see the same values. The SHA-256 of each ``bucket_mix`` output, of both
``residual_norms`` forms' and of the v' of ``cclip_fused_iter`` is written
to ``--out`` (default ``chip_scratch/mix_norms_ablation/<label>.json``, a
directory git ignores); ``--against FILE`` compares this run's digests with
a file an earlier run wrote and fails on any difference: the check that a
new kernel gives the earlier kernel's bits. (The norms of
``cclip_fused_iter`` are summed in another order than its earlier
kernel's, so they are held to the plain version, not to earlier bits.) A
variant must give the bits of the checkout as it is for ``bucket_mix`` and
for v'.

``--root DIR`` imports ``repro_torch`` from ``DIR/src`` in place of this
checkout's (another commit unpacked with ``git archive``), so two versions
are compared in one call by running the script once for each, in turns.
``--variants`` also times variants of this checkout's sources made by
editing their text (``EDITS``) or the launch geometry (``GEOMETRY``): the
design choices that were tried. ``--kernels`` keeps the named kernels
only. Imports no JAX.
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
               (53, PAPER_D, (10, 1)), (65, MAIN_D, (20, 20)), (128, MAIN_D, (20, 20))]
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
        "ldcs": [("return __ldg(reinterpret_cast<const float4*>(p));",
                  "return __ldcs(reinterpret_cast<const float4*>(p));")],
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
        "sub_32": [("        rn_launch<16, 4, RN_COEFF>(RN_ARGS);",
                    "        rn_launch<32, 2, RN_COEFF>(RN_ARGS);")],
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
#: variants of the CLIP form (cclip_fused_iter), edits of the same source
EDITS["cclip_fused_iter"] = {
    # 17 .. 32 rows: the update streamed RN_WB rows at a time, then the rows
    # read again from the caches for the norms (not held in registers)
    "stream_32": [("    const bool held = (COEFF || CLIP) && NSUB == 1 && W <= RC;",
                   "    const bool held = (COEFF || (CLIP && RC < 32)) && NSUB == 1 && W <= RC;")],
    # the reciprocal of W by rcp.rn (the same value as the IEEE division,
    # without its slow-path call)
    "rcp": [("    if constexpr (CLIP) inv = 1.0f / (float)W;",
             "    if constexpr (CLIP) inv = __frcp_rn((float)W);")],
    # each chunk's row addresses computed row by row (as the other forms),
    # or stepped by d in every form and instance
    "row_index": [("    constexpr bool STEP_ROWS = CLIP && ALIGNED && NSUB == 1;",
                   "    constexpr bool STEP_ROWS = false;")],
    "row_step": [("    constexpr bool STEP_ROWS = CLIP && ALIGNED && NSUB == 1;",
                  "    constexpr bool STEP_ROWS = true;")],
    # lam for the held update read where it is used (a volatile load, not
    # kept in registers across column groups)
    "lam_ld": [("        if (r < W) rn_clip_fma4(u, __ldg(lam + r), x[r], v);",
                """        if (r < W) {
            float l;
            asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(l) : "l"(lam + r));
            rn_clip_fma4(u, l, x[r], v);
        }""")],
    # above 32 rows: the pass's 16-row chunks read again last streamed
    # first (the rows most likely still in L1), or passes of 32 rows read
    # again 32 at a time (<32, 2>), or passes of 32 or 16 rows (<32, 1>,
    # <16, 1>), later passes reading back v'
    "sub_reverse": [("            for (int s = 0; s < NSUB; ++s) {  // RC rows at a time",
                     "            for (int s = NSUB - 1; s >= 0; --s) {  // RC rows at a time")],
    "sub_32": [("    else rn_launch<16, 4, RN_CLIP>(RN_CLIP_ARGS);",
                "    else rn_launch<32, 2, RN_CLIP>(RN_CLIP_ARGS);")],
    "pass_32": [("    else rn_launch<16, 4, RN_CLIP>(RN_CLIP_ARGS);",
                 "    else rn_launch<32, 1, RN_CLIP>(RN_CLIP_ARGS);")],
    "pass_16": [("    else rn_launch<16, 4, RN_CLIP>(RN_CLIP_ARGS);",
                 "    else rn_launch<16, 1, RN_CLIP>(RN_CLIP_ARGS);")],
    # the held update one column at a time (one chain in flight, not four)
    "by_column": [("""    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
        if (r < W) rn_clip_fma4(u, __ldg(lam + r), x[r], v);
    }
    return rn_clip_apply(v, u, inv);""", """    float vn[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float u = 0.0f;
#pragma unroll
        for (int r = 0; r < RC; ++r) {
            if (r < W) {
                const float xk = k == 0 ? x[r].x : k == 1 ? x[r].y : k == 2 ? x[r].z : x[r].w;
                u = fmaf(__ldg(lam + r), xk - vn[k], u);
            }
        }
        vn[k] = vn[k] + u * inv;
    }
    return make_float4(vn[0], vn[1], vn[2], vn[3]);""")],
}
# edits of residual_norms' code that the CLIP form runs too
EDITS["cclip_fused_iter"].update({n: EDITS["residual_norms"][n] for n in ("wb_16", "fenced")})
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
    parser.add_argument("--kernels", nargs="+", default=None,
                        help="time only these kernels (bucket_mix, residual_norms, "
                             "cclip_fused_iter)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mix_norms_ablation: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound_ms, close, profile_kernels, ptxas_resources, time_ms
    from repro_torch.core.mixing import Bucketing
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bucket_mix as bm
    from repro_torch.kernels import cclip_fused as cf
    from repro_torch.kernels import weiszfeld_norms as wn
    from repro_torch.kernels.cclip_combine import cclip_combine

    label = "as_is" if args.root.resolve() == ROOT else args.root.name
    out_path = args.out or ROOT / "chip_scratch" / "mix_norms_ablation" / f"{label}.json"
    # the module whose library each kernel launches: cclip_fused_iter is the
    # CLIP form of the residual_norms library (in an older tree, its own)
    mods = {"bucket_mix": bm, "residual_norms": wn,
            "cclip_fused_iter": wn if cf.sources() == wn.sources() else cf}
    kept = set(args.kernels or mods)
    # kernel -> variant -> (library loader or None, GEOMETRY name or None)
    runs = {kernel: {label: (None, None)} for kernel in mods}
    base_libs = {k: m._lib for k, m in mods.items()}
    if args.variants:
        for kernel, edits in EDITS.items():
            if kernel not in kept:
                continue
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
            runs[kernel][n] = (None, n)  # (cases of kernels not kept do not run)
        for n, (edit, geo) in COMBINED.items():
            kernel = GEOMETRY[geo]
            if kernel in kept:
                runs[kernel][n] = (runs[kernel][edit][0], geo)
    for kernel, m in mods.items():
        if kernel == "cclip_fused_iter" and m is wn:
            continue  # residual_norms' library, printed above
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

    def equal(a, b):
        if isinstance(a, tuple):
            return all(equal(x, y) for x, y in zip(a, b))
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

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
                bound=bound_ms((W * d + rows * W + rows * d) * 4, 2 * rows * W * d),
                bits=lambda got: got, across=True))
    for W, d, timing in NORM_SHAPES:
        gen = torch.Generator(dev).manual_seed(100 + W + d)
        x = torch.randn((W, d), device=dev, generator=gen)
        c = torch.softmax(torch.randn(W, device=dev, generator=gen), 0)
        v = x.mean(0)
        # the clip weights of a CCLIP iteration: about half the rows clipped
        norms = torch.sqrt(ref.residual_norms(x, center=v))
        lam = torch.clamp(0.5 * norms.median() / norms, max=1.0)
        cases.append(dict(
            kernel="residual_norms", shape=f"coeffs X[{W},{d}]", timing=timing,
            call=lambda x=x, c=c: wn.residual_norms(x, c),
            plain=lambda x=x, c=c: ref.residual_norms(x, c), library=None,
            check=close(1e-4, 1e-3), bound=bound_ms((W * d + 2 * W) * 4, 5 * W * d),
            bits=lambda got: got, across=False))
        cases.append(dict(
            kernel="residual_norms", shape=f"center X[{W},{d}]", timing=timing,
            call=lambda x=x, v=v: wn.residual_norms(x, center=v),
            plain=lambda x=x, v=v: ref.residual_norms(x, center=v),
            library=lambda x=x, v=v: torch.cdist(x, v[None, :]), check=close(1e-4, 1e-3),
            bound=bound_ms((W * d + d + W) * 4, 3 * W * d), bits=lambda got: got,
            across=False))

        def clip_check(got, want, x=x, v=v, lam=lam):
            close(1e-5, 1e-4)(got[0], want[0])
            close(1e-4, 1e-3)(got[1], want[1])
            if not equal(got[0], cclip_combine(x, v, lam)):
                raise AssertionError("cclip_fused_iter: v' differs from cclip_combine's")
        cases.append(dict(
            kernel="cclip_fused_iter", shape=f"X[{W},{d}]", timing=timing,
            call=lambda x=x, v=v, lam=lam: cf.cclip_fused_iter(x, v, lam),
            plain=lambda x=x, v=v, lam=lam: ref.cclip_fused_iter(x, v, lam), library=None,
            check=clip_check, bound=bound_ms((W * d + 2 * d + 2 * W) * 4, 6 * W * d),
            bits=lambda got: got[0], across=True))
        del norms
    for case in [c for c in cases if c["kernel"] in kept]:
        kernel, shape = case["kernel"], case["shape"]
        want = case["plain"]()
        for n, how in runs[kernel].items():
            if n in TIMED_ONLY:
                continue
            use(kernel, how)
            got = case["call"]()
            case["check"](got, want)
            if not equal(got, case["call"]()):
                raise AssertionError(f"{kernel} {n} [{shape}] is not bitwise repeatable")
            if n == label or case["across"]:
                digests.setdefault(n, {})[f"{kernel} {shape}"] = digest(case["bits"](got))
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
        differ = sorted(k for k in d if d[k] != digests[label][k])
        if n != label and differ:
            failed.append(f"variant {n} gives other bits than {label} at {differ}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(digests[label], indent=1))
    print(f"digests of {label} -> {out_path}", flush=True)
    if args.against is not None:
        earlier = json.loads(args.against.read_text())
        same = [k for k in earlier if earlier[k] == digests[label].get(k)]
        print(f"bits against {args.against}: {len(same)} of {len(earlier)} outputs equal",
              flush=True)
        if len(same) != len(earlier):
            failed.append(f"bits differ from {args.against} at "
                          f"{sorted(set(earlier) - set(same))}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for f in failed:
        print(f"FAIL {f}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
