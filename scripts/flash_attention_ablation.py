#!/usr/bin/env python3
"""Ablations of the tensor-core attention kernel on one CUDA card.

    python3 scripts/flash_attention_ablation.py

Run from the root of a checkout on a machine with an H100 and ``nvcc``.
Builds ``src/repro_torch/kernels/csrc/flash_attention_wgmma.cu`` as it is
and variants made by editing its text, each into its own library:

- ``one_bf16_p``: P rounded to bf16 once (no P_lo product). Faster, and
  outside the port's bf16 tolerance: timed to price the split, never used.
- ``exp2f``: the library ``exp2f`` in place of the MUFU ``ex2.approx``.
- ``one_consumer_dh256``: one consumer warpgroup (64-row tiles, 256
  threads, no setmaxnreg, up to 255 registers) at dh = 256.

Prints each variant's ``ptxas`` registers and spills, its elements out of
the bf16 tolerance (rtol 1.6e-2, atol 1e-5) against the plain version on
three small shapes, and its device time at the four full-size bf16 rows of
``chip_smoke.py`` (B = 1, S = 4096 at the three configs' heads; B = 2 at
TinyLlama's), all variants in turns, twice, beside
``scaled_dot_product_attention``. Imports no JAX.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EDITS = {
    "as_is": [],
    "one_bf16_p": [("                    Wgmma<DH>::rs(o, pl[kt], dv, 1);\n", "")],
    "exp2f": [("corr[r] = fw_exp2(", "corr[r] = exp2f("),
              ("const float p = fw_exp2(", "const float p = exp2f(")],
    "one_consumer_dh256": [("static constexpr int NC = 2;",
                            "static constexpr int NC = DH == 256 ? 1 : 2;")],
}
ROWS = [(1, 32, 4, 64), (1, 40, 8, 128), (1, 16, 16, 256), (2, 32, 4, 64)]  # B, H, KV, dh
S = 4096


def variant_source(base: str, edits) -> str:
    for old, new in edits:
        if old not in base:
            raise RuntimeError(f"edit does not apply: {old!r}")
        base = base.replace(old, new)
    return base


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_attention_ablation: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_resources, time_ms
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    base = fa._text("wgmma")
    texts = {name: variant_source(base, edits) for name, edits in EDITS.items()}
    _build.build_all([(f"fa_ablation_{n}", t) for n, t in texts.items()])
    libs = {}
    for name, text in texts.items():
        res = ptxas_resources(_build.build_log(f"fa_ablation_{name}", text), "DH")
        print(f"{name}: ptxas " + "; ".join(
            f"{inst} {r['registers']} registers, spills {r['spill_stores']}/{r['spill_loads']} B"
            for inst, r in res.items()), flush=True)
        libs[name] = _build.load(f"fa_ablation_{name}", text, fa._ARGS["wgmma"])
    dev = torch.device("cuda")

    def qkv(B, Sq, H, KV, dh):
        gen = torch.Generator(dev).manual_seed(Sq + H + dh)
        return [torch.randn(shape, device=dev, generator=gen).bfloat16()
                for shape in ((B, Sq, H, dh), (B, Sq, KV, dh), (B, Sq, KV, dh))]

    def launcher(lib, q, k, v):
        B, Sq, H, dh = q.shape
        out = torch.empty_like(q)

        def call():
            code = lib.flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sq, H,
                k.shape[2], dh, 1, 0, 0, dh ** -0.5 * math.log2(math.e),
                _build.stream_of(q))
            _build.check_launch("flash_attention_wgmma", code)
            return out
        return call

    for name, lib in libs.items():
        for B, H, KV, dh in [(1, 8, 2, 64), (1, 8, 2, 128), (1, 8, 8, 256)]:
            q, k, v = qkv(B, 512, H, KV, dh)
            got, want = launcher(lib, q, k, v)().float(), ref.attention(q, k, v).float()
            bad = int(((got - want).abs() > 1e-5 + 1.6e-2 * want.abs()).sum())
            print(f"{name} B{B} S512 H{H} KV{KV} dh{dh}: {bad} of {got.numel()} elements "
                  f"out of the bf16 tolerance", flush=True)
    for B, H, KV, dh in ROWS:
        q, k, v = qkv(B, S, H, KV, dh)
        calls = {name: launcher(lib, q, k, v) for name, lib in libs.items()}
        times = {name: [] for name in calls}
        for _ in range(2):
            for name, call in calls.items():
                times[name].append(time_ms(call, 5, 2))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True), 5, 2)
        print(f"time B{B} S{S} H{H} KV{KV} dh{dh} (ms, two turns): " + "; ".join(
            f"{n} {t[0]:.4f} {t[1]:.4f}" for n, t in times.items()) + f"; sdpa {sdpa:.4f}",
            flush=True)
        del q, k, v, calls
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
