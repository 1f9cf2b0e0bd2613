"""Hand-written Hopper kernels: the robust-aggregation hot spots and the
causal GQA attention of the LLM stack.

Each kernel module holds a wrapper that launches a CUDA C++ kernel from
``csrc/`` on a CUDA tensor, and uses the plain PyTorch version in ``ref.py``
only for a tensor on the CPU. Sources are built at first use
(``_build.py``); ``ops.py`` is the API the packed engine calls.

``LAUNCHES`` counts, per kernel, the launches of its CUDA kernel: each
wrapper adds one where it launches and nowhere else, so a run can show
that it went through the kernels. ``VARIANT_LAUNCHES`` splits the
``flash_attention`` count by the CUDA kernel that ran: ``wgmma`` (the
tensor-core kernel for bf16) or ``simt`` (the CUDA-core kernel); and the
``pairwise_gram`` count by how the kernel staged its input: ``gram_tma``
(a TMA tensor map of X's type, fp32 or 16-bit) or ``gram_ldg``
(predicated loads).

``CALLS`` counts, per kernel, the calls of its wrapper on any device, the
plain version's included: on the CPU, where no kernel launches, it shows
which kernels a route reached (the static-analysis gate's kernel-presence
rule reads it there, ``repro_torch.analysis.op_trace``). Counting changes
nothing a wrapper computes.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "bucket_mix": 0,
    "pairwise_gram": 0,
    "cwise_median": 0,
    "cwise_trimmed_mean": 0,
    "residual_norms": 0,
    "cclip_fused_iter": 0,
    "cclip_combine": 0,
    "flash_attention": 0,
}
VARIANT_LAUNCHES: Dict[str, int] = {"wgmma": 0, "simt": 0, "gram_tma": 0, "gram_ldg": 0}
CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES, CALLS):
        for name in counts:
            counts[name] = 0
