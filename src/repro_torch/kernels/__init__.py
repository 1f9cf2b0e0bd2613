"""Hand-written Hopper kernels for the robust-aggregation hot spots.

Each kernel module holds a wrapper that launches a CUDA C++ kernel from
``csrc/`` on a CUDA tensor, and uses the plain PyTorch version in ``ref.py``
only for a tensor on the CPU. Sources are built at first use
(``_build.py``); ``ops.py`` is the API the packed engine calls.

``LAUNCHES`` counts, per kernel, the launches of its CUDA kernel: each
wrapper adds one where it launches and nowhere else, so a run can show
that it went through the kernels.
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
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
