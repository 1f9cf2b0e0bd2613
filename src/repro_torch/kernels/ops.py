"""The reference's kernel API names, re-exported from the kernel wrappers.

  gram(xs, acc=None)        stats phase for Krum / RFA / CCLIP / ACClip / mean
  cm_aggregate(xs)          coordinate-wise median
  tm_aggregate(xs, n_trim)  coordinate-wise trimmed mean (sorted band)
  mix_apply(M, xs)          bucketing / resampling application, final combine

Each wrapper takes a tensor on the CPU to its plain PyTorch version and a
CUDA tensor to its CUDA kernel, or raises. Single device: the multi-device
counterparts (``shard_kernels``) belong to a later slice.
"""

from repro_torch.kernels.bucket_mix import bucket_mix as mix_apply
from repro_torch.kernels.cwise_median import cwise_median as cm_aggregate
from repro_torch.kernels.pairwise_gram import pairwise_gram as gram
from repro_torch.kernels.trimmed_mean import cwise_trimmed_mean as tm_aggregate

__all__ = ["gram", "cm_aggregate", "tm_aggregate", "mix_apply"]
