"""Serve a model with batched decode requests through the PyTorch port (the
counterpart of ``examples/serve_decode.py``).

Builds the decode cache, prefills it token by token with the prompt (the
same ``decode_step`` the dry-run runs for the decode_32k / long_500k
shapes), then greedy-decodes a continuation for a whole batch of requests.

    PYTHONPATH=src python examples/serve_decode_torch.py --arch mamba2-130m --new-tokens 32
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402


def greedy_tokens(params, cfg, prompts: torch.Tensor, new_tokens: int,
                  device) -> torch.Tensor:
    """The token loop: ``prompts`` ``[B, P]`` (``[B, K, P]`` for codebooks)
    fed one position at a time through ``decode_step``, then ``new_tokens``
    greedy tokens; returns them ``[B, new_tokens]`` (``[B, K, new_tokens]``)."""
    B, P = prompts.shape[0], prompts.shape[-1]
    prompts = prompts.to(device)
    cache = tfm.init_cache(cfg, B, P + new_tokens, device=device)
    t0 = time.time()
    logits = None
    with torch.no_grad():
        for t in range(P):
            logits, cache = tfm.decode_step(params, cfg, cache, prompts[..., t], t)
        print(f"prefill {P} tokens x {B} requests: {time.time() - t0:.2f}s")
        out = []
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        t0 = time.time()
        for t in range(P, P + new_tokens):
            out.append(tok)
            logits, cache = tfm.decode_step(params, cfg, cache, tok, t)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        dt = time.time() - t0
    print(f"decoded {new_tokens} tokens x {B} requests in {dt:.2f}s "
          f"({B * new_tokens / dt:.1f} tok/s)")
    return torch.stack(out, dim=-1)


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = smoke_config(args.arch)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    B = args.batch
    tok_shape = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    prompts = torch.randint(0, cfg.vocab_size, tok_shape + (args.prompt_len,),
                            generator=torch.Generator().manual_seed(args.seed + 1),
                            dtype=torch.int32)
    gen = greedy_tokens(params, cfg, prompts, args.new_tokens, dev)
    print("sample:", gen.reshape(B, -1)[0][:16].tolist())
    return gen


if __name__ == "__main__":
    main()
