"""Dropped MoE assignments of the port and of the JAX reference on the same
parameters and tokens: one OLMoE-1B-7B layer at full width (64 experts,
top-8, d_model 2048, bf16) on the CPU.

The reference draws the parameters of a 1-layer OLMoE (``init_params``,
PRNGKey 0); the port gets them through ``convert.params_from_jax``. The MoE
input is the first layer's: the embedding of random tokens, attention and
the second norm (the reference's functions, once), so both layers route
the same bf16 rows. For each token count (one training worker's 1024
tokens; the prefill's 2 x 4096) both ``moe_layer`` calls report their drop
fraction; the script prints the dropped assignments, the capacity and the
experts that got no token, for each package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/moe_drop_count.py [--seed 0]
"""

import argparse
import dataclasses
import os
import sys


def main(argv=None):
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro import configs as rconfigs
    from repro.models import moe as rmoe
    from repro.models import transformer as rtfm
    from repro.models.layers import rmsnorm
    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    from repro_torch.models import moe

    rcfg = dataclasses.replace(rconfigs.get_config("olmoe-1b-7b"), n_layers=1)
    cfg = dataclasses.replace(configs.get_config("olmoe-1b-7b"), n_layers=1)
    params = rtfm.init_params(rcfg, jax.random.PRNGKey(args.seed))
    lp = jax.tree_util.tree_map(lambda x: x[0], params["blocks"]["0"])
    ff = params_from_jax(jax.tree_util.tree_map(np.asarray, lp["ff"]), device="cpu")
    E, K = cfg.n_experts, cfg.experts_per_token
    rng = np.random.default_rng(args.seed + 1)
    for B, S in ((1, 1024), (2, 4096)):
        toks = jnp.asarray(rng.integers(0, rcfg.vocab_size, (B, S)))
        h = rtfm.embed_tokens(params, rcfg, toks)
        h = h + rtfm.attn_mod.attention(lp["mixer"], rmsnorm(lp["norm1"], h, rcfg.norm_eps),
                                        rcfg, jnp.arange(S)[None, :])
        x = rmsnorm(lp["norm2"], h, rcfg.norm_eps)
        T = B * S
        _, raux = rmoe.moe_layer(lp["ff"], x, rcfg)
        tx = params_from_jax(np.asarray(x), device="cpu")
        with torch.no_grad():
            _, aux = moe.moe_layer(ff, tx, cfg)
        gates = torch.softmax(tx.reshape(T, -1).float() @ ff["router"], dim=-1)
        top = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :K]
        load = torch.bincount(top.reshape(-1), minlength=E)
        rgates = jax.nn.softmax(x.reshape(T, -1).astype(jnp.float32) @ lp["ff"]["router"], -1)
        rload = np.bincount(np.asarray(jax.lax.top_k(rgates, K)[1]).ravel(), minlength=E)
        C = moe.expert_capacity(T, cfg)
        for name, frac, ld in (("port", float(aux["moe_drop_frac"]), load.numpy()),
                               ("reference", float(raux["moe_drop_frac"]), rload)):
            print(f"olmoe-1b-7b layer 0, T = {B} x {S}, C = {C}: {name} drops "
                  f"{round(frac * T * K)} of {T * K} assignments ({frac:.4f}); experts with "
                  f"no token {int((ld == 0).sum())}; busiest expert {int(ld.max())} "
                  f"assignments", flush=True)
        print(f"  loads equal: {bool(np.array_equal(load.numpy(), rload))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
