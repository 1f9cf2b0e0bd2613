"""The port's ServeEngine held against the reference's, token for token.

Both engines serve the same requests on the same parameters (the
reference's, carried across by ``convert.params_from_jax``; fp32 on the
CPU): the tokens must be identical, as must each one be to a sequential
single-request greedy decode (the reference's bar, tests/test_serving.py),
through slot reuse and mixed-position cohorts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as rsmoke_config
from repro.models import transformer as rtfm
from repro.serving import Request as RRequest
from repro.serving import ServeEngine as RServeEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serving import Request, ServeEngine


@pytest.fixture(scope="module")
def setup():
    rcfg = rsmoke_config("tinyllama-1.1b")
    rparams = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return smoke_config("tinyllama-1.1b"), params, rcfg, rparams


def reference_decode(cfg, params, prompt, max_new):
    """Sequential single-request greedy decode (B=1) over the port's decode_step."""
    cache = tfm.init_cache(cfg, 1, 256, device="cpu")
    out = []
    for t in range(len(prompt) + max_new - 1):
        feed = prompt[t] if t < len(prompt) else out[-1]
        logits, cache = tfm.decode_step(params, cfg, cache, torch.tensor([feed]), t)
        if t >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0])))
    return out[:max_new]


def _serve(setup, requests, slots):
    """(port's outputs, reference's outputs, port engine) for the same requests."""
    cfg, params, rcfg, rparams = setup
    eng = ServeEngine(cfg, params, batch_slots=slots, max_len=64, device="cpu")
    reng = RServeEngine(rcfg, rparams, batch_slots=slots, max_len=64)
    for uid, prompt, new, eos in requests:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new, eos_id=eos))
        reng.submit(RRequest(uid=uid, prompt=prompt, max_new_tokens=new, eos_id=eos))
    done, rdone = eng.run_until_drained(), reng.run_until_drained()
    assert set(done) == set(rdone) == {r[0] for r in requests}
    return ({u: r.output for u, r in done.items()}, {u: r.output for u, r in rdone.items()},
            eng, reng)


def test_single_request_matches_reference(setup):
    cfg, params, _, _ = setup
    prompt = [5, 17, 99, 3]
    got, want, eng, reng = _serve(setup, [(1, prompt, 6, None)], slots=2)
    assert got == want
    assert got[1] == reference_decode(cfg, params, prompt, 6)
    assert eng.steps_total == reng.steps_total and eng.tokens_total == reng.tokens_total == 6


def test_batch_of_heterogeneous_requests(setup):
    cfg, params, _, _ = setup
    prompts = {1: [5, 17, 99, 3], 2: [42], 3: [7, 7, 7, 7, 7, 7, 7, 7], 4: [100, 200],
               5: [11, 12, 13]}
    news = {1: 4, 2: 6, 3: 3, 4: 5, 5: 4}
    # 2 slots for 5 requests => forced slot reuse (continuous batching)
    got, want, eng, reng = _serve(setup, [(u, p, news[u], None) for u, p in prompts.items()],
                                  slots=2)
    assert got == want
    for u, p in prompts.items():
        assert got[u] == reference_decode(cfg, params, p, news[u]), u
    assert eng.steps_total == reng.steps_total
    stats, rstats = eng.stats(), reng.stats()
    assert set(stats) == set(rstats)
    for key in ("serve_queue_depth", "serve_active_slots", "serve_tokens_total",
                "serve_steps_total"):
        assert stats[key] == rstats[key], key


def test_eos_early_stop(setup):
    cfg, params, _, _ = setup
    prompt = [5, 17, 99, 3]
    full = reference_decode(cfg, params, prompt, 8)
    # pick an eos token at its FIRST occurrence in the greedy stream
    j = next(i for i, t in enumerate(full) if t not in full[:i])
    got, want, _, _ = _serve(setup, [(9, prompt, 8, full[j])], slots=1)
    assert got == want
    assert got[9] == full[:j + 1]


def test_engine_refuses_what_it_does_not_serve(setup):
    cfg, params, _, _ = setup
    with pytest.raises(ValueError, match="greedily"):
        ServeEngine(cfg, params, sample="topk", device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=1, max_len=8, device="cpu")
    eng.submit(Request(uid=1, prompt=[1, 2, 3], max_new_tokens=6))
    with pytest.raises(ValueError, match="max_len"):
        eng.step()


@pytest.fixture(scope="module")
def moe_setup():
    rcfg = rsmoke_config("olmoe-1b-7b")
    rparams = rtfm.init_params(rcfg, jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return smoke_config("olmoe-1b-7b"), params, rcfg, rparams


def test_moe_engine_matches_reference_and_greedy_loop(moe_setup):
    """OLMoE at smoke width: 4 slots route their tokens through one
    ``[E, C, D]`` buffer with C = 8 >= 4, so no decode token is dropped and
    each request gets the tokens of the one-request greedy loop; the
    reference's engine gives the same tokens."""
    cfg, params, _, _ = moe_setup
    prompts = {1: [5, 17, 99, 3], 2: [42], 3: [7, 7, 7, 7, 7, 7, 7, 7], 4: [100, 200],
               5: [11, 12, 13], 6: [300, 1, 2, 3, 4, 5]}
    got, want, eng, reng = _serve(moe_setup, [(u, p, 5, None) for u, p in prompts.items()],
                                  slots=4)
    assert got == want
    for u, p in prompts.items():
        assert got[u] == reference_decode(cfg, params, p, 5), u
    assert eng.steps_total == reng.steps_total
