"""The port's examples and scripts on the CPU: ``examples/*_torch.py`` (the
reference's examples through the port's public API) and
``scripts/{lint_repro,telemetry_smoke,coll_probe}_torch.py``.
``chip_smoke.py`` runs the examples on the card."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as r_smoke_config
from repro.models import transformer as rtfm
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _load(path: str):
    spec = importlib.util.spec_from_file_location(Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread (a parallel test run starts several
    test workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_defends_on_the_cpu(capsys):
    """The reference's quickstart at its defaults (n = 25, f = 5 mimic, RFA +
    bucketing s = 2, 300 steps) passes its ``> 0.7`` assert."""
    acc = _load("examples/quickstart_torch.py").main(["--device", "cpu"])
    assert acc > 0.7
    assert "defended against the mimic attack." in capsys.readouterr().out


def test_attack_defense_matrix_prints_the_grid(capsys):
    mod = _load("examples/attack_defense_matrix_torch.py")
    acc = mod.main(["--steps", "20", "--device", "cpu"])
    assert len(acc) == 5 * 4
    assert {a for a, _ in acc} == set(mod.ATTACKS)
    assert all(0.0 <= v <= 1.0 for v in acc.values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("attack") and len(lines) == 6
    assert acc[("none", "rfa+bucketing")] > 0.5


def _reference_tokens(cfg, rparams, prompts, new_tokens):
    """The reference example's loop: the prompt fed token by token through
    ``decode_step``, then greedy tokens."""
    B, P = prompts.shape[0], prompts.shape[-1]
    cache = rtfm.init_cache(cfg, B, P + new_tokens)
    logits = None
    for t in range(P):
        logits, cache = rtfm.decode_step(rparams, cfg, cache, prompts[..., t],
                                         jnp.asarray(t, jnp.int32))
    out = []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(P, P + new_tokens):
        out.append(tok)
        logits, cache = rtfm.decode_step(rparams, cfg, cache, tok, jnp.asarray(t, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return np.asarray(jnp.stack(out, axis=-1))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_serve_decode_gives_the_reference_tokens(arch):
    """``greedy_tokens`` on the reference's smoke parameters (fp32, carried
    across by ``params_from_jax``) gives the reference's greedy tokens for
    the same prompts (B = 4, 16 + 32 tokens), exactly."""
    rcfg = r_smoke_config(arch)
    rparams = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                            rcfg.vocab_size), dtype=np.int32)
    want = _reference_tokens(rcfg, rparams, jnp.asarray(prompts), 32)
    mod = _load("examples/serve_decode_torch.py")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    got = mod.greedy_tokens(params, smoke_config(arch), torch.tensor(prompts), 32, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_decode_main_runs(capsys):
    gen = _load("examples/serve_decode_torch.py").main(["--device", "cpu", "--new-tokens", "4"])
    assert gen.shape == (4, 4) and gen.dtype == torch.int32
    assert "decoded 4 tokens x 4 requests" in capsys.readouterr().out


# ------------------------------------------------------------------ scripts
def test_telemetry_smoke_validates_its_file(tmp_path, capsys):
    out = tmp_path / "t.jsonl"
    rc = _load("scripts/telemetry_smoke_torch.py").main([str(out), "--device", "cpu"])
    assert rc == 0
    assert "telemetry smoke OK: 6 events (5 rounds)" in capsys.readouterr().out
    kinds = [json.loads(line)["kind"] for line in out.read_text().splitlines()]
    assert kinds.count("round") == 5


def test_coll_probe_runs_on_a_fake_group(tmp_path):
    """At smoke width on the fake (16, 16) group: the step's collectives by
    call, and the param-sharded egress receiving less than the replicated
    one, which fills the fp32 [n_pad] row."""
    out = tmp_path / "probe.jsonl"
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "coll_probe_torch.py"),
                           "--smoke", "--jsonl", str(out)], env=ENV, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    probes = {e["name"]: e["data"] for e in map(json.loads, out.read_text().splitlines())
              if e["kind"] == "probe"}
    train = probes["train_collectives"]
    assert train["n_ops"] > 0 and train["total_bytes"] > 0
    assert all(op["op_name"].endswith(".py:" + op["op_name"].split(":")[-1])
               for op in train["top_ops"])
    egress = probes["egress_comparison"]
    assert egress["replicated"]["npad_row_materialized"]
    assert not egress["param_sharded"]["npad_row_materialized"]
    assert egress["param_sharded"]["total_bytes"] < egress["replicated"]["total_bytes"]


def test_lint_script_forwards_to_the_gate():
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "lint_repro_torch.py"),
                           "--layers", "ast", "--device", "cpu"], env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default without a card")
def test_analysis_cli_defaults_to_the_card():
    """``python -m repro_torch.analysis`` runs on the card unless told
    ``--device cpu``: without a card it raises, as every entry point does."""
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--layers", "ast"],
                          env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
