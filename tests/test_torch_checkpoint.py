"""The port's checkpoints (``training/checkpoint.py``): the reference's
tests for the port, and checkpoints that cross between the two packages
bit for bit, both ways, bf16 leaves included.

The mesh's save (gathered, rank 0 writes) is held against a one-rank save
in ``tests/test_torch_sharding.py``.
"""

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

from repro import configs as rconfigs
from repro.models import transformer as rtfm
from repro.optim import make_optimizer as r_make_optimizer
from repro.training.checkpoint import restore_checkpoint as r_restore_checkpoint
from repro.training.checkpoint import save_checkpoint as r_save_checkpoint
from repro_torch.convert import opt_state_from_jax, params_from_jax, worker_m_from_jax
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.utils.tree import tree_flatten_with_path

ROOT = Path(__file__).resolve().parents[1]


def test_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn((3, 4), generator=g),
                       "b": torch.randn((4,), generator=g).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 7, tree)
    like = {"params": {"w": torch.zeros(3, 4), "b": torch.zeros(4, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    restored = restore_checkpoint(str(tmp_path), like)
    for (pa, a), (pb, b) in zip(tree_flatten_with_path(tree)[0],
                                tree_flatten_with_path(restored)[0]):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_latest_step(tmp_path):
    tree = {"w": torch.ones(2)}
    save_checkpoint(str(tmp_path), 10, tree)
    save_checkpoint(str(tmp_path), 200, tree)
    assert latest_step(str(tmp_path)) == 200
    assert latest_step(str(tmp_path / "nothing")) is None
    restored = restore_checkpoint(str(tmp_path), tree)  # picks latest
    assert torch.equal(restored["w"], tree["w"])


def test_missing_key_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": torch.ones(2)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"w": torch.ones(2), "extra": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nothing"), {"w": torch.ones(2)})


def _reference_state(arch, W):
    """``{params, opt_state, worker_m}`` of the reference in bf16: random
    parameters, moments and worker momenta (so no leaf is trivially 0)."""
    import dataclasses

    rcfg = dataclasses.replace(rconfigs.smoke_config(arch), dtype="bfloat16")
    params = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    opt = r_make_optimizer("adamw")[0](params)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))
    noisy = lambda x: jax.random.normal(next(keys), x.shape, x.dtype)  # noqa: E731
    opt = type(opt)(step=jnp.asarray(5, jnp.int32), m=jax.tree_util.tree_map(noisy, opt.m),
                    v=jax.tree_util.tree_map(noisy, opt.v))
    worker_m = jax.tree_util.tree_map(
        lambda x: jax.random.normal(next(keys), (W,) + x.shape, jnp.float32), params)
    return {"params": params, "opt_state": opt, "worker_m": worker_m}


def _port_state(rstate):
    np_tree = jax.tree_util.tree_map(np.asarray, rstate)
    return {"params": params_from_jax(np_tree["params"], "cpu"),
            "opt_state": opt_state_from_jax(np_tree["opt_state"], "cpu"),
            "worker_m": worker_m_from_jax(np_tree["worker_m"], "cpu")}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().reshape(-1).view(np.uint8)
    a = np.asarray(x)
    return a.reshape(-1).view(np.uint8)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b"])
def test_checkpoints_cross_between_the_packages(tmp_path, arch):
    """A reference checkpoint of ``{params, opt_state, worker_m}`` (bf16
    parameters) restores in the port bit for bit, and the port's restores
    in the reference bit for bit; the manifests are equal."""
    rstate = _reference_state(arch, W=4)
    state = _port_state(rstate)
    r_save_checkpoint(str(tmp_path / "ref"), 3, rstate)
    save_checkpoint(str(tmp_path / "port"), 3, state)
    manifests = [json.loads((tmp_path / d / "step_00000003" / "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert "opt_state/m/blocks/0/mixer/wq" in manifests[0]["keys"]

    like = {"params": jax.tree_util.tree_map(torch.zeros_like, state["params"]),
            "opt_state": type(state["opt_state"])(
                step=torch.zeros((), dtype=torch.int32),
                m=jax.tree_util.tree_map(torch.zeros_like, state["opt_state"].m),
                v=jax.tree_util.tree_map(torch.zeros_like, state["opt_state"].v)),
            "worker_m": jax.tree_util.tree_map(torch.zeros_like, state["worker_m"])}
    mine = restore_checkpoint(str(tmp_path / "ref"), like)
    assert type(mine["opt_state"]).__name__ == "OptState"
    theirs = r_restore_checkpoint(str(tmp_path / "port"),
                                  jax.tree_util.tree_map(jnp.zeros_like, rstate))
    for (pa, a), (pb, b), (pc, c) in zip(tree_flatten_with_path(mine)[0],
                                         tree_flatten_with_path(state)[0],
                                         jax.tree_util.tree_flatten_with_path(theirs)[0]):
        assert pa == pb
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(c), _bits(b))
    for a, c in zip(jax.tree_util.tree_leaves(rstate), jax.tree_util.tree_leaves(theirs)):
        assert a.dtype == c.dtype


@pytest.mark.parametrize("ranks", [0, 2], ids=["one_process", "two_ranks"])
def test_example_trains_and_its_checkpoint_restores_in_the_reference(tmp_path, ranks):
    """``examples/train_llm_byzantine_torch.py`` for 3 steps at smoke width
    on the CPU (one process, and an fsdp config over 2 gloo ranks), then
    its checkpoint restored by the reference's ``restore_checkpoint``,
    equal bit for bit to the port's restore of it."""
    arch = "gemma-7b" if ranks else "tinyllama-1.1b"
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, str(ROOT / "examples" / "train_llm_byzantine_torch.py"),
           "--steps", "3", "--device", "cpu", "--arch", arch, "--seq-len", "32",
           "--batch", "4", "--ckpt-dir", str(ckpt)] + (["--ranks", str(ranks)] if ranks else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "checkpoint ->" in run.stdout
    last = [line for line in run.stdout.splitlines() if line.startswith("step")][-1]
    assert np.isfinite(float(last.split()[3]))

    rcfg = rconfigs.smoke_config(arch)
    rparams = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    rlike = {"params": rparams, "opt": r_make_optimizer("adamw")[0](rparams)}
    theirs = r_restore_checkpoint(str(ckpt), rlike)
    np_like = jax.tree_util.tree_map(np.asarray, rlike)
    like = {"params": params_from_jax(np_like["params"], "cpu"),
            "opt": opt_state_from_jax(np_like["opt"], "cpu")}
    mine = restore_checkpoint(str(ckpt), like)
    assert int(theirs["opt"].step) == 3
    for (pa, a), (pb, b) in zip(tree_flatten_with_path(mine)[0],
                                jax.tree_util.tree_flatten_with_path(theirs)[0]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        assert np.all(np.isfinite(np.asarray(b, np.float32)))
