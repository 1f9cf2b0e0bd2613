"""The dry-run on fake ranks (``repro_torch.launch.dryrun``) and the production
mesh (``launch/mesh.make_production_mesh``).

One process joins PyTorch's ``"fake"`` process group as one rank of 8, 256
or 512 and runs a step under ``FakeTensorMode``: no card, no other process.
Full-width combinations are traced with their depth cut to one layer (one
period for the hybrid), since a full-depth 32k-token prefill dispatches
millions of fake ops; ``chip_smoke.py`` runs the CLI at full depth.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import targets
from repro_torch.analysis.collective_lint import BUDGET_DIR, profile
from repro_torch.configs import INPUT_SHAPES, ByzConfig, get_config, smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed import steps
from repro_torch.distributed.sharding import (compute_shardings, overrides_from_config,
                                              param_shardings)
from repro_torch.kernels import cost
from repro_torch.launch import dryrun
from repro_torch.launch.collectives import record_collectives
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, n_workers
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import tree_flatten, tree_flatten_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BYZ = ByzConfig(aggregator="rfa", mixing="bucketing", s=2, worker_momentum=0.9, delta=0.1)


@pytest.fixture
def fake_group():
    """``activate(n, rank)`` for the test; the group is closed after it."""
    yield dryrun.activate
    if dist.is_initialized():
        dist.destroy_process_group()


def test_import_creates_no_group_and_sets_nothing():
    code = ("import os, torch.distributed as dist\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized()\n"
            "assert dict(os.environ) == before\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, {"data": 16, "model": 16}, ("data", "model")),
    (True, {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"))])
def test_production_mesh_has_the_reference_shapes(fake_group, multi_pod, shape, axes):
    fake_group(512 if multi_pod else 256, rank=37)
    mesh = make_production_mesh(dist.group.WORLD, multi_pod=multi_pod)
    assert mesh.axis_names == axes and mesh.shape == shape
    assert mesh.size == math.prod(shape.values()) and mesh.rank == 37
    assert mesh.coords == mesh.coords_of(37)
    assert n_workers(mesh) == (32 if multi_pod else 16)


def test_prefill_flops_equal_the_real_run(fake_group):
    """On a 1-rank fake group the dry-run's count (``make_step`` under
    ``FakeTensorMode`` with its ``_CostMode``) of a smoke-width prefill's
    FLOPs equals ``FlopCounterMode``'s count of the same prefill on real
    CPU tensors, exactly; no kernel of ours runs on that path."""
    cfg = smoke_config("tinyllama-1.1b")
    shape = InputShape("prefill_small", 256, 2, "prefill")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in steps.input_specs(cfg, shape).items()}
    counter = FlopCounterMode(display=False)
    with counter:
        steps.make_prefill_step(cfg, None, device="cpu")(params, batch)
    fake_group(1)
    mesh = make_host_mesh(dist.group.WORLD)
    cost.reset()
    with FakeTensorMode(allow_non_fake_inputs=True):
        run, _ = dryrun.make_step(cfg, shape, mesh, BYZ, dryrun.trace_device())
        counted = dryrun._CostMode()
        with record_collectives() as calls, counted:
            run()
    assert counter.get_total_flops() > 0
    assert counted.flops == counter.get_total_flops()
    assert cost.COSTS == {} and calls == []


def test_train_collectives_equal_the_committed_budget(fake_group):
    """``train_step_qwen2_5_14b_smoke`` on a fake (4, 2) group, each of the 8
    ranks in turn: per kind, the busiest rank's calls and received bytes
    equal the committed budget (measured on 8 real gloo ranks) exactly."""
    spec = targets.resolve([targets.TRAIN_TARGET])[0]
    ranks = []
    for rank in range(targets.N_RANKS):
        fake_group(targets.N_RANKS, rank=rank)
        mesh = make_host_mesh(dist.group.WORLD, data=targets.MESH_DATA,
                              model=targets.MESH_MODEL)
        with FakeTensorMode(allow_non_fake_inputs=True):
            call, _ = targets._train_call(spec, mesh, dryrun.trace_device())
            with record_collectives() as calls:
                call()
        ranks.append(calls)
    with open(os.path.join(BUDGET_DIR, f"{targets.TRAIN_TARGET}.json")) as fh:
        budget = json.load(fh)
    got = profile(ranks)
    assert got["collective_counts"] == budget["collective_counts"]
    assert got["collective_bytes"] == budget["collective_bytes"]


def _expected_argument(cfg, mesh, shape) -> int:
    """A rank's blocks of the parameters, the optimizer state and the worker
    momenta (its compute blocks) ``make_train_step`` holds, and the batch
    every rank is handed."""
    specs = tfm.params_shape(cfg)
    placed = param_shardings(specs, mesh, fsdp=cfg.fsdp, overrides=overrides_from_config(cfg))
    size = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
    block = sum(math.prod(pl.local_shape(s.shape)) * size[s.dtype]
                for s, pl in zip(tree_flatten(specs)[0], tree_flatten(placed)[0]))
    block_numel = sum(math.prod(pl.local_shape(s.shape))
                      for s, pl in zip(tree_flatten(specs)[0], tree_flatten(placed)[0]))
    opt = block_numel * size[getattr(torch, cfg.opt_m_dtype)] + 4  # sgdm m, int32 step
    momenta = 0
    if cfg.momentum_mode == "worker":  # one worker's compute blocks, fp32
        momenta = sum(math.prod(pl.local_shape(s.shape)) for s, pl in zip(
            tree_flatten(specs)[0], tree_flatten(compute_shardings(cfg, specs, mesh))[0])) * 4
    batch = sum(math.prod(v.shape) * 4 for v in steps.input_specs(cfg, shape).values())
    return block + opt + momenta + batch


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b"])
def test_argument_bytes_are_the_rank_blocks(fake_group, arch):
    """At full width on the fake (16, 16) mesh a rank's ``argument`` bytes
    are exactly its blocks of the parameters (fsdp for gemma-7b), the
    optimizer state and worker momenta the step holds, and the batch."""
    fake_group(256, rank=17)
    mesh = make_production_mesh(dist.group.WORLD)
    cfg = get_config(arch)
    shape = INPUT_SHAPES["train_4k"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        _, args = dryrun.make_step(cfg, shape, mesh, BYZ, dryrun.trace_device())
        got = dryrun._nbytes(args)
    assert got == _expected_argument(cfg, mesh, shape)
    if cfg.fsdp:  # fsdp cuts the parameters over both axes: at least 16x below whole
        whole = sum(math.prod(s.shape) * 2 for s in tree_flatten(tfm.params_shape(cfg))[0])
        assert got < whole / 16


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("tinyllama-1.1b", "train_4k", False), ("tinyllama-1.1b", "prefill_32k", False),
    ("tinyllama-1.1b", "decode_32k", False), ("tinyllama-1.1b", "long_500k", False),
    ("mamba2-130m", "decode_32k", False), ("olmoe-1b-7b", "train_4k", False),
    ("tinyllama-1.1b", "decode_32k", True)])
def test_combinations_trace_at_full_width(fake_group, arch, shape, multi_pod):
    """Full width, one layer, on (16, 16) or (2, 16, 16): the reference's keys,
    finite positive costs, the kernels' work in a train step, and the bytes
    a rank holds; or the reference's gate skips the combination."""
    fake_group(512 if multi_pod else 256)
    result = dryrun.dryrun_one(arch, shape, multi_pod, BYZ, verbose=False,
                               overrides={"n_layers": 1})
    if "skipped" in result:
        assert shape == "long_500k" and get_config(arch).long_context != "window"
        return
    assert result["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert result["n_chips"] == (512 if multi_pod else 256)
    for key in ("flops", "bytes_hbm", "compute_s", "memory_s", "collective_s",
                "collective_bytes", "trace_s"):
        assert math.isfinite(result[key]) and result[key] >= 0, key
    assert result["flops"] > 0 and result["bytes_hbm"] > 0
    assert result["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    mem = result["bytes_per_device"]
    assert 0 < mem["argument"] <= mem["peak"] and mem["temp"] == mem["peak"] - mem["argument"]
    if result["kind"] == "train":
        assert result["kernels"]["bucket_mix"]["calls"] >= 1
        assert result["collectives"]["all-to-all"] > 0  # the sync's worker-sharded ingress
    else:
        assert result["kernels"] == {}


def test_remat_lowers_the_train_peak(fake_group):
    """gemma-7b x train_4k at full width, 2 of 28 layers, on (16, 16): with
    ``remat="full"`` (its config's) the backward keeps each period's input
    and recomputes the period, so a rank's peak is lower and its FLOPs and
    HBM bytes higher than with ``remat="none"``; the argument is the same."""
    fake_group(256)
    runs = {remat: dryrun.dryrun_one("gemma-7b", "train_4k", verbose=False,
                                     overrides={"n_layers": 2, "remat": remat})
            for remat in ("none", "full")}
    none, full = runs["none"], runs["full"]
    assert get_config("gemma-7b").remat == "full"
    assert full["bytes_per_device"]["peak"] < none["bytes_per_device"]["peak"]
    assert full["bytes_per_device"]["argument"] == none["bytes_per_device"]["argument"]
    assert full["flops"] > none["flops"] and full["bytes_hbm"] > none["bytes_hbm"]
    assert full["kernels"] == none["kernels"]


def test_model_axis_cuts_the_train_peak(fake_group):
    """gemma-7b x train_4k at full width, 2 of 28 layers, on (16, 16): the
    step computes along the model axis (16 heads, 16 kv heads, d_ff 24,576
    and the 256,000-row vocab over 16 ranks), so a rank's peak is at or
    below 3.5e10 B (2.095e11 while compute stayed gathered); the peak holds
    the vocab-parallel cross-entropy's saved fp32 logits [16 x 4096,
    256,000 / 16]; the all-reduces of the stream [16, 4096, 3072] bf16
    (the embedding, each layer's two outputs and two input gradients, the
    head's gradient) show in the collective bytes."""
    fake_group(256)
    run = dryrun.dryrun_one("gemma-7b", "train_4k", verbose=False, overrides={"n_layers": 2})
    cfg = get_config("gemma-7b")
    tokens = INPUT_SHAPES["train_4k"].global_batch // 16 * INPUT_SHAPES["train_4k"].seq_len
    peak = run["bytes_per_device"]["peak"]
    assert tokens * (cfg.vocab_size // 16) * 4 < peak <= 3.5e10
    stream = tokens * cfg.d_model * 2
    assert run["collectives"]["all-reduce"] >= (1 + 4 * 2 + 1) * stream


def test_long_500k_gate_skips_full_attention():
    """The reference's applicability gate: an arch whose long-context variant
    is a window of no length skips long_500k, before any group is needed;
    decode_32k is not gated."""
    no_window = {"long_context_window": 0}
    assert "skipped" in dryrun.dryrun_one("tinyllama-1.1b", "long_500k", verbose=False,
                                          overrides=no_window)
    with pytest.raises(Exception):  # not gated: it needs the (absent) group
        dryrun.dryrun_one("tinyllama-1.1b", "decode_32k", verbose=False, overrides=no_window)


def test_cli_prints_four_lines_and_reports_a_failure(tmp_path):
    """``python -m repro_torch.launch.dryrun``: the reference's four lines per
    combination and exit 0; the JSON report, and exit 1 with the failure
    reported."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "mamba2-130m", "--shape", "decode_32k"],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    head = lines.index("== mamba2-130m x decode_32k x 16x16 (decode) ==")
    assert [line.split(":")[0] for line in lines[head + 1:head + 4]] == [
        "memory_analysis", "cost_analysis", "roofline"]
    assert "1/1 combinations traced" in proc.stdout
    out = tmp_path / "out.json"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "no-such-arch", "--shape", "decode_32k", "--json", str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "!! no-such-arch x decode_32k FAILED: KeyError" in proc.stdout
    assert "0/1 combinations traced" in proc.stdout
    assert json.loads(out.read_text())[0]["arch"] == "no-such-arch"


def test_fake_costs_are_reset_per_combination(fake_group):
    fake_group(256)
    cost.COSTS["bucket_mix"] = {"calls": 99, "bytes": 1.0, "ops": 1.0}
    result = dryrun.dryrun_one("mamba2-130m", "decode_32k", verbose=False,
                               overrides={"n_layers": 1})
    assert result["kernels"] == {}


def test_local_cuts_only_the_named_dims(fake_group):
    """``Placement.local(x, dims=...)`` cuts the named dims of a block whose
    other dims are already local: a batch-sharded SSM cache's channel dim
    after a decode step, whose 8 rows do not split over the 16 data ranks
    (the dry-run of mamba2-130m x decode_32k found this raising)."""
    from repro_torch.distributed.sharding import Placement

    fake_group(4, rank=3)
    mesh = make_host_mesh(dist.group.WORLD, data=2, model=2)
    pl = Placement(mesh, (None, "data", "model"))
    x = torch.arange(3 * 8, dtype=torch.float32).reshape(1, 3, 8)  # 3 rows: not 2 blocks
    assert torch.equal(pl.local(x, dims=[2]), x[:, :, 4:])
    with pytest.raises(ValueError):
        pl.local(x)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_argument_is_the_compute_blocks(fake_group, shape):
    """gemma-7b at full width, 2 of 28 layers, on the fake (16, 16) mesh: the
    serving steps trace on this rank's compute blocks, made as fresh
    tensors, and their ``argument`` bytes are exactly those blocks (16 / 16
    heads and kv heads, d_ff and the vocab split, the norms whole), this
    rank's cache blocks and the batch, so the parameters a rank holds fall
    below a fifteenth of the whole. The attention's blocks are widened to
    8,192 positions so the 32k prefill traces in seconds (they change its
    temporaries, not its arguments)."""
    fake_group(256, rank=17)
    mesh = make_production_mesh(dist.group.WORLD)
    overrides = {"n_layers": 2, "attn_block_q": 8192, "attn_block_kv": 8192}
    result = dryrun.dryrun_one("gemma-7b", shape, verbose=False, overrides=overrides)
    cfg = dataclasses.replace(get_config("gemma-7b"), **overrides)
    inputs = INPUT_SHAPES[shape]
    specs = tfm.params_shape(cfg)
    blocks = sum(math.prod(pl.local_shape(s.shape)) * 2 for s, pl in zip(
        tree_flatten(specs)[0], tree_flatten(compute_shardings(cfg, specs, mesh))[0]))
    batch = sum(math.prod(v.shape) * 4 for v in steps.input_specs(cfg, inputs).values())
    cache = 0
    if inputs.kind == "decode":
        _, cache_spec, placements = steps.make_serve_step(cfg, mesh, inputs, device="cpu")
        cache = sum(math.prod(pl.local_shape(s.shape)) * 2 for s, pl in zip(
            tree_flatten(cache_spec)[0], tree_flatten(placements)[0]))
    assert result["bytes_per_device"]["argument"] == blocks + cache + batch
    whole = sum(math.prod(s.shape) * 2 for s in tree_flatten(specs)[0])
    norms = 2 * cfg.d_model * (2 * cfg.n_layers + 1)
    assert blocks == (whole - norms) // 16 + norms < whole / 15
    assert result["flops"] > 0 and result["collectives"]["all-reduce"] > 0


def test_moe_serving_argument_is_the_expert_blocks(fake_group):
    """Kimi K2 x decode_32k at full width, 2 of 61 layers, on the fake (16,
    16) mesh: the serving step traces on this rank's compute blocks, whose
    384 experts split 24 a rank, the shared expert's d_ff_expert 2,048 / 16
    and the fp32 router whole; its ``argument`` is exactly those blocks
    (each leaf at its dtype's bytes), this rank's cache blocks and the
    batch, and its expert leaves hold 1 / 16 of the whole ones."""
    fake_group(256, rank=17)
    mesh = make_production_mesh(dist.group.WORLD)
    overrides = {"n_layers": 2}
    result = dryrun.dryrun_one("kimi-k2-1t-a32b", "decode_32k", verbose=False,
                               overrides=overrides)
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"), **overrides)
    inputs = INPUT_SHAPES["decode_32k"]
    specs = tfm.params_shape(cfg)
    flat = tree_flatten(specs)[0]
    plan = tree_flatten(compute_shardings(cfg, specs, mesh))[0]
    size = {torch.float32: 4, torch.bfloat16: 2}
    blocks = sum(math.prod(pl.local_shape(s.shape)) * size[s.dtype] for s, pl in zip(flat, plan))
    batch = sum(math.prod(v.shape) * 4 for v in steps.input_specs(cfg, inputs).values())
    _, cache_spec, placements = steps.make_serve_step(cfg, mesh, inputs, device="cpu")
    cache = sum(math.prod(pl.local_shape(s.shape)) * size[s.dtype] for s, pl in zip(
        tree_flatten(cache_spec)[0], tree_flatten(placements)[0]))
    assert result["bytes_per_device"]["argument"] == blocks + cache + batch
    for (path, s), pl in zip(tree_flatten_with_path(specs)[0], plan):
        name = path.split("/")[-1]
        if "/ff/" in path and "shared" not in path and name in ("w_gate", "w_up", "w_down"):
            assert pl.local_shape(s.shape)[1] == cfg.n_experts // 16 == 24, path
        if name == "router":
            assert pl.local_shape(s.shape) == tuple(s.shape) and s.dtype == torch.float32
    assert result["flops"] > 0 and result["collectives"]["all-reduce"] > 0


def test_ssm_serving_argument_is_the_head_blocks(fake_group):
    """Jamba v0.1 x decode_32k at full width and depth on the fake (16, 16)
    mesh: its 128 SSD heads split 8 a rank, so the serving step traces on
    the rank's head blocks of every SSM layer (in_proj's z, x and dt
    columns beside whole B / C, the conv's x channels beside whole B / C),
    and its ``argument`` is exactly those blocks, this rank's cache blocks
    and the batch: below 7e9 B, where the parent's whole SSM layers held
    1.2098e10. The reference's cache placement puts the SSM state on its
    heads, the compute block, so the step decodes it as it lies; the conv
    ring, on a contiguous channel range, is brought to the compute block
    and back by one all-gather each way for all 28 SSM layers."""
    fake_group(256, rank=17)
    mesh = make_production_mesh(dist.group.WORLD)
    with record_collectives() as calls:
        result = dryrun.dryrun_one("jamba-v0.1-52b", "decode_32k", verbose=False)
    cfg = get_config("jamba-v0.1-52b")
    inputs = INPUT_SHAPES["decode_32k"]
    specs = tfm.params_shape(cfg)
    flat = tree_flatten_with_path(specs)[0]
    plan = tree_flatten(compute_shardings(cfg, specs, mesh))[0]
    size = {torch.float32: 4, torch.bfloat16: 2}
    blocks = sum(math.prod(pl.local_shape(s.shape)) * size[s.dtype]
                 for (_, s), pl in zip(flat, plan))
    batch = sum(math.prod(v.shape) * 4 for v in steps.input_specs(cfg, inputs).values())
    _, cache_spec, placements = steps.make_serve_step(cfg, mesh, inputs, device="cpu")
    cache = sum(math.prod(pl.local_shape(s.shape)) * size[s.dtype] for s, pl in zip(
        tree_flatten(cache_spec)[0], tree_flatten(placements)[0]))
    assert result["bytes_per_device"]["argument"] == blocks + cache + batch < 7e9
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    for (path, s), pl in zip(flat, plan):
        if path.endswith("mixer/in_proj"):
            assert pl.local_shape(s.shape)[-1] == (2 * din + h) // 16 + 2 * n, path
        if path.endswith("mixer/A_log"):
            assert pl.local_shape(s.shape)[-1] == h // 16 == 8, path
    ssm_layers = [i for i, (mixer, _) in enumerate(cfg.pattern_) if mixer == "ssm"]
    assert placements[str(ssm_layers[0])]["ssm"].spec[2] == "model"  # heads: as it lies
    gathers = [c for c in calls if c.kind == "all-gather"]
    conv = sum(math.prod(pl.local_shape(s.shape)) * 2 for s, pl in zip(
        [cache_spec[str(i)]["conv"] for i in ssm_layers],
        [placements[str(i)]["conv"] for i in ssm_layers]))
    assert sum(1 for c in gathers if c.received == 16 * conv) == 1  # the rings, in one gather
