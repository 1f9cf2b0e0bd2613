"""The port's static-analysis gate (``repro_torch.analysis``).

The AST cases are tests/test_analysis.py's, case for case, against the
port's copy of the rules; the budget cases are its ``TestBudgets`` and
``TestExactAndAliasedBudgets`` on synthetic collective records in place of
golden HLO. The traced layers run the six targets once per module on 8 gloo
ranks on the CPU laid out as the (4, 2) mesh (``targets.run_on_ranks``),
with four seeded violations beside them: the param-sharded target without
its ``out_shardings``, the param-sharded target gathering a fp32 [n_pad]
row through ``Placement.gather``, and the rfa and cm targets taking the
plain route while kernels are expected.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import cli, targets
from repro_torch.analysis.ast_lint import lint_paths, lint_source
from repro_torch.analysis.collective_lint import (BUDGET_DIR, CollectiveCheckSpec,
                                                  lint_collectives, make_budget, profile,
                                                  write_budget)
from repro_torch.analysis.findings import ERROR, WARNING, Finding, Report
from repro_torch.analysis.op_trace import lint_trace, trace
from repro_torch.kernels import ops
from repro_torch.launch.collectives import CollectiveCall

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT = os.path.join(REPO, "src", "repro_torch")


# ============================================== collective budgets (synthetic)
def _call(kind, n, dtype="float32"):
    fn = {"all-gather": "all_gather", "all-reduce": "all_reduce",
          "all-to-all": "all_to_all_single"}[kind]
    b = n * {"float32": 4, "bfloat16": 2, "uint8": 1}[dtype]
    return CollectiveCall(kind=kind, fn=fn, sent=b, received=b, buffers=((dtype, n),))


#: the counterpart of tests/golden_hlo/start_done_pair.hlo: one all-gather of
#: f32[16, 128], one all-reduce and one all-to-all of f32[8, 128], on one rank
GOLDEN = [_call("all-gather", 16 * 128), _call("all-reduce", 8 * 128),
          _call("all-to-all", 8 * 128)]


def test_profile_takes_the_busiest_rank_per_kind():
    other = [_call("all-reduce", 8 * 128), _call("all-reduce", 4)]
    assert profile([GOLDEN, other]) == {
        "collective_counts": {"all-gather": 1, "all-reduce": 2, "all-to-all": 1},
        "collective_bytes": {"all-gather": 8192, "all-reduce": 4112, "all-to-all": 4096}}


class TestBudgets:
    def _budget_roundtrip(self, tmp_path, calls):
        budget = make_budget([calls], "t", tolerance=0.25)
        write_budget(budget, str(tmp_path))
        return budget

    def test_roundtrip_passes_on_same_records(self, tmp_path):
        self._budget_roundtrip(tmp_path, GOLDEN)
        assert lint_collectives([GOLDEN], CollectiveCheckSpec(name="t"),
                                budget_dir=str(tmp_path)) == []
        on_disk = json.loads((tmp_path / "t.json").read_text(encoding="utf-8"))
        assert on_disk["collective_counts"] == {"all-gather": 1, "all-reduce": 1,
                                                "all-to-all": 1}

    def test_missing_budget_is_error(self):
        findings = lint_collectives([GOLDEN], CollectiveCheckSpec(name="nope"),
                                    budget_dir="/nonexistent")
        assert [f.rule for f in findings] == ["collective-budget-missing"]

    def test_bytes_overshoot_beyond_tolerance(self, tmp_path):
        self._budget_roundtrip(tmp_path, GOLDEN)
        # 4 extra all-reduces: counts x5 and bytes x5 >> 25% tolerance
        bloated = GOLDEN + 4 * [_call("all-reduce", 8 * 128)]
        findings = lint_collectives([bloated], CollectiveCheckSpec(name="t"),
                                    budget_dir=str(tmp_path))
        rules = {f.rule for f in findings}
        assert "collective-count-budget" in rules
        assert "collective-bytes-budget" in rules
        assert all(f.severity == ERROR for f in findings)

    def test_new_collective_kind_is_error(self, tmp_path):
        self._budget_roundtrip(tmp_path, [c for c in GOLDEN if c.kind != "all-to-all"])
        findings = lint_collectives([GOLDEN], CollectiveCheckSpec(name="t"),
                                    budget_dir=str(tmp_path))
        assert any(f.rule == "collective-count-budget" and "all-to-all" in f.location
                   for f in findings)

    def test_large_undershoot_is_warning_not_error(self, tmp_path):
        self._budget_roundtrip(tmp_path, GOLDEN)
        # drop the all-gather AND the all-to-all: way under budget (past
        # tolerance + slack) -> stale-budget warning, not an error
        kept = [c for c in GOLDEN if c.kind == "all-reduce"]
        findings = lint_collectives([kept], CollectiveCheckSpec(name="t"),
                                    budget_dir=str(tmp_path))
        assert [f.severity for f in findings] == [WARNING]
        assert "--update-budgets" in findings[0].message


class TestExactAndAliasedBudgets:
    """``CollectiveCheckSpec(exact=True)`` (the telemetry-off "adds nothing"
    invariant) and ``budget_name`` (check another target's budget)."""

    def _write_ref(self, tmp_path, calls, name="ref"):
        write_budget(make_budget([calls], name, tolerance=0.25), str(tmp_path))

    def test_exact_passes_on_identical_records(self, tmp_path):
        self._write_ref(tmp_path, GOLDEN)
        spec = CollectiveCheckSpec(name="off_variant", budget_name="ref", exact=True)
        assert lint_collectives([GOLDEN], spec, budget_dir=str(tmp_path)) == []

    def test_exact_fails_inside_tolerance_band(self, tmp_path):
        """A bytes drift the tolerant check waves through (12.5% < 25%) must
        fail the exact check."""
        self._write_ref(tmp_path, GOLDEN)
        drifted = [GOLDEN[0], _call("all-reduce", 9 * 128), GOLDEN[2]]
        tolerant = lint_collectives([drifted], CollectiveCheckSpec(name="ref"),
                                    budget_dir=str(tmp_path))
        assert [f.rule for f in tolerant] == []
        exact = lint_collectives([drifted], CollectiveCheckSpec(name="off", budget_name="ref",
                                                                exact=True),
                                 budget_dir=str(tmp_path))
        assert [f.rule for f in exact] == ["collective-bytes-budget"]
        assert exact[0].severity == ERROR
        assert "byte-identical" in exact[0].message

    def test_exact_fails_on_one_extra_collective(self, tmp_path):
        self._write_ref(tmp_path, GOLDEN)
        grown = GOLDEN + [_call("all-reduce", 8 * 128)]
        findings = lint_collectives([grown], CollectiveCheckSpec(name="off", budget_name="ref",
                                                                 exact=True),
                                    budget_dir=str(tmp_path))
        assert sorted(f.rule for f in findings) == ["collective-bytes-budget",
                                                    "collective-count-budget"]
        assert all(f.severity == ERROR for f in findings)

    def test_exact_fails_on_missing_collective_kind(self, tmp_path):
        """Undershoot is a WARNING in tolerant mode; exact mode errors both ways."""
        self._write_ref(tmp_path, GOLDEN)
        kept = [c for c in GOLDEN if c.kind != "all-to-all"]
        findings = lint_collectives([kept], CollectiveCheckSpec(name="off", budget_name="ref",
                                                                exact=True),
                                    budget_dir=str(tmp_path))
        assert findings and all(f.severity == ERROR for f in findings)
        assert any("all-to-all" in f.location for f in findings)

    def test_missing_referenced_budget_names_the_reference(self, tmp_path):
        findings = lint_collectives([GOLDEN], CollectiveCheckSpec(name="off", budget_name="ref",
                                                                  exact=True),
                                    budget_dir=str(tmp_path))
        assert [f.rule for f in findings] == ["collective-budget-missing"]
        assert "ref.json" in findings[0].location


def test_replicated_egress_counts_only_replicating_collectives():
    spec = CollectiveCheckSpec(name="t", forbid_replicated_bytes=4 * 6144,
                               check_budget=False)
    # an all-to-all hands each rank different elements: never a replication
    assert lint_collectives([[_call("all-to-all", 6144)]], spec) == []
    assert lint_collectives([[_call("all-reduce", 6144, "bfloat16")]], spec) == []
    assert lint_collectives([[_call("all-reduce", 6143)]], spec) == []
    # judged by the bytes a call fills, whatever its buffers' dtype: the
    # port's all-gather moves uint8 views in one chunk a rank
    chunked = CollectiveCall(kind="all-gather", fn="all_gather", sent=3072,
                             received=8 * 3072, buffers=(("uint8", 3072),) * 8)
    for call in (_call("all-reduce", 6144), _call("all-gather", 6144),
                 _call("all-reduce", 2 * 6144, "bfloat16"), chunked):
        findings = lint_collectives([[], [call]], spec)
        assert [f.rule for f in findings] == ["collective-replicated-egress"]
        assert findings[0].location.startswith("rank 1")


def test_recorder_counts_each_collective_on_two_ranks():
    """``record_collectives`` on 2 gloo ranks: each wrapped function's kind,
    bytes sent and the buffers it filled (an all-gather's whole output,
    a sender's send none, the receiver's recv its buffer)."""
    from repro_torch.launch.mesh import spawn_ranks
    from torch_shard_ranks import record_each_collective

    ranks = spawn_ranks(record_each_collective, 2, backend="gloo", devices=["cpu"] * 2)
    f32 = lambda n: (("float32", n),)  # noqa: E731
    common = [("all-reduce", "all_reduce", 24, 24, f32(6)),
              ("all-gather", "all_gather", 24, 48, f32(6) * 2),
              ("all-gather", "all_gather_into_tensor", 24, 48, f32(12)),
              ("all-to-all", "all_to_all_single", 24, 24, f32(6))]
    assert ranks[0][:4] == ranks[1][:4] == common
    assert ranks[0][4:] == [("broadcast", "broadcast", 24, 24, f32(6)),
                            ("reduce-scatter", "reduce_scatter_tensor", 24, 12, f32(3)),
                            ("send", "send", 24, 0, ()), ("barrier", "barrier", 0, 0, ())]
    assert ranks[1][4:] == [("broadcast", "broadcast", 0, 24, f32(6)),
                            ("reduce-scatter", "reduce_scatter_tensor", 24, 12, f32(3)),
                            ("recv", "recv", 0, 24, f32(6)), ("barrier", "barrier", 0, 0, ())]


# ============================================================ op-trace rules
class TestOpTrace:
    def test_f64_flagged_once_per_op(self):
        _, t = trace(lambda x: (x.double() * 2).sum(), torch.ones(4))
        findings = lint_trace(t, "t")
        assert {f.rule for f in findings} == {"trace-f64"}
        assert {f.location for f in findings} == {"aten::_to_copy", "aten::mul", "aten::sum"}

    @pytest.mark.parametrize("sync", [lambda y: y.item(), lambda y: float(y),
                                      lambda y: bool(y > 0), lambda y: torch.nonzero(y)])
    def test_host_sync_flagged(self, sync):
        _, t = trace(lambda x: sync(x.sum()), torch.ones(4))
        findings = lint_trace(t, "t")
        assert [f.rule for f in findings] == ["trace-host-sync"]
        assert findings[0].severity == ERROR

    def test_kernel_presence_read_from_the_wrappers(self):
        x = torch.randn(4, 256)
        _, with_kernel = trace(lambda: ops.gram(x))
        assert with_kernel.kernel_calls == {"pairwise_gram": 1}
        assert with_kernel.kernel_launches == {}  # the plain version on the CPU
        assert lint_trace(with_kernel, "t", expect_kernels=True) == []
        _, plain = trace(lambda: x @ x.T)
        findings = lint_trace(plain, "t", expect_kernels=True)
        assert [f.rule for f in findings] == ["trace-kernel-missing"]
        assert lint_trace(plain, "t", expect_kernels=False) == []

    def test_backward_ops_are_recorded(self):
        def f(x):
            return torch.autograd.grad((x ** 3).sum(), x)[0]

        g, t = trace(f, torch.ones(3, requires_grad=True))
        assert torch.equal(g, torch.full((3,), 3.0))
        assert t.op_counts["aten::pow"] >= 2  # forward and backward
        assert lint_trace(t, "t") == []


# ============================================================== AST rules
class TestPrngReuse:
    def test_reused_sampler_key_flagged(self):
        src = ("import jax\n"
               "def f(key):\n"
               "    a = jax.random.normal(key, (4,))\n"
               "    b = jax.random.uniform(key, (4,))\n"
               "    return a + b\n")
        findings = lint_source(src, "m.py")
        assert [f.rule for f in findings] == ["ast-prng-reuse"]
        assert "m.py:4" in findings[0].location

    def test_reuse_via_key_kwarg_flagged(self):
        src = ("def step(self, key):\n"
               "    sent = self.attack(m, key=key)\n"
               "    agg = self.aggregator(sent, key=key)\n"
               "    return agg\n")
        findings = lint_source(src, "m.py")
        assert [f.rule for f in findings] == ["ast-prng-reuse"]

    def test_split_between_uses_is_clean(self):
        src = ("import jax\n"
               "def f(key):\n"
               "    k1, key = jax.random.split(key)\n"
               "    a = jax.random.normal(k1, (4,))\n"
               "    k2, key = jax.random.split(key)\n"
               "    b = jax.random.normal(k2, (4,))\n"
               "    return a + b\n")
        assert lint_source(src, "m.py") == []

    def test_if_else_branches_do_not_cross_contaminate(self):
        src = ("import jax\n"
               "def f(key, flag):\n"
               "    if flag:\n"
               "        return jax.random.normal(key, (4,))\n"
               "    else:\n"
               "        return jax.random.uniform(key, (4,))\n")
        assert lint_source(src, "m.py") == []

    def test_nested_function_scopes_are_independent(self):
        src = ("import jax\n"
               "def outer(key):\n"
               "    a = jax.random.normal(key, (4,))\n"
               "    def inner(key):\n"
               "        return jax.random.normal(key, (4,))\n"
               "    return a, inner\n")
        assert lint_source(src, "m.py") == []

    def test_split_indexed_keys_tracked_separately(self):
        src = ("import jax\n"
               "def f(key):\n"
               "    ks = jax.random.split(key, 2)\n"
               "    a = jax.random.normal(ks[0], (4,))\n"
               "    b = jax.random.normal(ks[1], (4,))\n"
               "    c = jax.random.normal(ks[0], (4,))\n"
               "    return a + b + c\n")
        findings = lint_source(src, "m.py")
        assert [f.rule for f in findings] == ["ast-prng-reuse"]
        assert "m.py:6" in findings[0].location


class TestEnvMutation:
    def test_module_level_environ_assign_flagged(self):
        src = ('import os\n'
               'os.environ["XLA_FLAGS"] = "--xla_force_host"\n')
        findings = lint_source(src, "m.py")
        assert [f.rule for f in findings] == ["ast-import-env-mutation"]

    def test_jax_config_update_at_import_flagged(self):
        src = ('import jax\n'
               'jax.config.update("jax_enable_x64", True)\n')
        findings = lint_source(src, "m.py")
        assert [f.rule for f in findings] == ["ast-import-env-mutation"]

    @pytest.mark.parametrize("line", ["torch.backends.cudnn.allow_tf32 = False",
                                      "torch.backends.cuda.matmul.allow_tf32 = False",
                                      "torch.set_float32_matmul_precision('high')",
                                      "torch.set_num_threads(1)"])
    def test_torch_backend_state_at_import_flagged(self, line):
        """The port's counterpart of jax.config: the TF32 flip the package's
        ``__init__`` made at import until the gate found it."""
        findings = lint_source(f"import torch\n{line}\n", "m.py")
        assert [f.rule for f in findings] == ["ast-import-env-mutation"]
        assert "m.py:2" in findings[0].location
        inside = "import torch\ndef activate():\n    " + line + "\n"
        assert lint_source(inside, "m.py") == []

    def test_inside_function_is_clean(self):
        src = ('import os\n'
               'def activate():\n'
               '    os.environ["XLA_FLAGS"] = "--xla_force_host"\n')
        assert lint_source(src, "m.py") == []

    def test_under_main_guard_is_clean(self):
        src = ('import os\n'
               'if __name__ == "__main__":\n'
               '    os.environ["XLA_FLAGS"] = "--xla_force_host"\n')
        assert lint_source(src, "m.py") == []

    def test_environ_setdefault_flagged(self):
        src = ('import os\n'
               'os.environ.setdefault("JAX_PLATFORMS", "cpu")\n')
        findings = lint_source(src, "m.py")
        assert [f.rule for f in findings] == ["ast-import-env-mutation"]


class TestMutableDefaultAndSuppression:
    def test_mutable_default_flagged(self):
        findings = lint_source("def f(x, acc=[]):\n    return acc\n", "m.py")
        assert [f.rule for f in findings] == ["ast-mutable-default"]

    def test_none_default_clean(self):
        assert lint_source("def f(x, acc=None):\n    return acc\n", "m.py") == []

    def test_inline_suppression(self):
        src = ("def f(x, acc=[]):  # lint: disable=ast-mutable-default\n"
               "    return acc\n")
        assert lint_source(src, "m.py") == []

    def test_suppress_all(self):
        src = ('import os\n'
               'os.environ["A"] = "b"  # lint: disable=all\n')
        assert lint_source(src, "m.py") == []

    def test_syntax_error_reported_not_raised(self):
        findings = lint_source("def f(:\n", "m.py")
        assert [f.rule for f in findings] == ["ast-syntax-error"]


def test_port_tree_is_ast_clean():
    """The committed port must pass the AST layer, ``src/repro_torch`` being
    its default tree."""
    assert cli.DEFAULT_SRC == (PORT,)
    findings = lint_paths([PORT])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_importing_the_port_changes_no_backend_flag():
    code = ("import torch\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "import repro_torch, repro_torch.models.mlp, repro_torch.analysis.cli\n"
            "assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32\n"
            "with repro_torch.ieee_fp32():\n"
            "    assert not torch.backends.cudnn.allow_tf32\n"
            "    assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def test_report_json_and_exit_semantics():
    r = Report(meta={"layers": ["ast"]})
    assert r.ok
    r.extend([Finding(rule="x", severity=WARNING, target="t", location="l", message="m")])
    assert r.ok  # warnings do not gate
    r.extend([Finding(rule="y", severity=ERROR, target="t", location="l", message="m")])
    assert not r.ok
    d = json.loads(r.to_json())
    assert d["n_errors"] == 1 and d["n_warnings"] == 1 and d["ok"] is False
    assert "FAIL" in r.summary()


# ==================================================== the targets on 8 ranks
SEEDED = {
    "fsdp_without_out_shardings": dataclasses.replace(
        targets.TARGETS["sync_fsdp_rfa_bucketing"], name="fsdp_without_out_shardings",
        drop_out_shardings=True, budget_name="sync_fsdp_rfa_bucketing"),
    "fsdp_row_gathered": dataclasses.replace(
        targets.TARGETS["sync_fsdp_rfa_bucketing"], name="fsdp_row_gathered",
        gather_row=True, budget_name="sync_fsdp_rfa_bucketing"),
    "rfa_plain_route": dataclasses.replace(
        targets.TARGETS["sync_kernels_rfa_bucketing"], name="rfa_plain_route",
        use_kernels=False, budget_name="sync_kernels_rfa_bucketing"),
    "cm_plain_route": dataclasses.replace(
        targets.TARGETS["sync_kernels_cm_bucketing"], name="cm_plain_route",
        use_kernels=False, budget_name="sync_kernels_cm_bucketing"),
}


@pytest.fixture(scope="module")
def ranks():
    """Every target and the seeded violations, once, on 8 gloo CPU ranks."""
    return targets.run_on_ranks(list(targets.TARGET_NAMES) + list(SEEDED.values()))


@pytest.mark.parametrize("name", targets.TARGET_NAMES)
def test_target_passes_both_traced_layers(ranks, name):
    spec = targets.TARGETS[name]
    assert len(ranks[name]) == targets.N_RANKS
    findings = cli.lint_runs([spec], traced=ranks, ranks=ranks)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_kernel_routes_reach_their_kernels_on_every_rank(ranks):
    want = {"sync_kernels_rfa_bucketing": {"bucket_mix": 2, "residual_norms": 8},
            "sync_kernels_cm_bucketing": {"bucket_mix": 1, "cwise_median": 1},
            "sync_kernels_cclip_bucketing": {"bucket_mix": 2, "residual_norms": 1,
                                             "cclip_fused_iter": 3}}
    for name, calls in want.items():
        assert [r.trace.kernel_calls for r in ranks[name]] == [calls] * targets.N_RANKS


def test_fsdp_egress_receives_only_blocks(ranks):
    """The param-sharded egress: one all-to-all in, one out, in which each
    rank receives n_params / 8 fp32 elements; no all-reduce of [n_pad]."""
    n_params = 16 * 48 + 8 * 64 + 4 * 256
    for run in ranks["sync_fsdp_rfa_bucketing"]:
        kinds = [c.kind for c in run.calls]
        assert kinds == ["all-to-all"] + ["all-reduce"] * 8 + ["all-to-all"]
        assert run.calls[-1].buffers == (("float32", n_params // targets.N_RANKS),)
        assert all(c.buffers[0][1] < run.n_pad for c in run.calls[1:])


def test_replicated_egress_fires_without_out_shardings(ranks):
    spec = SEEDED["fsdp_without_out_shardings"]
    findings = cli.lint_runs([spec], ranks=ranks)
    egress = [f for f in findings if f.rule == "collective-replicated-egress"]
    assert len(egress) == 1 and egress[0].severity == ERROR
    assert "24576 bytes" in egress[0].message and "('float32', 6144)" in egress[0].message
    assert "all_reduce" in egress[0].location


def test_replicated_egress_fires_on_a_gathered_row(ranks):
    """The port's own all-gather (``Placement.gather``: uint8 views in one
    chunk a rank) of the fp32 [n_pad] row is flagged by its bytes."""
    n_pad = ranks["fsdp_row_gathered"][0].n_pad
    gathers = [c for c in ranks["fsdp_row_gathered"][0].calls if c.kind == "all-gather"]
    assert [c.buffers[0][0] for c in gathers] == ["uint8", "uint8"]
    assert gathers[-1].received == 4 * n_pad
    findings = cli.lint_runs([SEEDED["fsdp_row_gathered"]], ranks=ranks)
    egress = [f for f in findings if f.rule == "collective-replicated-egress"]
    assert len(egress) == 1 and egress[0].severity == ERROR
    assert f"{4 * n_pad} bytes" in egress[0].message and "all_gather" in egress[0].location


@pytest.mark.parametrize("name", ["rfa_plain_route", "cm_plain_route"])
def test_plain_route_flagged_as_kernel_missing(ranks, name):
    findings = cli.lint_runs([SEEDED[name]], traced=ranks)
    assert [f.rule for f in findings] == ["trace-kernel-missing"]
    assert all(not r.trace.kernel_calls for r in ranks[name])


def test_telemetry_off_matches_the_rfa_budget_exactly(ranks):
    off = profile([r.calls for r in ranks["sync_telemetry_off_rfa_bucketing"]])
    budget = json.load(open(os.path.join(BUDGET_DIR, "sync_kernels_rfa_bucketing.json"),
                            encoding="utf-8"))
    assert off["collective_counts"] == budget["collective_counts"]
    assert off["collective_bytes"] == budget["collective_bytes"]


def test_budget_over_target_flagged(ranks, tmp_path):
    """A collective over budget: the committed rfa budget with one Weiszfeld
    all-reduce and the egress row's bytes taken away."""
    budget = json.load(open(os.path.join(BUDGET_DIR, "sync_kernels_rfa_bucketing.json"),
                            encoding="utf-8"))
    budget["collective_counts"]["all-reduce"] = 4
    budget["collective_bytes"]["all-reduce"] = 64
    write_budget(budget, str(tmp_path))
    spec = targets.TARGETS["sync_kernels_rfa_bucketing"]
    findings = cli.lint_runs([spec], ranks=ranks, budget_dir=str(tmp_path))
    assert {f.rule for f in findings} == {"collective-count-budget", "collective-bytes-budget"}
    assert all(f.severity == ERROR for f in findings)


def test_one_device_route_passes_the_trace_layer():
    """``run_on_device``, the card's route, here on the CPU: one rank, no
    mesh, kernel presence from the wrappers' calls."""
    names = ["sync_kernels_rfa_bucketing", "sync_kernels_cm_bucketing"]
    runs = targets.run_on_device(names, "cpu")
    assert runs["sync_kernels_cm_bucketing"][0].trace.kernel_calls == {
        "bucket_mix": 1, "cwise_median": 1}
    assert cli.lint_runs(targets.resolve(names), traced=runs) == []
    assert all(not r[0].calls for r in runs.values())  # no group, no collective


def test_budget_files_committed_for_all_targets():
    for name in targets.TARGET_NAMES:
        owner = targets.BUDGET_ALIASES.get(name, name)
        path = os.path.join(BUDGET_DIR, f"{owner}.json")
        assert os.path.exists(path), f"missing committed budget {path}"
        budget = json.loads(open(path, encoding="utf-8").read())
        assert budget["target"] == owner
        assert budget["collective_counts"], name
    for name in targets.BUDGET_ALIASES:
        assert name in targets.TARGET_NAMES, name
        assert not os.path.exists(os.path.join(BUDGET_DIR, f"{name}.json"))


# ========================================================== CLI plumbing
def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_ast_layer_exits_zero_on_repo():
    proc = _cli("--layers", "ast", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout


def test_cli_ast_layer_exits_nonzero_on_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('import os\nos.environ["X"] = "y"\n', encoding="utf-8")
    proc = _cli("--layers", "ast", "--src", str(bad), "--json", str(tmp_path / "report.json"),
                "--device", "cpu")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["ok"] is False
    assert report["findings"][0]["rule"] == "ast-import-env-mutation"


def test_cli_all_layers_exit_zero_on_the_tree(tmp_path):
    """``python -m repro_torch.analysis``: every layer, every target, against
    the committed budgets, its own 8 ranks."""
    proc = _cli("--json", str(tmp_path / "report.json"), "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["ok"] and report["findings"] == []
    assert report["meta"]["targets"] == list(targets.TARGET_NAMES)
    assert report["meta"]["n_ranks"] == 8
