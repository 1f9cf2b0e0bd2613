"""The port's telemetry engine (``repro_torch/telemetry``) held against the
reference's: the catalogue spec for spec, the accumulator's zero-work-off
contract, the probe math, the JSONL schema, the aggregators' stats forms,
the packed engine on and off (alone and over a gloo group), both
simulators' telemetry (ALIE must be visible) and the serving engine's
events. Inputs come from numpy with a seed, mixing matrices from the
reference's keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks
from repro.configs import smoke_config as rsmoke_config
from repro.core.aragg import RobustAggregator as RRobustAggregator
from repro.data.partition import worker_datasets
from repro.data.synthetic import make_train_test
from repro.distributed.packing import packed_aggregate as rpacked_aggregate
from repro.models import transformer as rtfm
from repro.models.mlp import init_mlp as rinit_mlp
from repro.serving import Request as RRequest
from repro.serving import ServeEngine as RServeEngine
from repro.telemetry import EventLog as REventLog
from repro.telemetry import catalogue as rcatalogue
from repro.telemetry import probes as rprobes
from repro.telemetry import validate_jsonl as rvalidate_jsonl
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ByzConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.aragg import RobustAggregator
from repro_torch.distributed import packing
from repro_torch.distributed.packing import packed_aggregate
from repro_torch.distributed.robust_sync import robust_gradient_sync
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.mlp import nll_loss
from repro_torch.serving import Request, ServeEngine
from repro_torch.telemetry import (EventLog, InflightMetrics, MetricSpec, catalogue,
                                   get_metric, phase, register, trace_capture,
                                   validate_event, validate_jsonl)
from repro_torch.telemetry import probes
from repro_torch.telemetry.inflight import stack_series
from repro_torch.training.byzantine import ByzantineSim
from repro_torch.training.cross_device import CrossDeviceSim

W, D = 12, 600
RULE_KW = {"rfa": {}, "cm": {}, "tm": {"n_trim": 2}, "cclip": {"tau": 3.0},
           "krum": {"n_byzantine": 2}, "acclip": {}, "mean": {}}
#: tests/test_telemetry.py's EXPECTED_KEYS
EXPECTED_KEYS = {
    "rfa": {"rfa_residual", "rfa_resid_norms", "rfa_iters"},
    "cm": {"cm_worker_dev"},
    "tm": {"tm_trim_frac"},
    "cclip": {"cclip_lam", "cclip_clip_frac", "cclip_tau"},
    "krum": {"krum_scores", "krum_selected"},
}
COUNTERS = ("sync_n_workers", "sync_n_params", "sync_n_pad", "sync_ingress_bytes",
            "sync_egress_bytes")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes, and torch's default of one thread a core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(agg, mixing="bucketing"):
    """The port's and the reference's aggregator, and the reference's mixing
    matrix for ``PRNGKey(9)`` (the key both reference forms receive)."""
    rra = RRobustAggregator.from_spec(agg, mixing=mixing, s=2, **RULE_KW[agg])
    ra = RobustAggregator.from_spec(agg, mixing=mixing, s=2, **RULE_KW[agg])
    key = jax.random.PRNGKey(9)
    return ra, rra, key, torch.tensor(np.asarray(rra.mixing_matrix(key, W)))


def _assert_stats_close(got, want, names, rtol=1e-5, atol=1e-5):
    for name in names:
        g, w = got[name], np.asarray(want[name])
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


# ============================================================== registry
def test_catalogue_equals_the_reference_spec_for_spec():
    ours = [(s.name, s.phase, s.kind, s.doc) for s in catalogue()]
    theirs = [(s.name, s.phase, s.kind, s.doc) for s in rcatalogue()]
    assert ours == theirs
    assert [s.name for s in catalogue()] == sorted(s.name for s in catalogue())


def test_registry_refuses_unknown_and_conflicting_specs():
    with pytest.raises(KeyError, match="unregistered"):
        get_metric("no_such_metric")
    spec = get_metric("agg_norm")
    assert register("agg_norm", spec.phase, spec.kind, spec.doc) == spec
    with pytest.raises(ValueError, match="already registered"):
        register("agg_norm", spec.phase, spec.kind, "different doc")
    for phase_, kind in (("nonsense", "scalar"), ("sim", "nonsense")):
        with pytest.raises(ValueError):
            MetricSpec("x", phase_, kind, "d")


# =============================================================== inflight
def test_disabled_accumulator_never_evaluates_lazy_values():
    tm = InflightMetrics(False)
    assert not tm

    def bomb():
        raise AssertionError("lazy probe evaluated with telemetry off")

    tm.put("agg_norm", bomb)
    tm.update({"loss": bomb})
    assert tm.tree() == {}


def test_enabled_accumulator_records_and_refuses_unregistered_names():
    tm = InflightMetrics(True)
    tm.put("agg_norm", lambda: torch.tensor(3.0))
    tm.put("loss", torch.tensor(1.5))
    assert set(tm.tree()) == {"agg_norm", "loss"} and float(tm.tree()["agg_norm"]) == 3.0
    with pytest.raises(KeyError, match="unregistered"):
        tm.put("not_in_catalogue", 1.0)


def test_stack_series():
    series = stack_series({"t": [torch.ones(2), torch.zeros(2)], "n": [8, 8],
                           "m": [torch.tensor([True, False])] * 3})
    assert series["t"].shape == (2, 2) and series["t"].dtype == np.float32
    assert series["n"].tolist() == [8, 8]
    assert series["m"].shape == (3, 2) and series["m"].dtype == np.bool_


# ================================================================= probes
@pytest.mark.parametrize("probe", ["bucket_dispersion", "bucket_dispersion_from_gram",
                                   "cm_worker_dev", "tm_trim_frac"])
def test_probe_matches_reference(probe):
    y = _xs((7, 40), seed=3)
    med = np.median(y, axis=0).astype(np.float32)
    args = {"bucket_dispersion": lambda m: (m(y),),
            "bucket_dispersion_from_gram": lambda m: (m(y) @ m(y).T,),
            "cm_worker_dev": lambda m: (m(y), m(med), 50),
            "tm_trim_frac": lambda m: (m(y), 2, 50)}[probe]
    want = getattr(rprobes, probe)(*args(jnp.asarray))
    got = getattr(probes, probe)(*args(torch.tensor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_tm_trim_frac_without_a_trim_is_zero():
    assert probes.tm_trim_frac(torch.tensor(_xs((2, 10))), 1).tolist() == [0.0] * 2


# ================================================================ markers
def test_phase_marker_is_transparent_and_named_in_the_trace(tmp_path):
    x = torch.tensor(_xs((8,)))

    def marked():
        with phase("unit_test"):
            return torch.sum(x * x)

    assert torch.equal(trace_capture(str(tmp_path), marked), torch.sum(x * x))
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "telemetry/unit_test" in names


# ================================================================= events
def test_event_log_kinds_and_schema():
    with EventLog(run_id="t") as log:
        log.run_meta(script="unit")
        log.round(0, {"agg_norm": torch.tensor(1.0), "byz_mask": torch.tensor([True, False])})
        log.bench_row("bench", {"cell": "a"}, {"mean_us": 2.0})
        log.probe("p", {"x": 1})
        log.serve({"serve_queue_depth": 0})
    assert [e["kind"] for e in log.events] == ["run_meta", "round", "bench_row", "probe",
                                               "serve"]
    assert log.events[1]["metrics"]["byz_mask"] == [True, False]
    for e in log.events:
        validate_event(e)
    with pytest.raises(ValueError, match="catalogue"):
        EventLog().round(0, {"made_up_metric": 1.0})
    with pytest.raises(ValueError, match="catalogue"):
        EventLog().serve({"made_up_metric": 1.0})


def test_tensors_coerced_to_json_and_read_back_by_both_validators(tmp_path):
    path = tmp_path / "ev.jsonl"
    with EventLog(path, run_id="t") as log:
        log.round(3, {"agg_norm": torch.tensor(2.5),
                      "worker_weights": torch.ones(4, dtype=torch.bfloat16),
                      "krum_selected": torch.tensor(2, dtype=torch.int32),
                      "rfa_iters": 8, "zeta_sq": np.float32(0.25)})
    for validate in (validate_jsonl, rvalidate_jsonl):
        events = validate(path)
        assert events[0]["round"] == 3
        assert events[0]["metrics"]["worker_weights"] == [1.0] * 4
        assert events[0]["metrics"]["krum_selected"] == 2
    for line in path.read_text().splitlines():
        json.loads(line)


def test_validate_jsonl_names_the_offending_line(tmp_path):
    path = tmp_path / "bad.jsonl"
    good = {"kind": "probe", "t": 1.0, "name": "p", "data": {}}
    path.write_text(json.dumps(good) + "\n" + "{not json}\n")
    with pytest.raises(ValueError, match="bad.jsonl:2"):
        validate_jsonl(path)
    path.write_text(json.dumps({"kind": "nope", "t": 1.0}) + "\n")
    with pytest.raises(ValueError, match="unknown event kind"):
        validate_jsonl(path)


# ========================================== aggregators' stats forms
@pytest.mark.parametrize("agg", sorted(RULE_KW))
def test_aggregate_with_stats_matches_reference(agg):
    """The stacked stats form against the reference's on the same rows and
    mix; its aggregate equals the port's plain form bit for bit (the mean's
    plain form is ``torch.mean``, its stats form the Gram weights: 2e-6)."""
    xs = _xs((W, D), seed=1)
    ra, rra, key, mix = _pair(agg)
    out, stats = ra.aggregate_with_stats(torch.tensor(xs), mix=mix)
    rout, rstats = rra.aggregate_with_stats(jnp.asarray(xs), key=key)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-5, atol=1e-5)
    assert sorted(stats) == sorted(rstats)
    _assert_stats_close(stats, rstats, rstats)
    plain = ra(torch.tensor(xs), mix=mix)
    if agg == "mean":
        np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=2e-6, atol=2e-6)
    else:
        assert torch.equal(out, plain)


@pytest.mark.parametrize("agg", ["rfa", "cclip", "krum", "acclip", "mean"])
def test_gram_weights_with_stats_match_reference(agg):
    xs = _xs((W, D), seed=2)
    ra, rra, key, mix = _pair(agg)
    gram = torch.tensor(xs) @ torch.tensor(xs).T
    w, stats = ra.worker_weights_and_stats_from_gram(gram, mix=mix)
    rw, rstats = rra.worker_weights_and_stats_from_gram(jnp.asarray(gram.numpy()), key=key)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-5, atol=1e-6)
    assert sorted(stats) == sorted(rstats)
    _assert_stats_close(stats, rstats, rstats, atol=1e-4)
    assert torch.equal(w, ra.worker_weights_from_gram(gram, mix=mix))


# ==================================================== packed engine
def _counting_ops(monkeypatch):
    """Calls of each kernel entry the packed engine goes through."""
    calls = {}
    for name in ("gram", "mix_apply", "cm_aggregate", "tm_aggregate"):
        fn = getattr(ops, name)

        def wrapper(*args, _name=name, _fn=fn, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ops, name, wrapper)
    return calls


@pytest.mark.parametrize("agg", sorted(RULE_KW))
def test_packed_aggregate_stats_on_vs_off(monkeypatch, agg):
    """Telemetry on: the reference's metrics and layout counters, the rule's
    values to 1e-5 of the reference's on the same input and mix, the same
    kernel calls as off, and off's result bit for bit. Telemetry off: no
    telemetry in the info."""
    xs = torch.tensor(_xs((W, D), seed=4))
    ra, rra, key, mix = _pair(agg)
    calls = _counting_ops(monkeypatch)
    out_off, info_off = packed_aggregate(xs, ra, mix=mix, with_info=True)
    calls_off = dict(calls)
    calls.clear()
    out_on, info_on = packed_aggregate(xs, ra, mix=mix, telemetry=True, with_info=True)
    assert "telemetry" not in info_off
    assert dict(calls) == calls_off
    assert torch.equal(out_on, out_off)
    assert torch.equal(out_off, packed_aggregate(xs, ra, mix=mix))
    tele = info_on["telemetry"]
    assert EXPECTED_KEYS.get(agg, set()) | {"bucket_dispersion", *COUNTERS} <= set(tele)
    _, rinfo = rpacked_aggregate(jnp.asarray(xs.numpy()), rra, key=key, use_kernels=False,
                                 telemetry=True, with_info=True)
    rtele = rinfo["telemetry"]
    assert sorted(tele) == sorted(rtele)
    assert (tele["sync_n_workers"], tele["sync_n_params"], tele["sync_n_pad"]) == (W, D, 2048)
    assert tele["sync_ingress_bytes"] == W * 2048 * 4 and tele["sync_egress_bytes"] == 2048 * 4
    _assert_stats_close(tele, rtele, rtele, atol=1e-4)
    for v in tele.values():
        assert np.all(np.isfinite(np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v,
                                             np.float32)))


def test_per_leaf_engine_telemetry():
    tree = {"a": torch.tensor(_xs((W, 40), 5)), "b": torch.tensor(_xs((W, 3, 7), 6))}
    ra, _, _, mix = _pair("rfa")
    out, info = packing.packed_robust_sync(tree, ra, mix=mix, telemetry=True)
    pl_out, pl_info = robust_gradient_sync(tree, ra, mix=mix, engine="per_leaf",
                                           use_kernels=True, telemetry=True)
    for k in tree:
        assert torch.equal(out[k], pl_out[k])
    for name in pl_info["telemetry"]:
        torch.testing.assert_close(pl_info["telemetry"][name], info["telemetry"][name])
    cm, _, _, cm_mix = _pair("cm")
    assert "telemetry" not in robust_gradient_sync(tree, cm, mix=cm_mix, engine="per_leaf",
                                                   telemetry=True)[1]


# ============================================= sharded stats, gloo ranks
SHARD_RULES = ["rfa", "cclip", "cm", "tm", "krum"]


def _shard_tree():
    """Two leaves, 4096 packed columns, which 3 ranks do not divide."""
    return {"w": _xs((8, 16, 48), 7), "b": _xs((8, 33), 8)}


def _shard_mix(agg):
    ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **RULE_KW[agg])
    return ra, ra.mixing_matrix(8, torch.Generator().manual_seed(3), device="cpu")


@pytest.fixture(scope="module")
def telemetry_ranks():
    payload = {"tree": _shard_tree(),
               "syncs": {agg: (agg, RULE_KW[agg], _shard_mix(agg)[1].numpy())
                         for agg in SHARD_RULES}}
    return spawn_ranks(torch_shard_ranks.run_telemetry, 3, backend="gloo",
                       devices=["cpu"] * 3, args=(payload,), timeout_s=600)


@pytest.mark.parametrize("agg", SHARD_RULES)
def test_sharded_stats_over_a_group(telemetry_ranks, agg):
    """Over 3 gloo ranks: telemetry on keeps off's result bits and its
    shard_kernels calls; the metrics are the same on every rank, bit for
    bit, and agree with the one-device packed engine's (1e-4)."""
    first = telemetry_ranks[0][agg]["on"]["info"]["telemetry"]
    for r in telemetry_ranks:
        on, off = r[agg]["on"], r[agg]["off"]
        assert "telemetry" not in off["info"]
        assert on["routes"] == off["routes"]
        for k, v in off["result"].items():
            np.testing.assert_array_equal(on["result"][k], v)
        tele = on["info"]["telemetry"]
        assert sorted(tele) == sorted(first)
        for name, v in tele.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(first[name]), err_msg=name)
    ra, mix = _shard_mix(agg)
    _, info = packing.packed_robust_sync({k: torch.tensor(v) for k, v in _shard_tree().items()},
                                         ra, mix=mix, telemetry=True)
    single = info["telemetry"]
    assert EXPECTED_KEYS[agg] | {"bucket_dispersion", *COUNTERS} <= set(first)
    common = set(first) & set(single)
    assert common == set(first)  # the Gram route adds worker_weights, nothing else differs
    _assert_stats_close(first, {k: v.numpy() if isinstance(v, torch.Tensor) else v
                                for k, v in single.items()}, common, rtol=1e-4, atol=1e-4)


# ================================================================ sims
@pytest.fixture(scope="module")
def alie_pool():
    X, Y, _, _ = make_train_test(jax.random.PRNGKey(0), n_train=2500, n_test=100)
    wx, wy = worker_datasets(X, Y, n_good=20, n_byz=5, noniid=True)
    return torch.tensor(np.asarray(wx)), torch.tensor(np.asarray(wy))


@pytest.fixture(scope="module")
def mlp_params():
    return {k: np.asarray(v) for k, v in rinit_mlp(jax.random.PRNGKey(1)).items()}


def _alie_sim(agg, telemetry=True):
    n, f = 25, 5
    byz = ByzConfig(aggregator=agg, mixing="none", attack="alie",
                    attack_kwargs=(("n", n), ("f", f)), n_byzantine=f,
                    worker_momentum=0.9, delta=f / n)
    return ByzantineSim(loss_fn=nll_loss, byz=byz, n_workers=n, n_byzantine=f, lr=0.1,
                        batch_size=32, telemetry=telemetry, device="cpu")


def test_alie_visible_in_telemetry(alie_pool, mlp_params):
    """tests/test_telemetry.py's demo: ALIE rows hug the coordinatewise
    median abnormally tightly (low cm_worker_dev) and collect abnormally LOW
    Krum scores."""
    wx, wy = alie_pool
    f = 5
    _, hist = _alie_sim("cm").run(params_from_jax(mlp_params, device="cpu"), wx, wy, 15,
                                  torch.Generator().manual_seed(2))
    dev = hist["telemetry"]["cm_worker_dev"]
    assert dev.shape == (15, 25)
    byz_mask = hist["telemetry"]["byz_mask"][0]
    assert byz_mask[:f].all() and not byz_mask[f:].any()
    late = dev[5:]
    assert late[:, :f].mean() < 0.6 * late[:, f:].mean()
    _, hist_k = _alie_sim("krum").run(params_from_jax(mlp_params, device="cpu"), wx, wy, 15,
                                      torch.Generator().manual_seed(2))
    scores = hist_k["telemetry"]["krum_scores"]
    assert scores.shape == (15, 25)
    assert scores[5:, :f].mean() < scores[5:, f:].mean()
    for name in hist_k["telemetry"]:
        get_metric(name)


def test_telemetry_off_history_is_the_plain_history(alie_pool, mlp_params):
    wx, wy = alie_pool
    _, hist = _alie_sim("cm", telemetry=False).run(params_from_jax(mlp_params, device="cpu"),
                                                   wx, wy, 3, torch.Generator().manual_seed(2))
    assert sorted(hist) == ["eval", "step", "zeta_sq"]


def test_cross_device_telemetry(alie_pool, mlp_params):
    """tests/test_telemetry.py's cross-device run: the history's metrics,
    catalogued, through the JSONL log; with telemetry off the parameters
    are the same bit for bit."""
    wx, wy = alie_pool
    byz = ByzConfig(aggregator="rfa", mixing="bucketing", s=2, attack="alie",
                    attack_kwargs=(("n", 10), ("f", 2)), n_byzantine=0)
    states = {}
    for telemetry in (True, False):
        sim = CrossDeviceSim(loss_fn=nll_loss, byz=byz, n_clients=25, byz_frac=0.2,
                             clients_per_round=10, lr=0.1, batch_size=16,
                             telemetry=telemetry, device="cpu")
        states[telemetry], hist = sim.run(params_from_jax(mlp_params, device="cpu"), wx, wy,
                                          4, torch.Generator().manual_seed(2))
        if telemetry:
            tele = hist["telemetry"]
    assert "telemetry" not in hist
    assert tele["byz_mask"].shape == (4, 10)
    assert tele["rfa_residual"].shape == (4, 8) and tele["rfa_resid_norms"].shape == (4, 8, 5)
    assert tele["sync_n_workers"].tolist() == [10] * 4
    for name in tele:
        get_metric(name)
    with EventLog(run_id="unit") as log:
        for t in range(4):
            log.round(t, {k: v[t] for k, v in tele.items()})
    assert len(log.events) == 4
    for k, v in states[True].params.items():
        assert torch.equal(v, states[False].params[k]), k


# ============================================================= serving
def test_serve_engine_events_match_reference(tmp_path):
    """One ``serve`` event per decode step, on disk, read back by both
    validators; the counters step for step equal the reference engine's on
    the same requests and parameters."""
    rcfg = rsmoke_config("tinyllama-1.1b")
    rparams = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    path = tmp_path / "serve.jsonl"
    log, rlog = EventLog(path, run_id="serve_test"), REventLog(run_id="serve_test")
    eng = ServeEngine(smoke_config("tinyllama-1.1b"), params, batch_slots=2, max_len=64,
                      event_log=log, device="cpu")
    reng = RServeEngine(rcfg, rparams, batch_slots=2, max_len=64, event_log=rlog)
    for e, req in ((eng, Request), (reng, RRequest)):
        e.submit(req(uid=1, prompt=[5, 17, 99], max_new_tokens=4))
        e.submit(req(uid=2, prompt=[42], max_new_tokens=3))
    assert set(eng.run_until_drained()) == set(reng.run_until_drained()) == {1, 2}
    log.close()
    events = validate_jsonl(path)
    assert events == rvalidate_jsonl(path) == log.events
    assert len(events) == eng.steps_total == reng.steps_total > 0
    assert all(e["kind"] == "serve" for e in events)
    counters = ("serve_queue_depth", "serve_active_slots", "serve_tokens_total",
                "serve_steps_total")
    assert ([[e["metrics"][c] for c in counters] for e in events]
            == [[e["metrics"][c] for c in counters] for e in rlog.events])
    final = eng.stats()
    assert final["serve_tokens_total"] == 4 + 3 == eng.tokens_total
    assert final["serve_decode_step_s"] > 0.0 and final["serve_admit_latency_s"] >= 0.0
    for name in final:
        get_metric(name)
