"""The port's core modules and packed engine held against the reference.

The same numpy inputs go to the JAX reference and to the port on the CPU.
Where the reference draws from a ``jax.random`` key, the test hands the
port what the reference drew (a permutation, a mixing matrix).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs.base import ByzConfig as RByzConfig
from repro.core import aragg as raragg
from repro.core import attacks as rattacks
from repro.core import mixing as rmixing
from repro.core import momentum as rmomentum
from repro.distributed import packing as rpacking
from repro.models.mlp import init_mlp as rinit_mlp
from repro_torch.configs.base import ByzConfig
from repro_torch.core import aragg, attacks, mixing, momentum
from repro_torch.distributed import packing
from repro_torch.kernels.pairwise_gram import TILE_D
from repro_torch.models.mlp import init_mlp
from repro_torch.training.byzantine import stack_flatten_workers, unflatten_like

ROOT = pathlib.Path(__file__).resolve().parents[1]
RULES = [("mean", {}), ("cm", {}), ("tm", {"n_trim": 2}), ("krum", {"n_byzantine": 2}),
         ("rfa", {}), ("cclip", {"tau": 3.0}), ("acclip", {})]
MIXINGS = ["none", "bucketing", "resampling"]


def _xs(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 2).astype(np.float32)


# ------------------------------------------------------------------ mixing
@pytest.mark.parametrize("name", ["none", "bucketing", "resampling", "fixed_grouping"])
@pytest.mark.parametrize("n,s", [(5, 2), (10, 2), (10, 3), (25, 2)])
def test_mixer_matrix_matches_for_given_perm(name, n, s):
    rmix, tmix = rmixing.get_mixer(name, s), mixing.get_mixer(name, s)
    key = jax.random.PRNGKey(n * 10 + s)
    size = tmix.perm_size(n)
    perm = None if size == 0 else np.asarray(jax.random.permutation(key, size))
    expect = np.asarray(rmix.matrix(key, n))
    np.testing.assert_array_equal(tmix.matrix(n, perm=perm, device="cpu").numpy(), expect)
    np.testing.assert_array_equal(tmix.matrix(n, device="cpu").numpy(),
                                  np.asarray(rmix.matrix(None, n)))


@pytest.mark.parametrize("n,s", [(7, 2), (10, 3), (25, 4)])
def test_static_mixing_tables_match(n, s):
    np.testing.assert_array_equal(mixing._bucketing_base(n, s), rmixing._bucketing_base(n, s))
    np.testing.assert_array_equal(mixing._resampling_src(n, s), rmixing._resampling_src(n, s))


def test_drawn_matrix_is_row_stochastic():
    ra = aragg.RobustAggregator.from_spec("rfa", mixing="resampling", s=3)
    m = ra.mixing_matrix(10, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(m.sum(1), torch.ones(10))


# ------------------------------------------------------------- aggregators
@pytest.mark.parametrize("agg,kwargs", RULES, ids=[r[0] for r in RULES])
@pytest.mark.parametrize("mixing_name", MIXINGS)
def test_robust_aggregator_stacked_matches(agg, kwargs, mixing_name):
    x = _xs((10, 300))
    rra = raragg.RobustAggregator.from_spec(agg, mixing=mixing_name, s=2, **kwargs)
    tra = aragg.RobustAggregator.from_spec(agg, mixing=mixing_name, s=2, **kwargs)
    key = jax.random.PRNGKey(5)
    mix = torch.tensor(np.asarray(rra.mixing_matrix(key, 10)))
    expect = np.asarray(rra(jnp.asarray(x), key=key))
    np.testing.assert_allclose(tra(torch.tensor(x), mix=mix).numpy(), expect,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("agg,kwargs", [r for r in RULES if r[0] not in ("cm", "tm")],
                         ids=[r[0] for r in RULES if r[0] not in ("cm", "tm")])
def test_gram_weights_match(agg, kwargs):
    x = _xs((13, 200), seed=3)
    rra = raragg.RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **kwargs)
    tra = aragg.RobustAggregator.from_spec(agg, mixing="bucketing", s=2, **kwargs)
    key = jax.random.PRNGKey(9)
    gram = x @ x.T
    expect = np.asarray(rra.worker_weights_from_gram(jnp.asarray(gram), key=key))
    mix = torch.tensor(np.asarray(rra.mixing_matrix(key, 13)))
    got = tra.worker_weights_from_gram(torch.tensor(gram), mix=mix).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-6)


def test_gram_weights_see_an_exactly_symmetric_bucket_gram(monkeypatch):
    """The bucket Gram M G M^T rounds (i, j) and (j, i) apart; the rule sees
    its upper triangle mirrored, so the exact ties of Krum's scores (two
    buckets that are each other's nearest neighbour) stay exact, and the
    sharded and one-device paths pick the same bucket."""
    x = torch.tensor(_xs((10, 300), seed=4))
    tra = aragg.RobustAggregator.from_spec("krum", mixing="bucketing", s=2, n_byzantine=2)
    seen, coeffs = [], tra.base.coeffs
    monkeypatch.setattr(tra.base, "coeffs", lambda g: (seen.append(g), coeffs(g))[1])
    mix = tra.mixing_matrix(10, torch.Generator().manual_seed(7), device="cpu")
    tra.worker_weights_from_gram(x @ x.T, mix=mix)
    assert torch.equal(seen[0], seen[0].T)
    scores = tra.base.scores(seen[0])
    assert int((scores == scores.min()).sum()) >= 2  # a tie, won by the lower index


def test_theorem1_and_delta_max():
    assert aragg.DELTA_MAX == raragg.DELTA_MAX
    for delta, dmax, n in [(0.0, 0.5, 10), (0.1, 0.5, 10), (0.2, 0.25, 3), (0.05, 0.5, 4)]:
        assert aragg.theorem1_s(delta, dmax, n) == raragg.theorem1_s(delta, dmax, n)
    ra = aragg.RobustAggregator.from_spec("cm", mixing="bucketing", delta=0.1, n_workers=25)
    assert ra.mixer.s == 5


@pytest.mark.parametrize("agg", ["mean", "krum", "cm", "rfa", "cclip", "tm"])
def test_byz_config_builds_the_same_aggregator(agg):
    cfg = dict(aggregator=agg, mixing="bucketing", s=3, n_byzantine=2)
    r, t = RByzConfig(**cfg).make_aggregator(10), ByzConfig(**cfg).make_aggregator(10)
    assert type(t.base).__name__ == type(r.base).__name__
    assert type(t.mixer).__name__ == type(r.mixer).__name__ and t.mixer.s == r.mixer.s
    for attr in ("tau", "n_byzantine", "n_trim", "n_iters", "eps"):
        assert getattr(t.base, attr, None) == getattr(r.base, attr, None)


# ------------------------------------------------------- attacks, momentum
@pytest.mark.parametrize("name,kwargs", [("none", {}), ("bitflip", {}), ("ipm", {}),
                                         ("alie", {"n": 10, "f": 2}),
                                         ("mimic_fixed", {"i_star": 3}), ("mimic", {})])
def test_attacks_match(name, kwargs):
    x = _xs((10, 64), seed=4)
    mask = np.zeros(10, bool)
    mask[[0, 4, 7]] = True
    expect, _ = rattacks.get_attack(name, **kwargs)(jnp.asarray(x), jnp.asarray(mask))
    got, _ = attacks.get_attack(name, **kwargs)(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-6)


def test_alie_z_momentum_and_radius():
    for n, f in [(10, 2), (25, 5), (50, 10)]:
        assert attacks.alie_z(n, f) == rattacks.alie_z(n, f)
    for beta, scaling in [(0.9, "linear"), (0.5, "sqrt"), (0.9, "none"), (1.0, "linear")]:
        assert momentum.cclip_radius(beta, 10.0, scaling) == \
            rmomentum.cclip_radius(beta, 10.0, scaling)
    m, g = _xs((4, 8), 5), _xs((4, 8), 6)
    for conv in ("ema", "pytorch"):
        np.testing.assert_allclose(
            momentum.momentum_update(torch.tensor(m), torch.tensor(g), 0.9, conv).numpy(),
            np.asarray(rmomentum.momentum_update(jnp.asarray(m), jnp.asarray(g), 0.9, conv)),
            rtol=1e-6)


# ---------------------------------------------------------- packed engine
_TREES = {
    "mlp": {"w0": (784, 128), "b0": (128,), "w1": (128, 10), "b1": (10,)},
    # small leaves, one exactly a tile, one just over, one empty
    "small": {"a": (3, 5), "b": (2048,), "c": (2049,), "d": (0,)},
}


def _tree_pair(name, W=3):
    """A stacked gradient tree in both frameworks (same numbers)."""
    tree = {k: _xs((W,) + s, seed=i) for i, (k, s) in enumerate(_TREES[name].items())}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.tensor(v) for k, v in tree.items()})


@pytest.mark.parametrize("tree_name", ["mlp", "small"])
def test_grad_packer_layout_matches(tree_name):
    rtree, ttree = _tree_pair(tree_name)
    rp, tp = rpacking.packer_for(rtree, TILE_D), packing.packer_for(ttree)
    assert (tp.offsets, tp.sizes, tp.n_pad, tp.n_params) == \
        (rp.offsets, rp.sizes, rp.n_pad, rp.n_params)
    assert all(off % TILE_D == 0 for off in tp.offsets)
    if tree_name == "mlp":
        assert tp.n_pad == 106_496 and tp.n_params == 101_770
    else:
        assert tp.n_pad == 4 * TILE_D and tp.n_params == 15 + 2048 + 2049
    np.testing.assert_array_equal(tp.pack(ttree).numpy(), np.asarray(rp.pack(rtree)))
    assert packing.packer_for(ttree) is tp
    buf = tp.pack(ttree)
    for w in range(buf.shape[0]):
        back = tp.unpack(buf[w])
        for k in ttree:
            assert torch.equal(back[k], ttree[k][w])
    flat = stack_flatten_workers(ttree)
    key = sorted(ttree)[1]
    assert torch.equal(unflatten_like(flat[1], {k: v[1] for k, v in ttree.items()})[key],
                       ttree[key][1])


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("agg,kwargs", RULES, ids=[r[0] for r in RULES])
@pytest.mark.parametrize("mixing_name", MIXINGS)
def test_packed_aggregate_matches(agg, kwargs, mixing_name, use_kernels):
    x = _xs((10, 700), seed=7)
    rra = raragg.RobustAggregator.from_spec(agg, mixing=mixing_name, s=2, **kwargs)
    tra = aragg.RobustAggregator.from_spec(agg, mixing=mixing_name, s=2, **kwargs)
    key = jax.random.PRNGKey(3)
    expect = np.asarray(rpacking.packed_aggregate(jnp.asarray(x), rra, key=key,
                                                  block_d=TILE_D))
    mix = torch.tensor(np.asarray(rra.mixing_matrix(key, 10)))
    out, info = packing.packed_aggregate(torch.tensor(x), tra, mix=mix,
                                         use_kernels=use_kernels, with_info=True)
    assert out.shape == (700,)
    np.testing.assert_allclose(out.numpy(), expect, rtol=2e-4, atol=2e-4)
    assert ("agg_weights" in info) == (agg not in ("cm", "tm"))


def test_packed_sync_rejects_mesh_and_handles_empty_tree():
    ra = aragg.RobustAggregator.from_spec("rfa", mixing="none")
    with pytest.raises(TypeError, match="ProcessGroup"):
        packing.packed_robust_sync([torch.zeros(4, 8)], ra, mesh=object())
    # without a mesh the placements are ignored, as the reference ignores them
    xs = [torch.arange(32, dtype=torch.float32).reshape(4, 8)]
    plain, _ = packing.packed_robust_sync(xs, ra)
    placed, _ = packing.packed_robust_sync(xs, ra, out_shardings=[None])
    assert torch.equal(plain[0], placed[0])
    out, info = packing.packed_robust_sync({"e": torch.zeros(4, 0)}, ra)
    assert out["e"].shape == (0,) and info == {}


# ------------------------------------------------------------ port hygiene
def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("*_torch.py")))
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import make_train_test
    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.models import transformer
    from repro_torch.models.mlp import nll_loss
    from repro_torch.serving import ServeEngine
    from repro_torch.training.cross_device import CrossDeviceSim

    cfg = smoke_config("tinyllama-1.1b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = [
        lambda: repro_torch.resolve_device(),
        lambda: init_mlp(torch.Generator().manual_seed(0)),
        lambda: make_train_test(torch.Generator().manual_seed(0), n_train=10, n_test=10),
        lambda: mixing.Bucketing(2).matrix(4),
        lambda: CrossDeviceSim(loss_fn=nll_loss, byz=ByzConfig(), n_clients=4,
                               byz_frac=0.0, clients_per_round=2),
        lambda: transformer.init_params(cfg, torch.Generator().manual_seed(0)),
        lambda: transformer.init_cache(cfg, 1, 8),
        lambda: make_prefill_step(cfg)(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)}),
        lambda: ServeEngine(cfg, params),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert init_mlp(torch.Generator().manual_seed(0), device="cpu")["w0"].device.type == "cpu"


def test_init_mlp_matches_reference_shapes_and_scale():
    r = rinit_mlp(jax.random.PRNGKey(0))
    t = init_mlp(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(t) == sorted(r)
    for k in r:
        assert tuple(t[k].shape) == r[k].shape and t[k].dtype == torch.float32
    assert abs(float(t["w0"].std()) - float(jnp.std(r["w0"]))) < 2e-3
