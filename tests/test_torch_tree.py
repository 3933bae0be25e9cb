"""Port parity of the tree aggregation engine: ``repro_torch.dist.robust``
(with ``agg/tree.py``, the tree half of ``agg/fused.py`` and
``kernels/pairwise_gram.py::pairwise_gram_tree``) against the JAX
reference's ``repro.dist.robust`` on the same numpy trees.

Every stateless rule runs under the three distance backends (``xla``,
``pallas``: the port's K1, ``fused``: the port's selection kernel and K4
per leaf, or K5 for one leaf), on single- and multi-leaf trees, with
fp32 and bf16 leaves and both accumulation dtypes; on the CPU the
port's kernel wrappers take their plain versions and the reference's
Pallas kernels run in interpret mode.  Aggregates agree at 1e-4 (fp32)
or 5e-2 (bf16) relative to ``max(1, max |want|)``, and ``selected``
exactly.  Honest workers get distinct spreads, so no two selection
scores come near a tie; the f Byzantine rows are identical and tie
exactly, which both packages break toward the first index.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.agg.fused import fused_name as jax_fused_name  # noqa: E402
from repro.agg.specs import AggSpec as JaxSpec  # noqa: E402
from repro.agg.specs import check_quorum as jax_check_quorum  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro.kernels.pairwise_gram import (  # noqa: E402
    pairwise_gram_tree as jax_gram_tree)
from repro_torch.agg.fused import fused_name  # noqa: E402
from repro_torch.agg.registry import resolve_rule  # noqa: E402
from repro_torch.agg.specs import AggSpec, check_quorum  # noqa: E402
from repro_torch.core.pytree import stack_flatten, tree_leaves  # noqa: E402
from repro_torch.dist import robust  # noqa: E402
from repro_torch.kernels.pairwise_gram import pairwise_gram_tree  # noqa: E402

N, F = 11, 2
FP32_TOL = 1e-4
BF16_TOL = 5e-2
BACKENDS = ("xla", "pallas", "fused")
RULES = ("average", "krum", "multikrum", "geomed", "cwmed",
         "trimmed_mean", "bulyan-krum", "bulyan-geomed")
MULTI = {"w": (6, 5), "b": (7,), "c": (2, 3, 4)}
SINGLE = {"w": (6, 5)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tree(shapes, seed=0, n=N, f=F):
    """Worker-stacked numpy leaves: honest worker i spreads 0.5 + 0.1 i
    around a shared mean; the last f rows are one identical Byzantine
    row just off the honest mean."""
    rng = np.random.default_rng(seed)
    spread = 0.5 + 0.1 * np.arange(n)
    out = {}
    for k in sorted(shapes):
        shape = shapes[k]
        mu = rng.standard_normal(shape)
        x = mu[None] + spread.reshape((n,) + (1,) * len(shape)) * (
            rng.standard_normal((n,) + shape))
        if f:
            x[n - f:] = x[:n - f].mean(axis=0) + 0.3
        out[k] = x.astype(np.float32)
    return out


def _to_jax(tree, dtype="float32"):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _to_torch(tree, dtype="float32"):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return {k: torch.from_numpy(v).to(dt) for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, (err, scale)


def _parity(np_tree, gar, dtype="float32", **kw):
    """Run both engines on the same tree and compare everything."""
    jagg, jres = jrobust.distributed_aggregate(_to_jax(np_tree, dtype), F,
                                               gar, **kw)
    ttree = _to_torch(np_tree, dtype)
    tagg, tres = robust.distributed_aggregate(ttree, F, gar, **kw)
    tol = FP32_TOL if dtype == "float32" and kw.get(
        "agg_dtype", "native") != "bfloat16" else BF16_TOL
    assert sorted(tagg) == sorted(jagg)
    for k in tagg:
        assert tagg[k].dtype == ttree[k].dtype
        _close(tagg[k], jagg[k], tol)
    assert np.array_equal(_np(tres.selected), _np(jres.selected)), (
        _np(tres.selected), _np(jres.selected))
    _close(tres.scores, jres.scores, tol)
    return tagg, tres


# ---------------------------------------------------------------------------
# distributed_aggregate against the reference
# ---------------------------------------------------------------------------

class TestDistributedAggregate:
    @pytest.mark.parametrize("gar", RULES)
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_multi_leaf(self, backend, gar):
        _parity(_tree(MULTI, seed=1), gar, distance_backend=backend)

    @pytest.mark.parametrize("gar", RULES)
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_single_leaf(self, backend, gar):
        _parity(_tree(SINGLE, seed=2), gar, distance_backend=backend)

    @pytest.mark.parametrize("gar", ["krum", "multikrum", "cwmed",
                                     "bulyan-krum"])
    @pytest.mark.parametrize("agg_dtype", ["native", "bfloat16"])
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_bf16_leaves(self, backend, agg_dtype, gar):
        _parity(_tree(MULTI, seed=3), gar, "bfloat16",
                distance_backend=backend, agg_dtype=agg_dtype)

    @pytest.mark.parametrize("gar", ["trimmed_mean", "geomed"])
    def test_fp32_leaves_bf16_accumulation(self, gar):
        _parity(_tree(MULTI, seed=4), gar, agg_dtype="bfloat16",
                distance_backend="xla")

    @pytest.mark.parametrize("window", [None, 7, 64, 0])
    @pytest.mark.parametrize("gar", ["bulyan-krum", "bulyan-geomed"])
    def test_window(self, gar, window):
        _parity(_tree(MULTI, seed=5), gar, window=window,
                distance_backend="pallas")

    @pytest.mark.parametrize("gar", RULES)
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_tree_equals_flat_rule(self, backend, gar):
        """The reference's contract, on the port alone: the tree result
        is the flat rule on ``stack_flatten`` of the same tree."""
        ttree = _to_torch(_tree(MULTI, seed=6))
        agg, res = robust.distributed_aggregate(ttree, F, gar,
                                                distance_backend=backend)
        flat, _ = stack_flatten(ttree)
        want = resolve_rule(gar).dense_fn(flat, F)
        got = torch.cat([leaf.reshape(-1) for leaf in tree_leaves(agg)])
        _close(got, want.gradient, FP32_TOL)
        assert torch.equal(res.selected, want.selected)

    def test_list_and_tensor_trees(self):
        np_tree = _tree(MULTI, seed=7)
        ttree = _to_torch(np_tree)
        as_dict, _ = robust.distributed_aggregate(ttree, F, "bulyan-krum")
        as_list, _ = robust.distributed_aggregate(
            [ttree[k] for k in sorted(ttree)], F, "bulyan-krum")
        assert isinstance(as_list, list)
        for a, k in zip(as_list, sorted(ttree)):
            assert torch.equal(a, as_dict[k])
        one, _ = robust.distributed_aggregate(ttree["w"], F, "krum")
        assert one.shape == ttree["w"].shape[1:]

    def test_spans_name_the_profile(self):
        ttree = _to_torch(_tree(MULTI, seed=8))
        with torch.profiler.profile() as prof:
            robust.distributed_aggregate(ttree, F, "bulyan-krum")
        names = {ev.key for ev in prof.key_averages()}
        assert {"agg/gram", "agg/select", "agg/coordinate"} <= names


class TestDistances:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
    def test_pairwise_sq_dists_tree(self, backend, cdt):
        np_tree = _tree(MULTI, seed=9)
        jdt = jnp.bfloat16 if cdt == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if cdt == "bfloat16" else torch.float32
        want = jrobust.pairwise_sq_dists_tree(
            _to_jax(np_tree), jdt, distance_backend=backend)
        got = robust.pairwise_sq_dists_tree(_to_torch(np_tree), tdt,
                                            distance_backend=backend)
        assert got.dtype == tdt
        _close(got, want, FP32_TOL if cdt == "float32" else BF16_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_pairwise_gram_tree(self, dtype):
        np_tree = _tree({"a": (3, 50), "b": (10,), "c": (300,)}, seed=10)
        want = jax_gram_tree(_to_jax(np_tree, dtype), block_d=128,
                             interpret=True)
        got = pairwise_gram_tree(_to_torch(np_tree, dtype), block_d=128)
        _close(got, want, FP32_TOL if dtype == "float32" else BF16_TOL)

    @pytest.mark.parametrize("theta,f,window", [(7, 2, None), (7, 2, 5),
                                                (9, 2, 13), (5, 0, 3)])
    def test_coordinate_phase_nd(self, theta, f, window):
        x = np.random.default_rng(theta).standard_normal(
            (theta, 4, 9)).astype(np.float32)
        want = jrobust.coordinate_phase_nd(jnp.asarray(x), f, window=window)
        got = robust.coordinate_phase_nd(torch.from_numpy(x), f,
                                         window=window)
        assert got.shape == (4, 9)
        _close(got, want, FP32_TOL)

    def test_resolve_distance_backend(self):
        for name in ("xla", "pallas", "fused", "auto"):
            assert robust.resolve_distance_backend(name) == (
                jrobust.resolve_distance_backend(name))

    @pytest.mark.parametrize("gar", ["krum", "bulyan-geomed", "cwmed",
                                     "average", "fused-krum", "geomed"])
    def test_fused_name(self, gar):
        assert fused_name(gar) == jax_fused_name(gar)

    def test_fused_name_of_a_wrapper_is_not_ported(self):
        """The wrapper prefixes are ported: the fused name keeps them."""
        for gar in ("stale-krum", "stale-exp-bulyan-krum", "buffered-cwmed",
                    "reputation-stale-krum", "obs-krum", "stale-brute",
                    "stale-fused-krum"):
            assert fused_name(gar) == jax_fused_name(gar)
        assert fused_name("stale-krum") == "stale-fused-krum"


# ---------------------------------------------------------------------------
# inject_byzantine against the reference
# ---------------------------------------------------------------------------

ATTACKS = [
    ("signflip", {}), ("signflip", {"scale": 3.0}), ("zero", {}),
    ("mimic", {"target": 2}), ("ipm", {"eps": 0.7}), ("alie", {}),
    ("alie", {"z": 1.5}),
    ("omniscient_linf", {}),
    ("omniscient_linf", {"gamma": "closed", "direction": "anti",
                         "margin": 0.8}),
    ("omniscient_linf", {"gamma": 2.5, "direction": "anti"}),
    ("omniscient_lp", {"coord": 40}),
    ("omniscient_lp", {"coord": "rotate", "step": 95}),
    ("omniscient_lp", {"coord": "top", "gamma": "closed"}),
    ("omniscient_lp", {"coord": 3, "gar_name": "geomed", "margin": 0.5}),
    ("omniscient_lp", {"coord": 12, "gamma": 4.0}),
]


class TestInjectByzantine:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("attack,kw", ATTACKS)
    def test_matches_reference(self, attack, kw, dtype):
        np_tree = _tree(MULTI, seed=11, f=0)
        want = jrobust.inject_byzantine(_to_jax(np_tree, dtype), F, attack,
                                        **kw)
        ttree = _to_torch(np_tree, dtype)
        got = robust.inject_byzantine(ttree, F, attack, **kw)
        tol = FP32_TOL if dtype == "float32" else BF16_TOL
        for k in got:
            assert got[k].dtype == ttree[k].dtype
            assert torch.equal(got[k][:N - F], ttree[k][:N - F])
            _close(got[k], want[k], tol)

    def test_attack_on_the_tree_matches_the_flat_attack(self):
        """Per-leaf linf with the closed-form gamma equals the flat attack
        on ``stack_flatten`` of the honest rows (the Fig. 4 attack)."""
        from repro_torch.core.attacks import omniscient_linf
        ttree = _to_torch(_tree(MULTI, seed=12, f=0))
        kw = dict(gamma="closed", direction="anti", margin=0.8)
        tree = robust.inject_byzantine(ttree, F, "omniscient_linf", **kw)
        flat, _ = stack_flatten(tree)
        honest, _ = stack_flatten({k: v[:N - F] for k, v in ttree.items()})
        _close(flat[N - F:], omniscient_linf(honest, F, **kw), FP32_TOL)

    @pytest.mark.parametrize("attack", ["random", "stale_replay",
                                        "slow_drift", "reputation_burn",
                                        "colluding_majority"])
    def test_unported_attacks_raise(self, attack):
        """These attacks are ported now: each runs per leaf and matches the
        reference (``random`` draws from another PRNG, so it is held to
        ``10 * randn`` from the same torch generator)."""
        np_tree = _tree(MULTI, f=0)
        ttree = _to_torch(np_tree)
        kw = {"step": 7} if attack == "reputation_burn" else {}
        if attack == "colluding_majority":
            kw = {"direction": "anti"}
        got = robust.inject_byzantine(ttree, F, attack, **kw)
        if attack == "random":
            gen = torch.Generator().manual_seed(0)
            for k in sorted(got):
                want = 10.0 * torch.randn((F,) + got[k].shape[1:],
                                          generator=gen)
                assert torch.equal(got[k][N - F:], want)
                assert torch.equal(got[k][:N - F], ttree[k][:N - F])
            return
        want = jrobust.inject_byzantine(_to_jax(np_tree), F, attack, **kw)
        for k in got:
            _close(got[k], want[k], FP32_TOL)

    def test_noops_and_error_texts(self):
        ttree = _to_torch(_tree(MULTI, f=0))
        assert robust.inject_byzantine(ttree, 0, "signflip") is ttree
        assert robust.inject_byzantine(ttree, F, "none") is ttree
        jtree = _to_jax(_tree(MULTI, f=0))
        for args, kw in (((N, "signflip"), {}),
                         ((F, "no_such_attack"), {}),
                         ((F, "omniscient_lp"), {"coord": 10 ** 6})):
            with pytest.raises((ValueError, KeyError)) as want:
                jrobust.inject_byzantine(jtree, *args, **kw)
            with pytest.raises(want.type) as got:
                robust.inject_byzantine(ttree, *args, **kw)
            assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the reference's error texts
# ---------------------------------------------------------------------------

def _same_error(jcall, tcall):
    with pytest.raises((ValueError, KeyError)) as want:
        jcall()
    with pytest.raises(want.type) as got:
        tcall()
    assert str(got.value) == str(want.value)


class TestErrors:
    def test_unknown_backend(self):
        np_tree = _tree(MULTI)
        _same_error(
            lambda: jrobust.distributed_aggregate(
                _to_jax(np_tree), F, "krum", distance_backend="cuda"),
            lambda: robust.distributed_aggregate(
                _to_torch(np_tree), F, "krum", distance_backend="cuda"))

    def test_unknown_agg_dtype(self):
        np_tree = _tree(MULTI)
        _same_error(
            lambda: jrobust.distributed_aggregate(
                _to_jax(np_tree), F, "krum", agg_dtype="fp8"),
            lambda: robust.distributed_aggregate(
                _to_torch(np_tree), F, "krum", agg_dtype="fp8"))

    def test_empty_tree(self):
        _same_error(lambda: jrobust.distributed_aggregate({}, F, "krum"),
                    lambda: robust.distributed_aggregate({}, F, "krum"))
        _same_error(lambda: jax_gram_tree({}),
                    lambda: pairwise_gram_tree({}))

    def test_mismatched_worker_axis(self):
        np_tree = {"a": np.zeros((N, 3), np.float32),
                   "b": np.zeros((N - 1, 3), np.float32)}
        _same_error(
            lambda: jrobust.distributed_aggregate(_to_jax(np_tree), F,
                                                  "krum"),
            lambda: robust.distributed_aggregate(_to_torch(np_tree), F,
                                                 "krum"))

    @pytest.mark.parametrize("gar", ["bulyan-cwmed", "bulyan-multikrum",
                                     "bulyan-trimmed_mean"])
    def test_distributed_bulyan_needs_a_distance_base(self, gar):
        np_tree = _tree(MULTI)
        _same_error(
            lambda: jrobust.distributed_aggregate(_to_jax(np_tree), F, gar),
            lambda: robust.distributed_aggregate(_to_torch(np_tree), F,
                                                 gar))

    @pytest.mark.parametrize("gar,n,f", [("krum", 6, 2),
                                         ("bulyan-krum", 10, 2),
                                         ("multikrum", 6, 2)])
    def test_quorum(self, gar, n, f):
        np_tree = _tree(SINGLE, n=n, f=0)
        _same_error(
            lambda: jrobust.distributed_aggregate(_to_jax(np_tree), f, gar),
            lambda: robust.distributed_aggregate(_to_torch(np_tree), f,
                                                 gar))

    def test_unknown_gar(self):
        from repro.agg import registry as jreg
        from repro_torch.agg import registry as treg
        np_tree = _tree(SINGLE)
        with pytest.raises(KeyError) as want:
            jrobust.distributed_aggregate(_to_jax(np_tree), F, "no-such")
        with pytest.raises(KeyError) as got:
            robust.distributed_aggregate(_to_torch(np_tree), F, "no-such")
        # same template; each package lists its own registered rules
        assert str(got.value) == str(want.value).replace(
            repr(sorted(jreg.RULES)), repr(sorted(treg.RULES)))

    @pytest.mark.parametrize("distributed", [False, True])
    @pytest.mark.parametrize("gar,n,f", [("bulyan-cwmed", 11, 2),
                                         ("bulyan-krum", 11, 2),
                                         ("bulyan", 10, 2),
                                         ("fused-bulyan-geomed", 9, 2),
                                         ("trimmed_mean", 4, 2)])
    def test_check_quorum(self, gar, n, f, distributed):
        try:
            jax_check_quorum(gar, n, f, distributed=distributed)
        except (KeyError, ValueError) as e:
            with pytest.raises(type(e)) as got:
                check_quorum(gar, n, f, distributed=distributed)
            assert str(got.value) == str(e)
        else:
            check_quorum(gar, n, f, distributed=distributed)

    def test_mesh_is_not_ported(self):
        """The mesh path is ported (ROADMAP item 6; the multi-rank cases
        are ``tests/test_torch_sharded.py``): a one-position mesh runs the
        single-device aggregation bit for bit."""
        from repro_torch.dist.mesh import make_host_mesh
        tree = _to_torch(_tree(MULTI))
        for backend in ("xla", "pallas", "fused"):
            got, gres = robust.distributed_aggregate(
                tree, F, "bulyan-krum", distance_backend=backend,
                mesh=make_host_mesh(device="cpu"))
            want, wres = robust.distributed_aggregate(
                tree, F, "bulyan-krum", distance_backend=backend)
            assert torch.equal(gres.selected, wres.selected)
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert torch.equal(a, b)

    def test_spec_fields(self):
        s, j = AggSpec(f=2), JaxSpec(f=2)
        assert (s.agg_dtype, s.distance_backend) == (j.agg_dtype,
                                                     j.distance_backend)

    @pytest.mark.parametrize("agg_dtype", ["native", "bfloat16"])
    @pytest.mark.parametrize("backend", ["auto", *BACKENDS])
    def test_spec_aggregate_tree(self, backend, agg_dtype):
        """The spec's fields reach the engine as the reference's
        distributed trainer passes them."""
        np_tree = _tree(MULTI, seed=9)
        kw = dict(f=F, declared_f=F, gar="bulyan-krum", agg_dtype=agg_dtype,
                  distance_backend=backend)
        tagg, tres = AggSpec(**kw).aggregate_tree(_to_torch(np_tree),
                                                  window=16)
        direct, _ = robust.distributed_aggregate(
            _to_torch(np_tree), F, "bulyan-krum", agg_dtype=agg_dtype,
            window=16, distance_backend=backend)
        j = JaxSpec(**kw)
        jagg, jres = jrobust.distributed_aggregate(
            _to_jax(np_tree), j.f_declared, j.gar, agg_dtype=j.agg_dtype,
            window=16, distance_backend=j.distance_backend)
        tol = FP32_TOL if agg_dtype == "native" else BF16_TOL
        for k in tagg:
            assert torch.equal(tagg[k], direct[k])
            _close(tagg[k], jagg[k], tol)
        assert np.array_equal(_np(tres.selected), _np(jres.selected))

    def test_spec_unknown_backend_raises(self):
        spec = AggSpec(f=F, gar="krum", distance_backend="cuda")
        with pytest.raises(ValueError, match="distance_backend must be"):
            spec.aggregate_tree(_to_torch(_tree(MULTI)))
