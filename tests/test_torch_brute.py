"""Port parity of the flat core's last rules: Brute (dense and tree),
Bulyan over all four bases, the literal coordinate phase, centered
clipping, ``aggregate_pytree`` and the stateless attacks, against the JAX
reference on the same numpy inputs.  Aggregates and scores agree at
1e-4 relative to ``max(1, max |want|)``, selections exactly.
``random_noise`` draws from another PRNG than ``jax.random``, so it is
held to ``scale * randn`` from the same torch generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.agg import registry as jreg  # noqa: E402
from repro.core import attacks as jatk  # noqa: E402
from repro.core import bulyan as jbul  # noqa: E402
from repro.core import gars as jgars  # noqa: E402
from repro.core import pytree as jpt  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro_torch.agg import registry as treg  # noqa: E402
from repro_torch.core import attacks as tatk  # noqa: E402
from repro_torch.core import bulyan as tbul  # noqa: E402
from repro_torch.core import gars as tgars  # noqa: E402
from repro_torch.core import pytree as tpt  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.dist import robust as trobust  # noqa: E402

TOL = 1e-4
BRUTE_NF = [(7, 2), (11, 5)]
BACKENDS = ["xla", "pallas", "fused"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _stack(n, d, seed=5):
    """Honest worker i spreads 0.3 + 0.1 i around a shared mean, so no two
    subset diameters or selection scores come near a tie."""
    rng = np.random.default_rng(seed)
    spread = 0.3 + 0.1 * np.arange(n)
    return (1.0 + rng.standard_normal(d)[None]
            + spread[:, None] * rng.standard_normal((n, d))).astype(
                np.float32)


def _grid_stack(n, d, seed=5):
    """:func:`_stack` on a 0.25 grid, where every sum, square and mean by
    a power of two below is exact in fp32.  Bulyan(brute)'s last pick
    needs it: at ``n_rem - f = 2`` the best subset is a pair, whose mean
    is equidistant from both members, so the pick is a tie.  In the
    reference rounding breaks it, and eager and ``jax.jit`` execution
    break it differently (worker 5 and worker 3 on ``_stack(7, 30, 2)``);
    on the grid the tie is exact and the first index wins everywhere."""
    return (np.round(_stack(n, d, seed) * 4.0) / 4.0).astype(np.float32)


def _close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    scale = max(1.0, float(np.max(np.abs(want[finite]), initial=0.0)))
    err = np.max(np.abs(got[finite] - want[finite]), initial=0.0)
    assert err <= tol * scale, (err, scale)


def _same_result(got, want):
    _close(got.gradient.numpy(), np.asarray(want.gradient))
    assert np.array_equal(got.selected.numpy(), np.asarray(want.selected))
    _close(got.scores.numpy(), np.asarray(want.scores))


class TestBrute:
    @pytest.mark.parametrize("n,f", BRUTE_NF)
    def test_dense(self, n, f):
        g = _stack(n, 40, seed=n)
        want = jgars.brute(jnp.asarray(g), f)
        got = tgars.brute(torch.from_numpy(g), f)
        _same_result(got, want)

    @pytest.mark.parametrize("n,f", BRUTE_NF)
    def test_subset_diameters(self, n, f):
        d2 = np.asarray(jgars.pairwise_sq_dists(jnp.asarray(_stack(n, 30))))
        want = jgars.brute_subset_diameters(jnp.asarray(d2), n, f)
        got = tgars.brute_subset_diameters(torch.from_numpy(d2), n, f)
        _close(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("n,f", BRUTE_NF)
    def test_tree(self, n, f, backend):
        """Brute has no fused lowering: under ``fused`` it runs unchanged
        over the distance kernel, as in the reference."""
        g = _stack(n, 33, seed=n + 1)
        tree = {"w": g[:, :20].reshape(n, 4, 5), "b": g[:, 20:]}
        jagg, jres = jrobust.distributed_aggregate(
            {k: jnp.asarray(v) for k, v in tree.items()}, f, "brute",
            distance_backend=backend)
        tagg, tres = trobust.distributed_aggregate(
            {k: torch.from_numpy(v) for k, v in tree.items()}, f, "brute",
            distance_backend=backend)
        for k in tree:
            _close(tagg[k].numpy(), np.asarray(jagg[k]))
        assert np.array_equal(tres.selected.numpy(),
                              np.asarray(jres.selected))
        _close(tres.scores.numpy(), np.asarray(jres.scores))

    @pytest.mark.parametrize("n,f", BRUTE_NF)
    def test_tree_equals_flat(self, n, f):
        g = _stack(n, 30, seed=3)
        tagg, _ = trobust.distributed_aggregate(
            {"a": torch.from_numpy(g[:, :11]),
             "b": torch.from_numpy(g[:, 11:])}, f, "brute")
        flat = tgars.brute(torch.from_numpy(g), f).gradient
        _close(torch.cat([tagg["a"], tagg["b"]]).numpy(), flat.numpy())

    def test_quorum_error(self):
        g = _stack(6, 5)
        with pytest.raises(ValueError) as want:
            jgars.brute(jnp.asarray(g), 3)
        with pytest.raises(ValueError) as got:
            tgars.brute(torch.from_numpy(g), 3)
        assert str(got.value) == str(want.value)


class TestBulyanBases:
    @pytest.mark.parametrize("base,n,f", [
        (b, n, f) for b in ("krum", "geomed", "average")
        for n, f in ((7, 1), (11, 2))] + [("brute", 7, 1), ("brute", 9, 1)])
    def test_select_indices(self, base, n, f):
        g = _grid_stack(n, 25, seed=n)
        want = jbul.select_indices(jnp.asarray(g), f, base=base)
        got = tbul.select_indices(torch.from_numpy(g), f, base=base)
        assert np.array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("name", ["bulyan-brute", "bulyan-average",
                                      "bulyan-krum", "bulyan-geomed"])
    def test_dense_rule(self, name):
        g = _grid_stack(7, 30, seed=2)
        want = jreg.resolve_rule(name).dense_fn(jnp.asarray(g), 1)
        got = treg.resolve_rule(name).dense_fn(torch.from_numpy(g), 1)
        _same_result(got, want)

    @pytest.mark.parametrize("name", ["bulyan-brute", "bulyan-average"])
    def test_dense_only(self, name):
        """Like the reference's, their phase 1 needs the rows, so they
        have no tree implementation."""
        assert treg.resolve_rule(name).tree_fn is None
        assert jreg.resolve_rule(name).tree_fn is None
        tree = {"a": torch.from_numpy(_stack(7, 4))}
        with pytest.raises(KeyError) as want:
            jrobust.distributed_aggregate(
                {"a": jnp.asarray(_stack(7, 4))}, 1, name)
        with pytest.raises(KeyError) as got:
            trobust.distributed_aggregate(tree, 1, name)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("theta,f", [(5, 1), (9, 2), (13, 3), (7, 0)])
    def test_coordinate_phase_ref(self, theta, f):
        s = _stack(theta, 50, seed=theta)
        want = jbul.coordinate_phase_ref(jnp.asarray(s), f)
        got = tbul.coordinate_phase_ref(torch.from_numpy(s), f)
        _close(got.numpy(), np.asarray(want))
        # on untied data the literal form equals the windowed one
        _close(got.numpy(),
               tbul.coordinate_phase(torch.from_numpy(s), f).numpy())

    def test_make_bulyan_with_coordinate_impl(self):
        g = _stack(11, 40, seed=9)
        want = jbul.make_bulyan("geomed", jbul.coordinate_phase_ref)(
            jnp.asarray(g), 2)
        got = tbul.make_bulyan("geomed", tbul.coordinate_phase_ref)(
            torch.from_numpy(g), 2)
        _same_result(got, want)


class TestCenteredClip:
    @pytest.mark.parametrize("tau,iters", [(10.0, 3), (0.5, 5), (1e-3, 1)])
    def test_dense(self, tau, iters):
        g = _stack(9, 40, seed=4)
        g[-2:] *= 30.0
        want = jgars.centered_clip(jnp.asarray(g), 2, tau=tau, iters=iters)
        got = tgars.centered_clip(torch.from_numpy(g), 2, tau=tau,
                                  iters=iters)
        _same_result(got, want)

    @pytest.mark.parametrize("backend", ["xla", "fused"])
    def test_tree(self, backend):
        g = _stack(9, 30, seed=6) * 5.0
        tree = {"a": g[:, :12].reshape(9, 3, 4), "b": g[:, 12:]}
        jagg, _ = jrobust.distributed_aggregate(
            {k: jnp.asarray(v) for k, v in tree.items()}, 2,
            "centered_clip", distance_backend=backend)
        tagg, _ = trobust.distributed_aggregate(
            {k: torch.from_numpy(v) for k, v in tree.items()}, 2,
            "centered_clip", distance_backend=backend)
        for k in tree:
            _close(tagg[k].numpy(), np.asarray(jagg[k]))


class TestPytreeAndRegistry:
    @pytest.mark.parametrize("gar", ["brute", "centered_clip", "krum",
                                     "bulyan-average"])
    def test_aggregate_pytree(self, gar):
        g = _stack(7, 26, seed=8)
        tree = {"w": g[:, :20].reshape(7, 4, 5), "b": g[:, 20:]}
        jagg, jres = jpt.aggregate_pytree(
            {k: jnp.asarray(v) for k, v in tree.items()}, gar, 1)
        tagg, tres = tpt.aggregate_pytree(
            {k: torch.from_numpy(v) for k, v in tree.items()}, gar, 1)
        for k in tree:
            assert tagg[k].shape == tree[k].shape[1:]
            _close(tagg[k].numpy(), np.asarray(jagg[k]))
        _same_result(tres, jres)

    def test_rule_names_and_registry(self):
        assert treg.rule_names() == jreg.rule_names()
        assert sorted(tgars.REGISTRY) == sorted(jgars.REGISTRY)
        for name in treg.rule_names():
            for f in (0, 1, 4):
                assert tgars.quorum(name, f) == jgars.quorum(name, f)
            assert treg.resolve_rule(name).fn is (
                treg.resolve_rule(name).dense_fn)

    def test_gar_spec_and_attack_result(self):
        kw = dict(name="krum", min_n=lambda f: 2 * f + 3,
                  byzantine_resilient=True)
        with pytest.raises(ValueError) as want:
            jtypes.GarSpec(fn=jgars.krum, **kw).check_quorum(6, 2)
        with pytest.raises(ValueError) as got:
            ttypes.GarSpec(fn=tgars.krum, **kw).check_quorum(6, 2)
        assert str(got.value) == str(want.value)
        assert ttypes.AttackResult._fields == jtypes.AttackResult._fields


class TestStatelessAttacks:
    @pytest.mark.parametrize("name,kw", [
        ("alie", {}), ("alie", {"z": 0.7}), ("ipm", {}),
        ("ipm", {"eps": 2.0}), ("mimic", {}), ("mimic", {"target": 3})])
    @pytest.mark.parametrize("f", [1, 3])
    def test_matches_reference(self, name, kw, f):
        h = _stack(6, 30, seed=f)
        want = jatk.get_attack(name)(jnp.asarray(h), f, None, **kw)
        got = tatk.get_attack(name)(torch.from_numpy(h), f, None, **kw)
        assert got.shape == (f, 30)
        _close(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("n_h,f", [(5, 2), (30, 9), (6, 5)])
    def test_alie_default_z(self, n_h, f):
        """ALIE's z from n and f (``ndtri`` in fp32 in both)."""
        h = _stack(n_h, 12)
        want = jatk.alie(jnp.asarray(h), f)
        got = tatk.alie(torch.from_numpy(h), f)
        _close(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("scale", [10.0, 0.5])
    def test_random_noise(self, scale):
        h = torch.from_numpy(_stack(5, 17))
        got = tatk.random_noise(h, 3, torch.Generator().manual_seed(4),
                                scale=scale)
        want = scale * torch.randn((3, 17),
                                   generator=torch.Generator().manual_seed(4))
        assert torch.equal(got, want)
        jax_rows = jatk.random_noise(jnp.asarray(h.numpy()), 3,
                                     jax.random.PRNGKey(0), scale=scale)
        assert np.asarray(jax_rows).shape == tuple(got.shape)
