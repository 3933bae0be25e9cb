"""The port's multi-rank aggregation engine (``mesh=`` on
``repro_torch.dist.robust``) against the single-device port and the
reference, on the CPU: the first of the three worlds of the
sharded-runtime tests (the others are ``test_torch_sharded_train.py``
and ``test_torch_sharded_replicate.py``; their shared half is
``tests/torch_shard_world.py``).

A ``(2, 2)`` mesh of gloo processes over a ``FileStore`` (spawned by
``repro_torch.dist.mesh.run_on_mesh``, one thread each) runs the
distance-backend tree of ``tests/test_distance_backend.py`` (``a/w (8,
8, 16)``, ``b (8, 64)``, ``c (8, 2, 3, 4)`` and the indivisible ``v (8,
5)``, which stays whole on every rank): ``pairwise_sq_dists_tree`` under
every backend, ``distributed_aggregate`` for eight rules and four
stateful ones over three calls, and the attacks on the slices.  The
reference runs its engine part in a subprocess with 4 host devices (its
mesh ``make_host_mesh((2, 2))``) beside it: its shard-mapped Pallas
distance pass (interpret mode) and aggregates on the same tree.

Tolerances: distances and aggregates at 1e-4 (the reference's own for
its shard-mapped pass).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_shard_cases as cases  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist import robust  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from torch_shard_world import (F, _close, _FakeMesh, _whole,  # noqa: E402
                               finish_reference, make_inputs,
                               start_reference)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The engine world's results and the reference's, computed once."""
    inputs = make_inputs()
    proc, path = start_reference("engine", inputs,
                                 tmp_path_factory.mktemp("sharded"))
    try:
        engine = run_on_mesh(cases.engine_case, (2, 2),
                             args=(inputs["tree"], F), device="cpu",
                             num_threads=1, timeout=300)
    finally:
        ref = finish_reference(proc, path)
    return {"engine": engine, "ref": ref, "inputs": inputs}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_every_rank_sees_its_own_coordinates(world):
    coords = [r["coords"] for r in world["engine"]]
    assert coords == [{"data": i, "model": j} for i in (0, 1)
                      for j in (0, 1)]


@pytest.mark.parametrize("backend", ["xla", "pallas", "auto", "fused"])
def test_sharded_dists_match(world, backend):
    tree = _whole(world["inputs"]["tree"])
    want = robust.pairwise_sq_dists_tree(tree, distance_backend="xla")
    ref = world["ref"]["dists"]
    for r in world["engine"]:
        got = r["dists"][backend]
        assert torch.equal(got, world["engine"][0]["dists"][backend])
        assert float((got - want).abs().max()) < 1e-4
        assert float(np.max(np.abs(got.numpy() - ref))) < 1e-4
    # on CPU tensors "auto" is the xla pass; "fused" degrades to pallas
    r0 = world["engine"][0]
    assert (r0["resolved_auto"], r0["resolved_fused"]) == ("xla", "pallas")
    assert robust.resolve_distance_backend(
        "auto", _FakeMesh((1, 2)), "cuda") == "pallas"
    assert robust.resolve_distance_backend(
        "auto", _FakeMesh((4, 1)), "cuda") == "xla"
    assert robust.resolve_distance_backend("fused", _FakeMesh((4, 1))) == (
        "fused")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("gar", cases.ENGINE_RULES)
def test_sharded_aggregate_matches(world, gar, backend):
    tree = _whole(world["inputs"]["tree"])
    want, wres = robust.distributed_aggregate(tree, F, gar,
                                              distance_backend=backend)
    for r in world["engine"]:
        got, sel = r["agg"][(gar, backend)]
        assert torch.equal(sel, wres.selected)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert float((a - b).abs().max()) < 1e-4
    if ("agg", gar) in world["ref"]:
        jagg, jsel = world["ref"][("agg", gar)]
        got, sel = world["engine"][0]["agg"][(gar, backend)]
        np.testing.assert_array_equal(sel.numpy(), jsel)
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(jagg)):
            assert float(np.max(np.abs(a.numpy() - b))) < 1e-4


@pytest.mark.parametrize("gar", cases.STATEFUL_RULES)
def test_sharded_stateful_rules_match(world, gar):
    tree = _whole(world["inputs"]["tree"])
    state = None
    for t in range(3):
        step_tree = {k: (v * (1.0 + 0.25 * t) if not isinstance(v, dict)
                         else {kk: vv * (1.0 + 0.25 * t)
                               for kk, vv in v.items()})
                     for k, v in tree.items()}
        want, wres, state = robust.distributed_aggregate(
            step_tree, F, gar, distance_backend="pallas", state=state)
        for r in world["engine"]:
            got, sel = r["stateful"][gar][t]
            assert torch.equal(sel, wres.selected), (gar, t)
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                _close(a, b, what=(gar, t))


@pytest.mark.parametrize("i", range(len(cases.ATTACKS)))
def test_sharded_attacks_match(world, i):
    attack, kw = cases.ATTACKS[i]
    tree = _whole(world["inputs"]["tree"])
    want = robust.inject_byzantine(tree, F, attack, **kw)
    jwant = jrobust.inject_byzantine(
        jax.tree_util.tree_map(np.asarray, world["inputs"]["tree"]), F,
        attack, **kw)
    for r in world["engine"]:
        got = r["attack"][i]
        for a, b, c in zip(tree_leaves(got), tree_leaves(want),
                           jax.tree_util.tree_leaves(jwant)):
            _close(a, b, what=(attack, kw))
            _close(a, np.asarray(c), what=(attack, kw, "reference"))


def test_random_attack_draws_per_leaf_and_slice(world):
    """Each leaf's draw and each rank's slice of it are the single-device
    port's from the same generator, bit for bit (the reference's
    ``jax.random`` stream differs); the honest rows stay untouched."""
    tree = _whole(world["inputs"]["tree"])
    want = robust.inject_byzantine(tree, F, "random",
                                   torch.Generator().manual_seed(5))
    for r in world["engine"]:
        for a, b in zip(tree_leaves(r["random"]), tree_leaves(want)):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(want), tree_leaves(tree)):
        assert torch.equal(a[:-F], b[:-F]) and not torch.equal(a[-F:],
                                                               b[-F:])


def test_colluding_random_direction_matches_the_single_device_port(world):
    """``colluding_majority``'s random direction: the same draw, and its
    norm over the whole tree, as on one device (the rows differ only by
    the order of delta_bar's reduction over the ranks)."""
    tree = _whole(world["inputs"]["tree"])
    want = robust.inject_byzantine(tree, F, "colluding_majority",
                                   torch.Generator().manual_seed(6))
    for r in world["engine"]:
        for a, b in zip(tree_leaves(r["colluding_random"]),
                        tree_leaves(want)):
            assert torch.equal(a[:-F], b[:-F])
            _close(a, b, what="colluding_majority")
