"""The port's multi-rank train steps (``make_train_step(mesh=)``,
``make_async_train_step(mesh=)``: the split forward over ``model``)
against the single-device port and the reference, on the CPU: the second
of the three worlds of the sharded-runtime tests (the shared half is
``tests/torch_shard_world.py``).

A ``(2, 2)`` mesh of gloo processes (``repro_torch.dist.mesh
.run_on_mesh``, one thread each) runs the train steps of reduced
llama3.2-3b with momentum SGD: ``f = 0`` ``bulyan-krum`` with n = 4 (the
reference's ``tests/test_dist.py`` setting), ``bulyan-krum`` under
``omniscient_linf`` with n = 8, f = 1, ``reputation-krum`` with a clean
``aux_batch``, and the asynchronous step at tau = 2 (``stale-``) and
tau = 0.  The reference runs its train part in a subprocess with 4 host
devices beside it: its single-device and sharded ``f = 0`` steps, and
its single-device attacked, reputation and asynchronous steps.

Tolerances: the ``f = 0`` step within the reference's own sharded-step
bounds (5e-2 on parameters, 1e-3 on the loss) and within the port's LLM
rule (``tests/torch_llm_compare.py``: each leaf's change at 1e-4 of its
largest, Bulyan window ties let off); the sharded port against the
single-device port at the same rule; the tau = 0 asynchronous step
equal to the synchronous one bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_shard_cases as cases  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from torch_llm_compare import scaled_close  # noqa: E402
from torch_shard_world import (_close, _hold_params, _init,  # noqa: E402
                               _leaves_np, _stale_ties, _ties,
                               finish_reference, make_inputs,
                               single_runs, start_reference)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The train world's results and the reference's, computed once."""
    inputs = make_inputs()
    proc, path = start_reference("train", inputs,
                                 tmp_path_factory.mktemp("sharded"))
    try:
        train = run_on_mesh(cases.train_case, (2, 2),
                            args=(inputs["params"], inputs["aux"],
                                  tuple(cases.TRAIN_CASES)),
                            device="cpu", num_threads=1, timeout=300)
    finally:
        ref = finish_reference(proc, path)
    return {"train": train, "ref": ref, "inputs": inputs}


@pytest.fixture(scope="module")
def single(world):
    return single_runs(world)


def test_f0_step_matches_the_reference(world):
    """The reference's own sharded-step setting: its single-device and
    sharded steps, within its bounds and within the port's rule."""
    ref, ref_mesh = world["ref"]["f0"], world["ref"]["f0_mesh"]
    port = world["train"][0]["f0"]
    for want in (ref, ref_mesh):
        last = _leaves_np(port[-1]["params"])
        diff = max(float(np.max(np.abs(a - b))) for a, b in
                   zip(last, _leaves_np(want[-1]["params"])))
        assert diff < 5e-2
        assert abs(port[-1]["metrics"]["loss"]
                   - want[-1]["metrics"]["loss"]) < 1e-3
        _hold_params(port, want, _init(world), what="f0")
        for t in range(2):
            for k, v in want[t]["metrics"].items():
                _close(port[t]["metrics"][k], v, what=(t, k))


def test_f0_step_matches_the_single_device_port(world, single):
    _hold_params(world["train"][0]["f0"], single("f0"), _init(world))


def test_every_rank_ends_with_the_same_parameters(world):
    for name in cases.TRAIN_CASES:
        for r in world["train"][1:]:
            for a, b in zip(r[name], world["train"][0][name]):
                for x, y in zip(tree_leaves(a["params"]),
                                tree_leaves(b["params"])):
                    assert torch.equal(x, y), name
                assert a["metrics"]["byz_weight"] == b["metrics"][
                    "byz_weight"]


def test_attacked_step_matches_the_reference(world, single):
    ties = _ties(world, single)
    tied = sum(int(m.sum()) for m in ties)
    assert tied <= 1e-4 * sum(m.size for m in ties), tied
    port = world["train"][0]["attacked"]
    ref = world["ref"]["attacked"]
    _hold_params(port, ref, _init(world), ties, what="attacked")
    for t in range(2):
        for i, (a, b) in enumerate(zip(
                _leaves_np(port[t]["m"]),
                jax.tree_util.tree_leaves(ref[t]["m"]))):
            scaled_close(a, np.asarray(b), ties[i], what=(t, "m", i))
        for k, v in ref[t]["metrics"].items():
            _close(port[t]["metrics"][k], v, what=(t, k))
        assert port[t]["metrics"]["byz_weight"] == ref[t]["metrics"][
            "byz_weight"]


def test_attacked_submissions_match_the_single_device_port(world, single):
    """The sharded submissions (each rank's slices, gathered) against the
    single-device port's at 1e-4 of each leaf's largest entry."""
    for t in range(2):
        got = world["train"][0]["attacked"][t]["sub"]
        for a, b in zip(tree_leaves(got),
                        tree_leaves(single("attacked")[t]["sub"])):
            scaled_close(a, b, what=t)


def test_attacked_step_matches_the_single_device_port(world, single):
    _hold_params(world["train"][0]["attacked"], single("attacked"),
                 _init(world), _ties(world, single))


def test_reputation_step_matches_the_reference(world, single):
    port = world["train"][0]["reputation"]
    for want in (world["ref"]["reputation"], single("reputation")):
        _hold_params(port, want, _init(world), what="reputation")
        for t in range(2):
            for k, v in want[t]["metrics"].items():
                _close(port[t]["metrics"][k], v, what=(t, k))


def test_async_step_matches_the_reference(world, single):
    """tau = 2 with ``stale-bulyan-krum``: the sharded step against the
    reference's and the single-device port's."""
    port = world["train"][0]["async"]
    for want in (world["ref"]["async"], single("async")):
        ties = _stale_ties(port, want)
        assert sum(int(m.sum()) for m in ties) <= 1e-4 * sum(
            m.size for m in ties)
        _hold_params(port, want, _init(world), ties, what="async")
        for t in range(2):
            for k, v in want[t]["metrics"].items():
                _close(port[t]["metrics"][k], v, what=(t, k))
    assert port[1]["metrics"]["delivered"] < 8


def test_single_device_async_matches_the_reference(world, single):
    want = world["ref"]["async"]
    _hold_params(single("async"), want, _init(world),
                 _stale_ties(single("async"), want), what="async single")
    for a, b in zip(single("async"), want):
        np.testing.assert_array_equal(a["versions"].numpy(), b["versions"])


def test_async_tau0_is_the_sync_step_bit_for_bit(world, single):
    for rows in (world["train"][0], {"async0": single("async0"),
                                     "attacked": single("attacked")}):
        for a, b in zip(rows["async0"], rows["attacked"]):
            for x, y in zip(tree_leaves(a["params"]),
                            tree_leaves(b["params"])):
                assert torch.equal(x, y)
            for k in ("loss", "grad_norm", "agg_dev", "byz_weight"):
                assert a["metrics"][k] == b["metrics"][k]
