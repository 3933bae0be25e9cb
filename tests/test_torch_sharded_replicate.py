"""The port's multi-rank train step on a mesh whose ``data`` axis does
not divide the workers, against the single-device port, on the CPU: the
third of the three worlds of the sharded-runtime tests (the shared half
is ``tests/torch_shard_world.py``).

A ``(3, 1)`` mesh of gloo processes (``repro_torch.dist.mesh
.run_on_mesh``) runs one step of reduced llama3.2-3b with 8 workers
(the reference's replicate rule: every rank computes every worker)
under the ``pallas`` and ``fused`` backends.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_shard_cases as cases  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from torch_shard_world import make_inputs, single_runs  # noqa: E402


@pytest.fixture(scope="module")
def world():
    inputs = make_inputs()
    replicate = run_on_mesh(cases.replicated_rule_case, (3, 1),
                            args=(inputs["params"],), device="cpu",
                            num_threads=1, timeout=300)
    return {"replicate": replicate, "inputs": inputs}


@pytest.fixture(scope="module")
def single(world):
    return single_runs(world)


def test_replicate_rule_and_fused_on_a_data_only_mesh(world, single):
    """Data axis 3 against 8 workers: every rank computes every worker;
    with no model axis ``fused`` stays fused.  Both equal the
    single-device step."""
    want = single("attacked")[0]
    for r in world["replicate"]:
        for backend in ("pallas", "fused"):
            got, m = r[backend]
            for a, b in zip(tree_leaves(got), tree_leaves(want["params"])):
                assert float((a - b).abs().max()) <= 1e-6 * max(
                    1.0, float(b.abs().max())), backend
            assert m["byz_weight"] == want["metrics"]["byz_weight"]
    # no model axis: the only collectives are the parameter gathers (none)
    assert world["replicate"][0]["comm_calls"] == 0
