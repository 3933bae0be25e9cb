"""The sharded train step on a 3-d mesh: ``pod`` splits each worker's
batch, ``model`` each worker's forward and backward, on the CPU.

One gloo world, ``(2, 1, 2)`` ``("pod", "data", "model")``, spawned once
(``tests/torch_tp_cases.py``'s ``pod_case``): reduced llama3.2-3b from
the reference's weights with ``attn_shard="batch"``, n = 4 workers of 4
sequences of 16 tokens, so each ``pod`` rank takes 2 of every worker's
sequences and each ``model`` rank attends for 1 of them.  One step of
``bulyan-krum`` with ``f = 0`` under momentum SGD, against the
single-device port: the submissions at 1e-4 of each leaf's largest
entry, the losses at 1e-4 and the parameters under the LLM rule
(``tests/torch_llm_compare.py``).  The ranks' collectives per kind are
held to ``RecordingMesh``'s trace of the same step, and an MoE config,
whose capacity counts the whole batch's tokens, keeps its batch whole on
every ``pod`` rank.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_cases as cases  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from repro_torch.dist.train import (byzantine_grads,  # noqa: E402
                                    make_loss_fn, make_train_step)
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from torch_llm_compare import close_change, scaled_close  # noqa: E402

ARCH = "llama3_2_3b"
SHAPE = (2, 1, 2)
N, PER_WORKER = 4, 4
SPEC = dict(f=0, gar="bulyan-krum", attack="none")


@pytest.fixture(scope="module")
def inputs():
    params = jax.tree_util.tree_map(
        np.asarray, jinit_model(jax.random.PRNGKey(3), jget_reduced(ARCH)))
    cfg = cases.step_cfg(ARCH)
    return params, [cases.lm_batch(cfg.vocab_size, N, PER_WORKER, 0)]


@pytest.fixture(scope="module")
def world(inputs):
    params, batches = inputs
    return run_on_mesh(cases.pod_case, SHAPE,
                       args=(ARCH, params, batches, SPEC), device="cpu",
                       num_threads=1, timeout=300)


@pytest.fixture(scope="module")
def single(inputs):
    torch.set_num_threads(1)
    params_np, batches = inputs
    cfg = cases.step_cfg(ARCH)
    params = params_from_jax(params_np, "cpu")
    spec = AggSpec(distance_backend="pallas", **SPEC)
    losses, sub = byzantine_grads(make_loss_fn(cfg), spec, params,
                                  batches[0], 0)
    opt = get_optimizer("momentum", cases.LR)
    step = make_train_step(cfg, spec, opt)
    after, _, m = step(params, opt.init(params), batches[0])
    return {"losses": losses, "sub": sub, "params": after,
            "metrics": {k: float(v) for k, v in m.items()}}


def test_every_rank_sees_its_coordinates(world):
    assert [r["coords"] for r in world] == [
        {"pod": p, "data": 0, "model": m} for p in (0, 1) for m in (0, 1)]


def test_pod_split_submissions_match_one_device(world, single):
    for r in world:
        scaled_close(r["losses"], single["losses"], what="losses")
        for i, (a, b) in enumerate(zip(tree_leaves(r["sub"]),
                                       tree_leaves(single["sub"]))):
            scaled_close(a, b, what=i)
        # the mean over pod: one all-reduce of each worker's slices
        assert r["pod_comm"]["all_reduce"]["calls"] > N


def test_pod_split_step_matches_one_device(world, inputs, single):
    init = [np.asarray(x, dtype=np.float64)
            for x in jax.tree_util.tree_leaves(inputs[0])]
    for r in world:
        row = r["rows"][0]
        for i, (a, b, p) in enumerate(zip(tree_leaves(row["params"]),
                                          tree_leaves(single["params"]),
                                          init)):
            close_change(a.numpy(), b.numpy(), p, 1, what=i)
        scaled_close(row["metrics"]["loss"], single["metrics"]["loss"])
        for x, y in zip(tree_leaves(row["params"]),
                        tree_leaves(world[0]["rows"][0]["params"])):
            assert torch.equal(x, y)


def test_recording_mesh_traces_the_pod_step(world, inputs):
    cfg = cases.step_cfg(ARCH)
    for rank, r in enumerate(world):
        mesh = dryrun.RecordingMesh(SHAPE, rank=rank)
        assert mesh.coords == r["coords"]
        pred = dryrun.trace_train_step(
            cfg, AggSpec(distance_backend="pallas", **SPEC),
            get_optimizer("momentum", cases.LR), mesh, inputs[1][0])
        assert pred["by_kind"] == r["rows"][0]["comm"], rank


def _trace(arch, shape):
    cfg = cases.step_cfg(arch)
    return dryrun.trace_train_step(
        cfg, AggSpec(distance_backend="pallas", **SPEC),
        get_optimizer("momentum", cases.LR), dryrun.RecordingMesh(shape),
        cases.lm_batch(cfg.vocab_size, N, PER_WORKER, 0))


def test_moe_batch_stays_whole_over_pod():
    """``splits_batch``: the MoE layer's capacity counts the whole
    batch's tokens, so such a worker's batch is not split over ``pod``:
    no mean over it (the pod ranks run the same forward); a dense model
    adds one all-reduce per worker for it, and half the FLOPs."""
    assert make_loss_fn(cases.step_cfg(ARCH)).splits_batch
    assert not make_loss_fn(cases.step_cfg("mixtral_8x22b")).splits_batch
    for arch, extra in ((ARCH, N), ("mixtral_8x22b", 0)):
        pod, flat = _trace(arch, SHAPE), _trace(arch, SHAPE[1:])
        assert (pod["by_kind"]["all_reduce"]["calls"]
                == flat["by_kind"]["all_reduce"]["calls"] + extra), arch
        if extra:
            assert pod["flops"] < 0.75 * flat["flops"]
        else:
            assert pod["flops"] == flat["flops"]
