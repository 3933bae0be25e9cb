"""The split forward's ops (``repro_torch.dist.tensor_parallel`` and the
models' ``shard=`` paths) and their conjugate backwards against their
plain ``shard=None`` forms, on the CPU.

Two gloo worlds, ``(1, 2)`` and ``(1, 4)``, spawned once each and side
by side (``repro_torch.dist.mesh.run_on_mesh``; the rank function is
``tests/torch_tp_cases.py``'s ``ops_case``), run every op on the same
numpy inputs: a product whose weight splits on its contraction dim, on
its output dim and on a leading expert dim; the embedding split on the
vocabulary and on the features; the tied unembedding with the
vocabulary-parallel cross-entropy; a norm scale gathered on use; a
weight re-laid out at its use; the batch-split attention, the
query-split one (a batch neither axis divides) and a sliding window;
the FFN's column-then-row split; and the MoE FFN under
``EXPERT_WEIGHT_GATHER`` with the experts stored split on the expert
axis.  Each op's output, its inputs' gradients and its weights'
gradients (gathered from the ranks' slices) are held at 1e-4 of their
largest entry, on every rank, and the ops' collectives are pinned.
The plain forms are held against the reference's layers on the same
inputs.
"""
import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_tp_cases as cases  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from torch_llm_compare import scaled_close  # noqa: E402

SHAPES = ((1, 2), (1, 4))


@pytest.fixture(scope="module")
def inputs():
    return cases.op_inputs()


@pytest.fixture(scope="module")
def worlds(inputs):
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futs = {shape: pool.submit(run_on_mesh, cases.ops_case, shape,
                                   args=(inputs,), device="cpu",
                                   num_threads=1, timeout=300)
                for shape in SHAPES}
        return {shape: f.result() for shape, f in futs.items()}


@pytest.fixture(scope="module")
def plain(inputs):
    torch.set_num_threads(1)
    return {name: cases.plain_op(name, inputs) for name in cases.OP_NAMES}


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "1x4"])
@pytest.mark.parametrize("name", cases.OP_NAMES)
def test_split_op_matches_its_plain_form(worlds, plain, shape, name):
    want_out, want_grads = plain[name]
    for r in worlds[shape]:
        got = r[name]
        scaled_close(got["out"], want_out.detach(), what=(name, "out"))
        assert set(got["grads"]) == set(want_grads)
        for k, g in want_grads.items():
            assert got["grads"][k].shape == g.shape, (name, k)
            scaled_close(got["grads"][k], g, what=(name, k))


def _calls(comm):
    return {k: v["calls"] for k, v in comm.items() if v["calls"]}


def test_the_ops_run_their_conjugate_collectives(worlds):
    """Forward and backward collectives per op: a contraction split is
    one all-reduce forward and one all-gather backward, an output split
    the reverse, the vocabulary-split embedding one all-reduce, the
    vocabulary-parallel loss one all-gather of (max, sum, label logit),
    the column-then-row FFN one all-reduce each way."""
    want = {"matmul_contraction": {"all_reduce": 1, "all_gather": 1},
            "matmul_output": {"all_reduce": 1, "all_gather": 1},
            "matmul_experts": {"all_gather": 2},
            "embed_vocab": {"all_reduce": 1},
            "embed_features": {"all_gather": 1},
            "unembed_loss": {"all_gather": 1, "all_reduce": 1},
            "norm_scale": {"all_gather": 1},
            "attention_batch": {"all_gather": 2},
            "attention_queries": {"all_gather": 2, "all_reduce": 1},
            "ffn": {"all_reduce": 2}}
    for shape in SHAPES:
        for r in worlds[shape]:
            for name, calls in want.items():
                assert _calls(r[name]["comm"]) == calls, (shape, name)


def test_every_rank_sees_its_coordinates(worlds):
    for shape in SHAPES:
        assert [r["coords"] for r in worlds[shape]] == [
            {"data": 0, "model": j} for j in range(shape[1])]


def test_plain_forms_match_the_reference(inputs, plain):
    """The ``shard=None`` layers the split forms are held to, against the
    reference's on the same inputs."""
    x = jnp.asarray(inputs["x"])
    out = {
        "embed_vocab": jlayers.embed({"table": jnp.asarray(
            inputs["table"])}, jnp.asarray(inputs["tokens"])),
        "norm_scale": jlayers.rmsnorm({"scale": jnp.asarray(
            inputs["scale"])}, x),
        "ffn": jlayers.ffn({k: jnp.asarray(v) for k, v in
                            inputs["ffn"].items()}, x, "swiglu"),
        "attention_batch": jattention.attention(
            *(jnp.asarray(inputs[k]) for k in ("q", "k", "v")),
            kind="attn"),
        "attention_swa": jattention.attention(
            *(jnp.asarray(inputs[k]) for k in ("q", "k", "v")),
            kind="swa", window=3),
    }
    for name, want in out.items():
        scaled_close(plain[name][0].detach(), np.asarray(want), what=name)
