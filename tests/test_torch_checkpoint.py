"""Checkpoints cross between the packages: ``repro.checkpoint`` writes and
``repro_torch.checkpoint`` reads, and the reverse, leaf for leaf, for an
fp32 and a bf16 model tree (reduced gemma3-1b) and an optimizer state;
the manifests name the same key paths; a mismatched example tree raises
the reference's texts."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402


def _jax_tree(dtype):
    cfg = dataclasses.replace(jget_reduced("gemma3_1b"), param_dtype=dtype)
    params = jinit_model(jax.random.PRNGKey(4), cfg)
    # an optimizer state beside the weights: a 0-d int step and fp32
    # moments, as the optimizers carry
    return {"params": params,
            "opt": {"step": jnp.asarray(3, jnp.int32),
                    "m": jax.tree_util.tree_map(
                        lambda p: jnp.full(p.shape, 0.5, jnp.float32),
                        params)}}


def _bits(x):
    """A leaf's raw bits as numpy (bf16 by its uint16 view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_writes_port_reads(tmp_path, dtype):
    tree = _jax_tree(dtype)
    jsave(str(tmp_path), tree, step=12, metadata={"who": "reference"})
    example = params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                              "cpu")
    got, step = load_checkpoint(str(tmp_path), example)
    assert step == 12
    want = jax.tree_util.tree_leaves(tree)
    mine = tree_leaves(got)
    assert len(mine) == len(want)
    for a, b in zip(want, mine):
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        assert np.array_equal(_bits(b), _bits(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_writes_jax_reads(tmp_path, dtype):
    tree = _jax_tree(dtype)
    mine = params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    save_checkpoint(str(tmp_path), mine, step=5)
    got, step = jload(str(tmp_path), tree)
    assert step == 5
    for a, b in zip(tree_leaves(mine), jax.tree_util.tree_leaves(got)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert np.array_equal(_bits(b), _bits(a))
    # both packages write the same manifest entries for the same tree
    jsave(str(tmp_path / "ref"), tree, step=5)
    import json
    ours = json.loads((tmp_path / "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert ours["leaves"] == ref["leaves"]


def test_mismatched_tree_raises_the_reference_text(tmp_path):
    tree = _jax_tree("float32")
    mine = params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    save_checkpoint(str(tmp_path), mine)
    fewer = {"params": mine["params"]}
    with pytest.raises(ValueError, match=r"checkpoint has \d+ leaves, "
                                         r"example tree has \d+"):
        load_checkpoint(str(tmp_path), fewer)
    renamed = {"params": mine["params"], "opu": mine["opt"]}
    with pytest.raises(ValueError, match="leaf path mismatch: "
                                         "opu/m/embed/table vs "
                                         "opt/m/embed/table"):
        load_checkpoint(str(tmp_path), renamed)
    reshaped = {"params": dict(mine["params"]), "opt": mine["opt"]}
    reshaped["params"]["embed"] = {"table": torch.zeros(3, 4)}
    with pytest.raises(ValueError, match=r"shape mismatch at "
                                         r"params/embed/table"):
        load_checkpoint(str(tmp_path), reshaped)
    # the reference raises the same texts on the same files
    with pytest.raises(ValueError, match="leaf path mismatch: "
                                         "opu/m/embed/table vs "
                                         "opt/m/embed/table"):
        jload(str(tmp_path), {"params": tree["params"],
                              "opu": tree["opt"]})
