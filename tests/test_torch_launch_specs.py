"""The launch harness's specs (``repro_torch.launch.specs``) and the
dry-run's shared records against the reference's
(``repro/launch/specs.py``, ``repro/launch/dryrun.py``).

* For all ten configs, every input shape and both production meshes
  (16 x 16 and 2 x 16 x 16): the same global shapes, dtypes and
  partition specs of the parameters, the optimizer state, the decode
  caches, the replica-stacked ensemble trees and the inputs.  The
  reference reads a ``jax.sharding.Mesh`` of the one CPU device repeated
  (``tests/test_torch_sharding.py``'s trick), the port a
  ``RecordingMesh`` of the same shape; the reference's trees are cached
  per (arch, mesh).
* ``init_model`` / ``init_cache`` on ``meta`` against the reference's
  ``eval_shape`` for all ten full configs.
* ``model_flops`` and the skip records for every (arch, shape).
* ``local_tree`` cuts each leaf to ``sharding.local_shape``.
"""
import functools
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS, get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models.config import INPUT_SHAPES  # noqa: E402
from repro.models.decode import init_cache as jinit_cache  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist.sharding import _spec_leaves, local_shape  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import init_cache, init_model  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402

MESHES = [(16, 16), (2, 16, 16)]
SHAPES = list(INPUT_SHAPES)
REPLICAS = (7, 32)


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module, imported without keeping the
    512-device ``XLA_FLAGS`` it sets for its own process."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return mod


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")


@functools.lru_cache(maxsize=None)
def _jax_mesh(shape):
    dev = jax.devices()[0]
    return jax.sharding.Mesh(
        np.array([dev] * math.prod(shape), dtype=object).reshape(shape),
        _names(shape))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, mesh):
    return jspecs.param_specs(jget_config(arch), _jax_mesh(mesh))


@functools.lru_cache(maxsize=None)
def _ref_ensemble(arch, mesh, n):
    return jspecs.ensemble_param_specs(jget_config(arch), _jax_mesh(mesh), n)


def _ref(structs):
    """``[(shape, dtype name, spec)]`` of the reference's structs."""
    return [(tuple(s.shape), jnp.dtype(s.dtype).name,
             tuple(s.sharding.spec))
            for s in jax.tree_util.tree_leaves(structs)]


def _port(tree, spec_tree):
    """``[(shape, dtype name, spec)]`` of the port's pair."""
    leaves, sp = tree_leaves(tree), _spec_leaves(spec_tree)
    assert len(leaves) == len(sp)
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""), tuple(s))
            for x, s in zip(leaves, sp)]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match(arch, mesh):
    got = specs.param_specs(get_config(arch), dryrun.RecordingMesh(mesh))
    assert all(x.device.type == "meta" for x in tree_leaves(got[0]))
    assert _port(*got) == _ref(_ref_params(arch, mesh)[0])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_specs_match(arch, mesh):
    rmesh = dryrun.RecordingMesh(mesh)
    params, _ = specs.param_specs(get_config(arch), rmesh)
    for name in ("momentum", "adamw"):
        state, sp = specs.opt_specs(params, get_optimizer(name, 1e-3), rmesh)
        want, _ = jspecs.opt_specs(_ref_params(arch, mesh)[0],
                                   jget_optimizer(name, 1e-3),
                                   _jax_mesh(mesh))
        # the port's optimizers count steps in a Python int, replicated;
        # the reference's is a 0-d int32
        assert state["step"] == 0 and tuple(sp["step"]) == ()
        assert want["step"].shape == () and tuple(
            want["step"].sharding.spec) == ()
        assert _port({k: v for k, v in state.items() if k != "step"},
                     {k: v for k, v in sp.items() if k != "step"}) == _ref(
            {k: v for k, v in want.items() if k != "step"})


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ensemble_param_specs_match(arch, mesh):
    rmesh = dryrun.RecordingMesh(mesh)
    for n in REPLICAS:
        got = specs.ensemble_param_specs(get_config(arch), rmesh, n)
        assert _port(*got) == _ref(_ref_ensemble(arch, mesh, n)[0])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_match(arch, shape, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    rmesh, jm = dryrun.RecordingMesh(mesh), _jax_mesh(mesh)
    got = specs.input_specs(cfg, shape, rmesh)
    want = jspecs.input_specs(jcfg, shape, jm)
    assert list(got[0]) == list(want)
    for k in want:
        assert _port(got[0][k], got[1][k]) == _ref(want[k]), k
    shp = INPUT_SHAPES[shape]
    if shp.kind != "decode":
        return
    b = shp.global_batch
    assert _port(*specs.cache_specs(cfg, b, shp.seq_len, rmesh)) == _ref(
        jspecs.cache_specs(jcfg, b, shp.seq_len, jm)[0])
    for n in REPLICAS:
        assert _port(*specs.ensemble_cache_specs(
            cfg, n, b, shp.seq_len, rmesh)) == _ref(
            jspecs.ensemble_cache_specs(jcfg, n, b, shp.seq_len, jm)[0])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_init_matches_eval_shape(arch):
    """``init_model`` / ``init_cache`` on ``meta``: the reference's
    ``eval_shape`` shapes and dtypes for the full config, nothing
    drawn."""
    cfg, jcfg = get_config(arch), jget_config(arch)

    def port(tree):
        assert all(x.device.type == "meta" for x in tree_leaves(tree))
        return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for x in tree_leaves(tree)]

    def ref(fn):
        return [(tuple(s.shape), jnp.dtype(s.dtype).name)
                for s in jax.tree_util.tree_leaves(jax.eval_shape(fn))]

    assert port(init_model(0, cfg, device="meta")) == ref(
        lambda: jinit_model(jax.random.PRNGKey(0), jcfg))
    assert port(init_cache(cfg, 4, 64, device="meta")) == ref(
        lambda: jinit_cache(jcfg, 4, 64))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_skip_records_match(arch, shape, jdryrun,
                                            monkeypatch):
    assert dryrun.model_flops(get_config(arch), INPUT_SHAPES[shape]) == (
        jdryrun.model_flops(jget_config(arch), INPUT_SHAPES[shape]))
    from repro.configs import shape_applicable
    if shape_applicable(arch, shape):
        return
    # the reference returns its skip record before it lowers anything;
    # its process-wide device check is stood in for
    monkeypatch.setattr(jax, "device_count", lambda: 512)
    assert dryrun.run_one(arch, shape) == jdryrun.run_one(arch, shape)


def test_local_tree_cuts_each_leaf():
    rmesh = dryrun.RecordingMesh((16, 16))
    cfg = get_config("gemma3-1b")
    params, sp = specs.param_specs(cfg, rmesh)
    local = specs.local_tree(params, sp, rmesh)
    for x, y, s in zip(tree_leaves(params), tree_leaves(local),
                       _spec_leaves(sp)):
        assert tuple(y.shape) == local_shape(tuple(x.shape), s, rmesh)
        assert y.dtype == x.dtype and y.device.type == "meta"
    assert sum(x.numel() for x in tree_leaves(local)) * 8 < sum(
        x.numel() for x in tree_leaves(params))
