"""The port's meshes and sharding rules (``repro_torch.dist.{mesh,
sharding}``) against the reference's.

* The rules, leaf by leaf, for every leaf of the ten full-size configs
  (their shapes from ``jax.eval_shape``), at mesh sizes (1, 1), (2, 2),
  (4, 2), (16, 16) and (2, 16, 16): ``param_shardings`` (also under
  ``LEGACY_RULES``), the gradient stacks' ``gram_pspec``, the replica
  stacks' ``ensemble_param_shardings``, the decode caches'
  ``cache_shardings`` / ``ensemble_cache_shardings``, and
  ``batch_pspec``.  The port reads a stand-in mesh that carries only
  ``axis_names`` and a ``devices`` grid (all ``mesh_axis_sizes`` reads);
  the reference gets a ``jax.sharding.Mesh`` of the one CPU device
  repeated, which builds ``NamedSharding``s without placing anything.
* The meshes' error texts against the reference's on this one-device
  process, the backend rule, and the launcher: a rank's exception
  re-raised in the caller, each rank's coordinates and collectives.
* A one-position mesh runs the single-device step bit for bit.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_shard_cases as cases  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import mesh as jmesh  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models.decode import init_cache as jinit_cache  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.dist import mesh as tmesh  # noqa: E402
from repro_torch.dist import robust  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.dist.train import make_train_step  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402

SIZES = [(1, 1), (2, 2), (4, 2), (16, 16), (2, 16, 16)]


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")


class _StandIn:
    """What ``mesh_axis_sizes`` reads of a mesh."""

    def __init__(self, shape):
        self.axis_names = _names(shape)
        self.devices = np.empty(shape)


@functools.lru_cache(maxsize=None)
def _jax_mesh(shape):
    dev = jax.devices()[0]
    return jax.sharding.Mesh(
        np.array([dev] * math.prod(shape), dtype=object).reshape(shape),
        _names(shape))


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return jax.eval_shape(
        lambda: jinit_model(jax.random.PRNGKey(0), jget_config(arch)))


@functools.lru_cache(maxsize=None)
def _abstract_cache(arch):
    return jax.eval_shape(lambda: jinit_cache(jget_config(arch), 4, 64))


def _meta(abstract):
    """The reference's shapes as the port's tree of meta tensors."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(tuple(s.shape), device="meta"), abstract)


def _stack(abstract, n):
    return jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((n,) + tuple(s.shape), s.dtype),
        abstract)


def _ref_specs(shardings):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(shardings)]


def _port_specs(specs):
    return [tuple(s) for s in tsh._spec_leaves(specs)]


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("shape", SIZES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_match(arch, shape, legacy, monkeypatch):
    monkeypatch.setattr(jsh, "LEGACY_RULES", legacy)
    monkeypatch.setattr(tsh, "LEGACY_RULES", legacy)
    abstract = _abstract(arch)
    want = _ref_specs(jsh.param_shardings(abstract, _jax_mesh(shape)))
    got = _port_specs(tsh.param_shardings(_meta(abstract), _StandIn(shape)))
    assert got == want
    # each leaf directly against the reference's private rule
    model = jmesh.mesh_axis_sizes(_jax_mesh(shape)).get("model", 1)
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    assert got == [tuple(jsh._leaf_pspec(p, s.shape, model))
                   for p, s in flat]


@pytest.mark.parametrize("shape", SIZES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gram_rules_match(arch, shape):
    abstract = _abstract(arch)
    mesh = _StandIn(shape)
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    for n in (7, 16):
        want = [tuple(jsh.gram_pspec((n,) + tuple(s.shape), mesh, p))
                for p, s in flat]
        assert _port_specs(tsh.gram_shardings(_meta(abstract), mesh)) == (
            want)
        got = [tuple(tsh.gram_pspec((n,) + tuple(s.shape), mesh,
                                    tuple(str(getattr(k, "key", k))
                                          for k in p))) for p, s in flat]
        assert got == want


@pytest.mark.parametrize("shape", SIZES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ensemble_and_cache_rules_match(arch, shape):
    jm, mesh = _jax_mesh(shape), _StandIn(shape)
    for replicas in (7, 32):
        stacked = _stack(_abstract(arch), replicas)
        assert _port_specs(tsh.ensemble_param_shardings(
            _meta(stacked), mesh)) == _ref_specs(
                jsh.ensemble_param_shardings(stacked, jm))
        cache = _stack(_abstract_cache(arch), replicas)
        assert _port_specs(tsh.ensemble_cache_shardings(
            _meta(cache), mesh)) == _ref_specs(
                jsh.ensemble_cache_shardings(cache, jm))
    cache = _abstract_cache(arch)
    assert _port_specs(tsh.cache_shardings(_meta(cache), mesh)) == (
        _ref_specs(jsh.cache_shardings(cache, jm)))


@pytest.mark.parametrize("shape", SIZES, ids=str)
def test_batch_pspec_matches(shape):
    mesh = _StandIn(shape)
    for dims in [(), (4,), (8, 2, 16), (32, 4, 16), (3, 2), (16, 1, 8),
                 (512, 2), (64, 6, 3, 2)]:
        for worker_axis in (True, False):
            assert tuple(tsh.batch_pspec(dims, mesh, worker_axis)) == tuple(
                jsh.batch_pspec(dims, mesh, worker_axis)), (dims,
                                                            worker_axis)


def test_local_shard_and_gather_roundtrip():
    """A one-rank mesh keeps every leaf whole; the slice arithmetic of a
    split over two axes is row-major."""
    mesh = tmesh.make_host_mesh(device="cpu")
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(tsh.gather_shard(tsh.local_shard(
        x, tsh.P(None, "model"), mesh), tsh.P(None, "model"), mesh), x)

    class _At:
        axis_names = ("pod", "data", "model")
        devices = np.empty((2, 3, 1))

        def index(self, axis):
            return {"pod": 1, "data": 2}.get(axis, 0)

    got = tsh.local_shard(torch.arange(12.0), tsh.P(("pod", "data")), _At())
    assert torch.equal(got, torch.tensor([10.0, 11.0]))
    assert tsh.local_shape((12, 5), tsh.P(("pod", "data")), _At()) == (2, 5)
    assert repr(tsh.P(None, "model")) == "P(None, 'model')"
    import pickle
    assert pickle.loads(pickle.dumps(tsh.P("data", None))) == ("data", None)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args,kw", [
    ("make_host_mesh", ((2, 2), ("data",)), {}),
    ("make_host_mesh", ((4, 2),), {}),
    ("make_host_mesh", ((2, 2, 2),), {}),
    ("make_host_mesh", ((2,), ("data", "model")), {}),
    ("make_production_mesh", (), {}),
    ("make_production_mesh", (), {"multi_pod": True}),
])
def test_mesh_errors_match_the_reference(name, args, kw):
    with pytest.raises(ValueError) as want:
        getattr(jmesh, name)(*args, **kw)
    with pytest.raises(ValueError) as got:
        getattr(tmesh, name)(*args, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_one_position_mesh_matches_the_reference():
    mesh = tmesh.make_host_mesh(device="cpu")
    assert tmesh.mesh_axis_sizes(mesh) == jmesh.mesh_axis_sizes(
        jmesh.make_host_mesh())
    assert (mesh.shape, mesh.axis_names, mesh.coords) == (
        (1, 1), ("data", "model"), {"data": 0, "model": 0})
    x = torch.arange(3.0)
    for out in (mesh.all_reduce(x, "model"), mesh.all_gather(x, "data"),
                mesh.broadcast(x, "model")):
        assert out is x
    assert mesh.size("pod") == 1 and mesh.index("pod") == 0
    three = tmesh.make_host_mesh((1, 1, 1), device="cpu")
    assert three.axis_names == ("pod", "data", "model")


def test_backend_rule():
    with pytest.raises(ValueError, match="carries CUDA tensors only"):
        tmesh.make_host_mesh(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="'gloo' or 'nccl'"):
        tmesh.make_host_mesh(device="cpu", backend="mpi")
    assert tmesh.make_host_mesh(device="cpu").backend == "gloo"
    # two ranks on fewer cards: nccl is refused, never swapped for gloo
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        tmesh._resolve_backend(None, "cuda", cards + 1)
    if not torch.cuda.is_available():
        # the entry points default to the card, as every entry point of
        # the port does, and say so when there is none
        for call in (lambda: tmesh.make_host_mesh(),
                     lambda: tmesh.make_host_mesh(backend="gloo"),
                     lambda: tmesh.run_on_mesh(cases.mesh_view, (1, 2))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 gives up") as e:
        tmesh.run_on_mesh(cases.failing_rank, (1, 2), device="cpu",
                          num_threads=1, timeout=120)
    assert "rank 1 of mesh (1, 2) failed" in str(e.value)


def test_ranks_see_their_coordinates_and_collectives():
    out = tmesh.run_on_mesh(cases.mesh_view, (2, 2), device="cpu",
                            num_threads=1, timeout=120)
    for rank, r in enumerate(out):
        i, j = divmod(rank, 2)
        assert r["coords"] == {"data": i, "model": j}
        assert (r["shape"], r["axis_names"], r["backend"]) == (
            (2, 2), ("data", "model"), "gloo")
        # model peers of rank 2i + j are 2i and 2i + 1
        assert torch.equal(r["sum_model"], torch.full((2,), 4.0 * i + 1))
        assert torch.equal(r["gather_data"],
                           torch.tensor([[j, j], [2.0 + j, 2.0 + j]]))
        assert torch.equal(r["bcast_model"],
                           torch.full((2,), 2.0 * i + 1))
        # gathered to the rank at model index 1 only, along dim 1
        if j == 1:
            assert torch.equal(r["gather_model"], torch.tensor(
                [[2.0 * i, 2.0 * i, 2.0 * i + 1, 2.0 * i + 1]]))
        else:
            assert r["gather_model"] is None
        # the results: 8 bytes reduced, 16 all-gathered, 8 sent, and 16
        # gathered where they land
        assert r["comm"]["calls"] == 4
        assert r["comm"]["bytes"] == 32 + (16 if j == 1 else 0)


def test_one_position_mesh_runs_the_single_device_step():
    """A (1, 1) mesh: the mesh path's layout moves are identities, so the
    step equals the single-device one bit for bit (and without a
    template it says what it needs)."""
    torch.set_num_threads(1)
    cfg = get_reduced(cases.ARCH)
    params = init_model(1, cfg, device="cpu")
    opt = get_optimizer("momentum", cases.LR)
    spec = AggSpec(f=1, gar="bulyan-krum", attack="omniscient_linf",
                   distance_backend="pallas")
    mesh = tmesh.make_host_mesh(device="cpu")
    with pytest.raises(ValueError, match="template"):
        make_train_step(cfg, spec, opt, mesh=mesh)
    meshed = make_train_step(cfg, spec, opt, mesh=mesh, template=tree_map(
        lambda p: p.to("meta"), params))
    plain = make_train_step(cfg, spec, opt)
    batch = cases.lm_batch(cfg.vocab_size, 8, 0)
    a = meshed(params, opt.init(params), batch)
    b = plain(params, opt.init(params), batch)
    for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])):
        assert torch.equal(x, y)
    assert {k: float(v) for k, v in a[2].items()} == {
        k: float(v) for k, v in b[2].items()}
    assert robust.resolve_distance_backend("auto", mesh, "cpu") == "xla"


def test_observe_sees_what_the_step_aggregates():
    """``make_train_step(observe=)`` hands the hook the step's own
    submissions (``byzantine_grads``'s, bit for bit) and the rule's
    result, and changes nothing the step computes."""
    from repro_torch.dist.train import byzantine_grads, make_loss_fn
    torch.set_num_threads(1)
    cfg = get_reduced(cases.ARCH)
    params = init_model(1, cfg, device="cpu")
    opt = get_optimizer("momentum", cases.LR)
    spec = AggSpec(f=1, gar="bulyan-krum", attack="omniscient_linf",
                   distance_backend="pallas")
    batch = cases.lm_batch(cfg.vocab_size, 8, 0)
    seen = []
    watched = make_train_step(cfg, spec, opt, observe=lambda sub, res:
                              seen.append((sub, res.selected.clone())))
    a = watched(params, opt.init(params), batch)
    b = make_train_step(cfg, spec, opt)(params, opt.init(params), batch)
    for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])):
        assert torch.equal(x, y)
    (sub, selected), = seen
    _, want = byzantine_grads(make_loss_fn(cfg), spec, params, batch, 0)
    for x, y in zip(tree_leaves(sub), tree_leaves(want)):
        assert torch.equal(x, y)
    # Bulyan's phase 1 picks theta = n - 2f workers
    assert selected.shape == (8,) and int(selected.sum()) == 6
