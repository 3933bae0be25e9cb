"""The port's sharded serving (``mesh=`` on ``aggregate_logits``, the
robust prefill / decode / verify steps and ``ServingEngine``) and the
``obs-`` rules under a ``model`` axis, against the single-device port
and the reference, on the CPU.

Two gloo worlds (``repro_torch.dist.mesh.run_on_mesh``, one thread per
rank; the rank functions are ``tests/torch_serve_shard_cases.py``'s),
each spawned once for the whole file:

* ``(2, 2)``: 8 replicas split over ``data``, the vocabulary over
  ``model`` (``fused`` becomes ``pallas`` there); also the ``obs-``
  rules on ROADMAP's tree ``{"a": (7, 64, 32), "b": (7, 16)}`` with
  ``"a"`` split over ``model``, and one train step with
  ``obs-bulyan-krum``;
* ``(4, 1)``: 8 replicas split over ``data``, no ``model`` axis
  (``fused`` stays fused).

The ensemble is reduced llama3.2-3b, 8 replicas jittered at 1e-3 by the
reference, the last sign-flipped at scale 10; 2 slots, a 64-position
cache, three 8-token prompts with 4 new tokens each.

Rules: every rank's aggregate equals the single-device port's on the
same stack bit for bit (under the backend the mesh resolves), its
selection too, and the carried state's buffers; the reference's at
1e-4 of the largest entry, with equal ``selected``.  Rule scores come
from the all-reduced ``(n, n)`` matrix, whose summation order is the
mesh's: they are held at 1e-6 of their largest entry, and so are
``reputation-`` aggregates after the first call under a ``model`` axis
(trust scored by all-reduced sums over the vocabulary).  The steps'
gathered stacks, aggregates and caches at 1e-4 of their largest entry;
streams token for token (the reference's up to a divergence after one
of its near-ties, ``tests/torch_serving_compare.py``).
"""
import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_serve_shard_cases as cases  # noqa: E402
import torch_shard_cases as shard_cases  # noqa: E402
from repro.agg import AggSpec as JSpec  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro.dist import serve_robust as jsr  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist import robust  # noqa: E402
from repro_torch.dist import serve_robust as tsr  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from repro_torch.dist.robust import resolve_distance_backend  # noqa: E402
from repro_torch.configs import get_reduced as tget_reduced  # noqa: E402
from repro_torch.dist.serve import serve_specs  # noqa: E402
from repro_torch.dist.sharding import _spec_leaves, model_dim  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from torch_llm_compare import (close_change, scaled_close,  # noqa: E402
                               window_ties)
from torch_serving_compare import (GapRecorder,  # noqa: E402
                                   assert_streams_match)

TOL = 1e-4
#: scores from the mesh's all-reduced distances against one device's
SCORE_TOL = 1e-6
WORLDS = {"2x2": (2, 2), "4x1": (4, 1)}
CASES = {"2x2": ("f4", "agg", "steps", "engine", "train"),
         "4x1": ("agg", "steps", "engine")}
STEPS = ("prefill", "decode", "verify")
RUNS = ("token", "spec", "telemetry")


def _inputs() -> dict:
    """Every world's inputs, from the reference and numpy."""
    cfg = jget_reduced(cases.ARCH)
    key = jax.random.PRNGKey(0)

    def build(p, k):
        honest = jsr.replicate_params(p, cases.N, jitter=1e-3, key=k)
        return jsr.poison_replicas(honest, cases.F, "signflip", scale=10.0)

    ens = jax.jit(build)(jinit_model(key, cfg), jax.random.PRNGKey(7))
    rng = np.random.default_rng(0)
    f4 = {"a": rng.standard_normal((7, 64, 32)).astype(np.float32),
          "b": rng.standard_normal((7, 16)).astype(np.float32)}
    rng = np.random.default_rng(1)
    stacks = []
    for _ in range(cases.AGG_CALLS):
        base = rng.standard_normal((2, cfg.vocab_size)).astype(np.float32)
        x = base + 0.05 * rng.standard_normal(
            (cases.N, 2, cfg.vocab_size)).astype(np.float32)
        x[-cases.F:] = -10.0 * base
        stacks.append(x.astype(np.float32))
    odd = [x[..., :-1].copy() for x in stacks]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    train = jax.tree_util.tree_map(
        np.asarray, jinit_model(jax.random.PRNGKey(1), cfg))
    return {"params": jax.tree_util.tree_map(np.asarray, ens),
            "f4_tree": f4, "stacks": stacks, "odd_stacks": odd,
            "prompts": prompts,
            "block": rng.integers(0, cfg.vocab_size, 4).astype(np.int32),
            "train_params": train,
            "train_batch": shard_cases.lm_batch(cfg.vocab_size, cases.N, 0)}


@pytest.fixture(scope="module")
def world():
    """Both worlds' results (run side by side), computed once."""
    inputs = _inputs()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {name: pool.submit(
            run_on_mesh, cases.serve_case, shape,
            args=(inputs, CASES[name]), device="cpu", num_threads=1,
            timeout=600) for name, shape in WORLDS.items()}
        ranks = {name: fut.result() for name, fut in futs.items()}
    return {"inputs": inputs, "ranks": ranks}


@pytest.fixture(scope="module")
def single(world):
    """The single-device port on the same inputs (lazily, per case)."""
    cache = {}
    inputs = world["inputs"]

    def get(name):
        if name not in cache:
            params = params_from_jax(inputs["params"], "cpu")
            if name == "steps":
                cache[name] = cases.steps_case(params, inputs["prompts"][0],
                                               inputs["block"])
            elif name == "engine":
                cache[name] = cases.engine_runs(params, inputs["prompts"])
            elif name == "train":
                cache[name] = cases.train_step(inputs["train_params"],
                                               inputs["train_batch"])
        return cache[name]

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield get
    torch.set_num_threads(old)


@pytest.mark.parametrize("gar", cases.ODD_RULES)
@pytest.mark.parametrize("name", WORLDS)
def test_aggregate_logits_on_a_vocabulary_model_does_not_divide(world, name,
                                                                gar):
    """A 1,023-word vocabulary, which the (2, 2) world's ``model`` axis
    does not divide, stays whole on every rank (``logits_pspec``): the
    aggregates and the carried window equal the single-device port's bit
    for bit, on either world."""
    stacks = world["inputs"]["odd_stacks"]
    rows, state = _single_aggregates(
        stacks, gar, resolve_distance_backend("fused", _Grid(WORLDS[name])))
    for r in world["ranks"][name]:
        got_rows, got_state = r["odd"][(gar, "fused")]
        for (agg, sel, _), want in zip(got_rows, rows):
            assert torch.equal(agg, want[0]) and torch.equal(
                sel, want[1].selected)
        if state is not None:
            for a, b in zip(got_state.history, state.history):
                assert torch.equal(a, b)


class _Grid:
    """What ``mesh_axis_sizes`` reads of a mesh."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape)


def _window_ties(a, b):
    """The aggregate's coordinates where Bulyan's window choice may
    differ between two ``(n, B, [k,] V)`` stacks (``window_ties`` per
    aggregation: a verify block's positions in turn), as a mask in the
    aggregate's ``(B, [k,] V)`` layout."""
    if a.dim() == 4:
        return torch.stack([_window_ties(a[:, :, j], b[:, :, j])
                            for j in range(a.shape[2])], dim=1)
    tie = window_ties([a], [b], cases.F)[0]
    return tie.reshape(a.shape[1:])


def _share_numels(inputs, shape):
    """The element counts of a rank's share of the ensemble (each leaf
    over ``data``, and over ``model`` where the serving layout splits
    it) and of its draft replica's slices."""
    specs = _spec_leaves(serve_specs(tget_reduced(cases.ARCH), _Grid(shape),
                                     cases.N))
    data, model = shape
    share, draft = [], []
    for x, s in zip(jax.tree_util.tree_leaves(inputs["params"]), specs):
        cut = model if model_dim(s) is not None else 1
        share.append(x.size // data // cut)
        draft.append(x.size // cases.N // cut)
    return share, draft


def _close(got, want, tol=TOL, what=""):
    scaled_close(got, want, tol=tol, what=what)


def _equal_trees(a, b, what=""):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), what


def _ring_fields(obs):
    """A ring's fields by name, as numpy (either package's)."""
    out = {"cursor": np.asarray(obs.cursor),
           "sel_total": np.asarray(obs.sel_total)}
    for name in obs.records._fields:
        out[name] = np.asarray(getattr(obs.records, name))
    return out


def _hold_ring(got, want, exact: bool, what=""):
    """Two rings: ``scores`` at 1e-6 of the largest; every other field
    bit for bit (``exact``, the single-device port) or at 1e-4 (the
    reference)."""
    g, w = _ring_fields(got), _ring_fields(want)
    assert set(g) == set(w)
    for name in g:
        if name == "scores":
            _close(g[name], w[name], SCORE_TOL if exact else TOL,
                   what=(what, name))
        elif exact:
            np.testing.assert_array_equal(g[name], w[name],
                                          err_msg=f"{what} {name}")
        else:
            _close(g[name], w[name], what=(what, name))


def test_every_rank_sees_its_own_coordinates(world):
    for name, shape in WORLDS.items():
        coords = [r["coords"] for r in world["ranks"][name]]
        assert coords == [{"data": i, "model": j} for i in range(shape[0])
                          for j in range(shape[1])]


# ---------------------------------------------------------------------------
# F4: obs- rules on a model-sharded tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f4_reference(world):
    """The reference's obs- rules on the whole tree, 3 calls each."""
    tree = jax.tree_util.tree_map(jnp.asarray, world["inputs"]["f4_tree"])
    out = {}
    for gar in cases.F4_RULES:
        fn = jax.jit(lambda t, s, gar=gar: jrobust.distributed_aggregate(
            t, cases.F, gar, distance_backend="xla", state=s))
        state, rows = None, []
        for t in range(cases.AGG_CALLS):
            agg, res, state = fn(cases.f4_scaled(tree, t), state)
            rows.append((agg, np.asarray(res.selected)))
        out[gar] = (rows, state.obs)
    return out


@pytest.mark.parametrize("backend", cases.F4_BACKENDS)
@pytest.mark.parametrize("gar", cases.F4_RULES)
def test_f4_obs_rules_on_a_model_sharded_tree(world, f4_reference, gar,
                                              backend):
    """Every rank's aggregate, selection and ring equal the single-device
    port's bit for bit (scores at 1e-6), and the reference's at 1e-4
    with equal ``selected``."""
    tree = params_from_jax(world["inputs"]["f4_tree"], "cpu")
    ranks = world["ranks"]["2x2"]
    assert model_dim(ranks[0]["f4"]["specs"]["a"]) == 1
    assert model_dim(ranks[0]["f4"]["specs"]["b"]) is None
    state = None
    for t in range(cases.AGG_CALLS):
        want, wres, state = robust.distributed_aggregate(
            cases.f4_scaled(tree, t), cases.F, gar,
            distance_backend=backend, state=state)
        jagg, jsel = f4_reference[gar][0][t]
        for r in ranks:
            agg, sel, scores = r["f4"][(gar, backend)][0][t]
            _equal_trees(agg, want, (gar, backend, t))
            assert torch.equal(sel, wres.selected)
            _close(scores, wres.scores, SCORE_TOL)
            for a, b in zip(tree_leaves(agg),
                            jax.tree_util.tree_leaves(jagg)):
                _close(a, np.asarray(b), what=(gar, t, "reference"))
            np.testing.assert_array_equal(sel.numpy(), jsel)
    for r in ranks:
        ring = r["f4"][(gar, backend)][1]
        _hold_ring(ring, state.obs, True, (gar, backend))
        _hold_ring(ring, f4_reference[gar][1], False, (gar, "reference"))
        # the ring's scores are the rule's own, bit for bit
        np.testing.assert_array_equal(
            ring.records.scores[cases.AGG_CALLS - 1].numpy(),
            r["f4"][(gar, backend)][0][-1][2].numpy())


# ---------------------------------------------------------------------------
# aggregate_logits(mesh=)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def agg_reference(world):
    """The reference's ``aggregate_logits`` (jitted, ``xla``) over the
    calls' stacks, the state carried."""
    stacks = world["inputs"]["stacks"]
    out = {}
    for gar in cases.AGG_RULES:
        spec = JSpec(f=cases.F, gar=gar)
        state = jsr.init_ensemble_state(spec, *stacks[0].shape)
        fn = jax.jit(lambda x, s, gar=gar: jsr.aggregate_logits(
            x, cases.F, gar, state=s))
        rows = []
        for x in stacks:
            got = fn(jnp.asarray(x), state)
            if len(got) == 3:
                state = got[2]
            rows.append((np.asarray(got[0]), np.asarray(got[1].selected)))
        out[gar] = rows
    return out


def _single_aggregates(stacks, gar, backend):
    spec = AggSpec(f=cases.F, gar=gar)
    state = tsr.init_ensemble_state(spec, *stacks[0].shape, device="cpu")
    rows = []
    for x in stacks:
        got = tsr.aggregate_logits(torch.from_numpy(x), cases.F, gar,
                                   distance_backend=backend, state=state)
        if len(got) == 3:
            state = got[2]
        rows.append(got)
    return rows, state


@pytest.mark.parametrize("backend", cases.BACKENDS)
@pytest.mark.parametrize("gar", cases.AGG_RULES)
@pytest.mark.parametrize("name", WORLDS)
def test_aggregate_logits_matches_the_single_device_port(world, name, gar,
                                                         backend):
    """Every rank's aggregate of the whole stack equals the single-device
    port's bit for bit under the backend the mesh resolves, selections
    too, and so does the state carried over 3 calls."""
    resolved = resolve_distance_backend(backend, _Grid(WORLDS[name]))
    rows, state = _single_aggregates(world["inputs"]["stacks"], gar,
                                     resolved)
    # reputation- weights each call by trust scored over the vocabulary:
    # under a model axis its sums are all-reduced, so from the second
    # call on the aggregate carries their summation order
    reassociated = (gar.startswith("reputation-")
                    and WORLDS[name][1] > 1)
    for r in world["ranks"][name]:
        got_rows, got_state = r["agg"][(gar, backend)]
        for t, ((agg, sel, scores), want) in enumerate(zip(got_rows, rows)):
            if reassociated and t > 0:
                _close(agg, want[0], SCORE_TOL, what=(gar, backend, t))
            else:
                assert torch.equal(agg, want[0]), (gar, backend, t)
            assert torch.equal(sel, want[1].selected), (gar, backend, t)
            _close(scores, want[1].scores, SCORE_TOL)
        if state is None:
            assert got_state is None
            continue
        assert got_state.step == state.step == cases.AGG_CALLS
        for a, b in zip(got_state.history, state.history):
            assert torch.equal(a, b)
        for a, b in zip(got_state.center, state.center):
            assert torch.equal(a, b)
        if isinstance(state.reputation, torch.Tensor):
            _close(got_state.reputation, state.reputation, SCORE_TOL)
        if state.obs != ():
            _hold_ring(got_state.obs, state.obs, True, (name, gar))


@pytest.mark.parametrize("gar", cases.AGG_RULES)
def test_aggregate_logits_matches_the_reference(world, agg_reference, gar):
    """Both worlds, every backend: the reference's aggregates at 1e-4 of
    their largest entry, with equal ``selected``, over 3 calls."""
    for name in WORLDS:
        r = world["ranks"][name][0]
        for backend in cases.BACKENDS:
            for (agg, sel, _), (want, wsel) in zip(
                    r["agg"][(gar, backend)][0], agg_reference[gar]):
                _close(agg, want, what=(name, gar, backend))
                np.testing.assert_array_equal(sel.numpy(), wsel)


# ---------------------------------------------------------------------------
# the robust steps under mesh=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("name", WORLDS)
def test_steps_match_the_single_device_port(world, single, name, step):
    """Each rank's gathered stack, aggregate and selection against the
    single-device step at 1e-4 of their largest entry (under a ``model``
    axis the split forward's stack differs from one device's in the last
    bits, so Bulyan's window ties on either stack are let off); the
    step's aggregate equals the single-device ``aggregate_logits`` on
    the rank's own gathered stack bit for bit; the rank's caches are the
    single-device caches' rows of its replicas."""
    want = single("steps")
    w_agg, w_cache, w_sel, w_stack = want[step]
    resolved = resolve_distance_backend("fused", _Grid(WORLDS[name]))
    for r in world["ranks"][name]:
        agg, cache, sel, stack = r["steps"][step]
        _close(stack, w_stack, what=(name, step, "stack"))
        off = _window_ties(w_stack, stack)
        assert int(off.sum()) <= 1e-2 * off.numel(), (name, step)
        scaled_close(agg, w_agg, off=off.reshape(w_agg.shape), what=(
            name, step))
        assert torch.equal(sel, w_sel), (name, step)
        lo, hi = r["steps"]["rows"]
        assert (hi - lo) * WORLDS[name][0] == cases.N
        for a, b in zip(tree_leaves(cache), tree_leaves(w_cache)):
            _close(a, b[lo:hi], what=(name, step, "cache"))
        spec = cases.serve_spec()
        if step == "verify":
            on_stack = torch.stack([tsr.aggregate_logits(
                stack[:, :, j], spec.f, spec.gar,
                distance_backend=resolved)[0]
                for j in range(stack.shape[2])], dim=1)
        else:
            on_stack = tsr.aggregate_logits(stack, spec.f, spec.gar,
                                            distance_backend=resolved)[0]
        assert torch.equal(agg, on_stack), (name, step)


# ---------------------------------------------------------------------------
# ServingEngine(mesh=)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_reference(world):
    """The reference's per-token engine on the same ensemble, with the
    top-2 gap of every emitted token."""
    inputs = world["inputs"]
    jcfg = jget_reduced(cases.ARCH)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    eng = JEngine(params, jcfg, n_slots=cases.SLOTS, cache_len=cases.CACHE,
                  ensemble=JSpec(f=cases.F, gar="bulyan-krum"))
    rec = GapRecorder(eng)
    want = eng.run([JReq(rid, np.asarray(p, np.int32), cases.NEW)
                    for rid, p in enumerate(inputs["prompts"])],
                   max_steps=40)
    return want, rec.gaps


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("name", WORLDS)
def test_engine_streams_match(world, single, engine_reference, name, run):
    """Every rank's streams equal the single-device port's token for
    token and the reference's per-token streams (a divergence only after
    a reference near-tie); each rank keeps ``n / data`` replicas, each
    cut to its ``model`` slices in the serving layout, and its draft's
    slices."""
    want = single("engine")[run]["streams"]
    ref, gaps = engine_reference
    for r in world["ranks"][name]:
        got = r["engine"][run]
        assert got["streams"] == want, (name, run)
        assert got["n_local"] == cases.N // WORLDS[name][0]
        # the rank keeps its share: its replicas' model slices, and the
        # draft's
        numels, draft = _share_numels(world["inputs"], WORLDS[name])
        assert got["numels"] == numels, (name, run)
        assert got["draft_numels"] == (draft if run == "spec" else []), (
            name, run)
        assert all(len(v) == cases.NEW for v in got["streams"].values())
        assert assert_streams_match(ref, got["streams"], gaps) <= 1


@pytest.mark.parametrize("name", WORLDS)
def test_engine_telemetry_on_equals_off(world, single, name):
    """``telemetry=True`` leaves every rank's streams as they were; after
    every decode step its ring is what ``aggregate_logits`` on one
    device records from the rank's own gathered stack (scores at 1e-6,
    every other field bit for bit); the ring is the single-device
    engine's (scores at 1e-6), the same on every rank; the speculative
    run accepts what one device accepts.  Under a ``model`` axis the
    split forward's stack differs from one device's in the last bits,
    so there the ring's real-valued fields are held to the single-device
    engine's at 1e-4 of their largest entry, its integer fields
    exactly."""
    one = single("engine")
    ranks = world["ranks"][name]
    split = WORLDS[name][1] > 1
    for r in ranks:
        runs = r["engine"]
        assert runs["telemetry"]["streams"] == runs["token"]["streams"]
        pairs = runs["telemetry"]["replay"]
        assert len(pairs) == runs["telemetry"]["telemetry"]["pushed"] > 0
        for got, want in pairs:
            assert torch.equal(got.cursor, want.cursor), name
            assert torch.equal(got.sel_total, want.sel_total), name
            for key, g, w in zip(want.records._fields, got.records,
                                 want.records):
                if key == "scores":
                    _close(g, w, SCORE_TOL, what=(name, key))
                else:
                    assert torch.equal(g, w), (name, key)
        got, want = runs["telemetry"]["telemetry"], one["telemetry"][
            "telemetry"]
        assert got["pushed"] == want["pushed"] > 0
        assert len(got["records"]) == len(want["records"])
        for g, w in zip(got["records"], want["records"]):
            for key in w:
                real = np.issubdtype(np.asarray(w[key]).dtype, np.floating)
                if key == "scores" or (split and real):
                    _close(g[key], w[key], TOL if split else SCORE_TOL,
                           what=(name, key))
                else:
                    np.testing.assert_array_equal(g[key], w[key],
                                                  err_msg=f"{name} {key}")
        np.testing.assert_array_equal(got["selection_frequency"],
                                      want["selection_frequency"])
        np.testing.assert_array_equal(
            runs["spec"]["telemetry"]["accept_counts"],
            one["spec"]["telemetry"]["accept_counts"])
        first = ranks[0]["engine"]["telemetry"]["telemetry"]["records"]
        for g, w in zip(got["records"], first):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])


# ---------------------------------------------------------------------------
# the train step with telemetry under a model axis (F4's other path)
# ---------------------------------------------------------------------------

def test_train_step_with_telemetry_matches_the_single_device_port(
        world, single):
    """One ``make_train_step(mesh=)`` step on the (2, 2) world with
    ``obs-bulyan-krum``: the parameters against the single-device port's
    by the LLM rule (Bulyan window ties let off), the same selection,
    and the ring at 1e-4 (scores from the mesh's distances)."""
    want = single("train")
    init = [np.asarray(x, dtype=np.float64) for x in
            jax.tree_util.tree_leaves(world["inputs"]["train_params"])]
    for r in world["ranks"]["2x2"]:
        got = r["train"]
        ties = window_ties(tree_leaves(want["sub"]), tree_leaves(got["sub"]),
                           cases.F)
        assert sum(int(m.sum()) for m in ties) <= 1e-4 * sum(
            m.numel() for m in ties)
        for i, (a, b, p0) in enumerate(zip(tree_leaves(got["params"]),
                                           tree_leaves(want["params"]),
                                           init)):
            close_change(a.numpy(), b.numpy(), p0, 1, ties[i].numpy(),
                         what=i)
        assert got["metrics"]["byz_weight"] == want["metrics"]["byz_weight"]
        _hold_ring(got["obs"], want["obs"], False, "train")
        np.testing.assert_array_equal(got["obs"].records.selected.numpy(),
                                      want["obs"].records.selected.numpy())
        for k, v in want["metrics"].items():
            _close(got["metrics"][k], v, what=k)


def test_ranks_agree(world):
    """Every rank of a world returns rank 0's aggregates, steps and
    streams bit for bit."""
    for name in WORLDS:
        ranks = world["ranks"][name]
        for r in ranks[1:]:
            for key, (rows, _) in r["agg"].items():
                for (a, s, _), (b, t, _) in zip(rows,
                                                ranks[0]["agg"][key][0]):
                    assert torch.equal(a, b) and torch.equal(s, t)
            for step in STEPS:
                assert torch.equal(r["steps"][step][0],
                                   ranks[0]["steps"][step][0])
            for run in RUNS:
                assert (r["engine"][run]["streams"]
                        == ranks[0]["engine"][run]["streams"])


def test_tree_rebuilds_free_their_inputs_without_the_cycle_collector():
    """``tree_unflatten`` (and so ``tree_map``, ``replicate_params``,
    ``poison_replicas``) holds no reference cycle: a replaced tree's
    leaves are freed as soon as the last name goes, with Python's cycle
    collector off.  A recursive closure had kept them until the
    collector ran, so a serving rank held both whole ensembles it built
    (the honest and the poisoned one) beside its own replicas."""
    import gc
    import weakref

    from repro_torch.core.pytree import tree_map
    was = gc.isenabled()
    gc.disable()
    try:
        tree = {"a": {"w": torch.ones(3)}, "b": [torch.zeros(2)]}
        stacked = tsr.replicate_params(tree, 4, jitter=1e-3)
        ref = weakref.ref(tree_leaves(stacked)[0])
        poisoned = tsr.poison_replicas(stacked, 1, "signflip", scale=10.0)
        del stacked
        assert ref() is None
        ref = weakref.ref(tree_leaves(poisoned)[1])
        doubled = tree_map(lambda x: 2 * x, poisoned)
        del poisoned
        assert ref() is None
        assert tuple(tree_leaves(doubled)[1].shape) == (4, 2)
    finally:
        if was:
            gc.enable()
