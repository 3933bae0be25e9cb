"""Tensor-parallel serving (``shard=`` on ``models.decode``'s prefill,
decode and verify; the robust ensemble steps and ``ServingEngine`` on a
rank's share of the ensemble) against the reference's single-device
functions, on the CPU.

Two gloo worlds (``repro_torch.dist.mesh.run_on_mesh``, one thread per
rank; the rank functions are ``tests/torch_tp_decode_cases.py``'s),
``(1, 2)`` and ``(2, 2)``, spawned once each for the file and side by
side.  In each, every rank:

* runs each family's reduced config (llama3.2-3b and gemma3-1b dense,
  mixtral_8x22b MoE, jamba_1_5_large hybrid with Mamba slots,
  mamba2_130m SSM, whisper_medium with cross-attention) from the
  reference's weights on its ``model`` slices in the serving layout:
  prefill of 12 tokens, 2 decode steps and a 3-token verify block where
  ``verify_supported``; logits (gathered over ``model`` where they are
  the rank's vocabulary columns) and caches are held against the
  reference's ``repro.models`` functions at 1e-4 of their largest entry;
* builds ``ServingEngine(mesh=)`` on ensembles of 2 and 8 reduced
  llama3.2-3b replicas: the rank holds ``1 / model`` of each split leaf
  of its replicas and the rest whole;
* runs one robust decode step of each ensemble: the same collectives,
  call for call, for 2 replicas as for 8;
* runs one robust decode step under a random logits attack, whose
  stack is gathered over ``model`` first: the aggregate and selection of
  the single-device port's step on the same ensemble.

Without a world, the dry-run's ``RecordingMesh`` trace shows that no
decode step all-gathers a parameter leaf.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_tp_decode_cases as cases  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.dist import serve_robust as jsr  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_llm_compare import scaled_close  # noqa: E402

TOL = 1e-4
WORLDS = {"1x2": (1, 2), "2x2": (2, 2)}


def _jcfg(arch):
    return dataclasses.replace(jget_reduced(arch), capacity_factor=100.0)


def _inputs() -> dict:
    """Each family's reference weights, tokens, encoder frames and verify
    block, and the attacked ensemble, as numpy."""
    out = {}
    for i, arch in enumerate(cases.FAMILIES):
        cfg = _jcfg(arch)
        params = jax.tree_util.tree_map(
            np.asarray, jinit_model(jax.random.PRNGKey(i + 1), cfg))
        rng = np.random.default_rng(i)
        tokens = rng.integers(0, cfg.vocab_size, (cases.B, cases.S0
                                                  + cases.STEPS)
                              ).astype(np.int32)
        extra = None
        if cfg.arch_type in ("audio", "vlm"):
            extra = rng.standard_normal(
                (cases.B, cfg.encoder_seq or cfg.vision_seq, cfg.d_model)
            ).astype(np.float32)
        block = rng.integers(0, cfg.vocab_size, (cases.B, cases.K)
                             ).astype(np.int32)
        out[arch] = (params, tokens, extra, block)
    cfg = _jcfg(cases.ENS_ARCH)
    ens = jsr.replicate_params(jinit_model(jax.random.PRNGKey(9), cfg), 8,
                               jitter=1e-3, key=jax.random.PRNGKey(4))
    out["attack_params"] = jax.tree_util.tree_map(np.asarray, ens)
    return out


@pytest.fixture(scope="module")
def world():
    """Both worlds' results (run side by side), computed once."""
    inputs = _inputs()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {name: pool.submit(
            run_on_mesh, cases.tp_case, shape, args=(inputs,),
            device="cpu", num_threads=1, timeout=600)
            for name, shape in WORLDS.items()}
        ranks = {name: fut.result() for name, fut in futs.items()}
    return {"inputs": inputs, "ranks": ranks}


@pytest.fixture(scope="module")
def reference(world):
    """The reference's prefill, decode steps and verify block per family
    (lazily)."""
    inputs, memo = world["inputs"], {}

    def get(arch):
        if arch not in memo:
            cfg = _jcfg(arch)
            params, tokens, extra, block = inputs[arch]
            lg, cache = jdecode.prefill(params, cfg, tokens[:, :cases.S0],
                                        extra, cache_len=cases.CACHE)
            rec = {"prefill": (lg, cache), "decode": []}
            prefilled = cache
            for t in range(cases.STEPS):
                pos = jnp.full((cases.B,), cases.S0 + t, jnp.int32)
                lg, cache = jdecode.decode_step(
                    params, cfg, cache,
                    tokens[:, cases.S0 + t:cases.S0 + t + 1], pos)
                rec["decode"].append((lg, cache))
            if jdecode.verify_supported(cfg)[0]:
                rec["verify"] = jdecode.verify_step(
                    params, cfg, prefilled, block,
                    jnp.full((cases.B,), cases.S0, jnp.int32))
            memo[arch] = rec
        return memo[arch]

    return get


def _close(got, want, what=""):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape))
    scaled_close(got, want, tol=TOL, what=what)


def _close_tree(got, want, what=""):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        _close(g, w, what=(what, i))


def test_every_rank_sees_its_own_coordinates(world):
    for name, shape in WORLDS.items():
        coords = [r["coords"] for r in world["ranks"][name]]
        assert coords == [{"data": i, "model": j} for i in range(shape[0])
                          for j in range(shape[1])]


@pytest.mark.parametrize("arch", cases.FAMILIES)
@pytest.mark.parametrize("name", WORLDS)
def test_split_serving_matches_the_reference(world, reference, name, arch):
    """Prefill, decode and verify on a rank's slices: logits and caches
    at 1e-4 of their largest entry off the reference's single-device
    functions; the logits leave as the rank's vocabulary columns (every
    family's output table splits on the vocabulary here)."""
    want = reference(arch)
    for r in world["ranks"][name]:
        got = r[arch]
        assert got["split"]
        _close(got["prefill"][0], want["prefill"][0], (name, arch, "prefill"))
        _close_tree(got["prefill"][1], want["prefill"][1],
                    (name, arch, "prefill cache"))
        for t in range(cases.STEPS):
            _close(got["decode"][t][0], want["decode"][t][0],
                   (name, arch, "decode", t))
            _close_tree(got["decode"][t][1], want["decode"][t][1],
                        (name, arch, "decode cache", t))
        assert ("verify" in got) == ("verify" in want)
        if "verify" in want:
            _close(got["verify"][0], want["verify"][0], (name, arch, "verify"))
            _close_tree(got["verify"][1], want["verify"][1],
                        (name, arch, "verify cache"))
        # the plain step of dist/serve.py is the same call
        assert torch.equal(got["serve_step"], got["decode"][0][0])


@pytest.mark.parametrize("name", WORLDS)
def test_ranks_agree_and_decode_runs_on_the_model_axis(world, name):
    """Every rank gathers the same logits bit for bit; each decode step
    ran collectives over ``model``."""
    ranks = world["ranks"][name]
    for arch in cases.FAMILIES:
        for r in ranks:
            for t in range(cases.STEPS):
                assert torch.equal(r[arch]["decode"][t][0],
                                   ranks[0][arch]["decode"][t][0]), arch
                comm = r[arch]["comm"][t]
                assert comm["all_reduce"]["calls"] > 0, (arch, comm)
                assert comm["gather"]["calls"] == 0, (arch, comm)


@pytest.mark.parametrize("name", WORLDS)
def test_a_rank_holds_one_model_slice_of_each_split_leaf(world, name):
    """The engine's share: each split leaf at ``1 / model`` of its
    replicas' whole leaf, every other leaf whole; its bytes are what
    that gives, under half of the rank's replicas whole on (., 2)."""
    data, model = WORLDS[name]
    for r in world["ranks"][name]:
        for n, share in r["share"].items():
            per = n // data if n % data == 0 else n
            assert share["n_local"] == per
            split = 0
            for local, whole, is_split in share["leaves"]:
                want = whole // n * per // (model if is_split else 1)
                assert local == want
                split += is_split
            assert split > 0
            mine = share["whole_bytes"] // n * per
            assert share["share_bytes"] < 0.52 * mine, (n, share)


@pytest.mark.parametrize("name", WORLDS)
def test_decode_collectives_do_not_grow_with_the_replicas(world, name):
    """One robust decode step of 2 replicas and one of 8 make the same
    collectives per kind; only their bytes grow."""
    for r in world["ranks"][name]:
        small, big = (r["ensemble"][n]["by_kind"] for n in cases.ENS_SIZES)
        assert {k: v["calls"] for k, v in small.items()} == {
            k: v["calls"] for k, v in big.items()}
        assert sum(v["calls"] for v in big.values()) > 0
        assert (sum(v["bytes"] for v in big.values())
                > sum(v["bytes"] for v in small.values()))


@pytest.mark.parametrize("name", WORLDS)
def test_attacked_step_matches_the_single_device_port(world, name):
    """A random logits attack sees the whole stack (gathered over
    ``model``) and draws the whole noise: every rank's aggregate is the
    single-device port's at 1e-4 of its largest entry, with the same
    selection."""
    want = cases.attacked_step(None, world["inputs"]["attack_params"])
    for r in world["ranks"][name]:
        got = r["attacked"]
        scaled_close(got["agg"], want["agg"], tol=TOL, what=name)
        assert torch.equal(got["selected"], want["selected"])


# ---------------------------------------------------------------------------
# no parameter gathers (the dry-run's recording mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", cases.FAMILIES)
@pytest.mark.parametrize("shape", list(WORLDS.values()), ids=list(WORLDS))
def test_no_decode_step_gathers_a_parameter_leaf(arch, shape):
    """The robust decode step (and the verify block where supported) on
    a rank's share, traced with every parameter leaf watched: no
    all-gather takes a parameter leaf's storage, and the step does run
    collectives over ``model``."""
    cfg = cases.tp_cfg(arch)
    steps = [AggSpec(f=1, gar="bulyan-krum", distance_backend="pallas")]
    from repro_torch.models import verify_supported
    if verify_supported(cfg)[0]:
        steps.append(dataclasses.replace(steps[0], speculative_k=3))
    for spec in steps:
        for rank in range(shape[0] * shape[1]):
            mesh = dryrun.RecordingMesh(shape, rank=rank)
            pred = dryrun.trace_serve_step(cfg, spec, mesh, 8, cases.B,
                                           cases.CACHE)
            assert pred["by_kind"]["all_reduce"]["calls"] > 0
            leaves = [g["leaf"] for g in pred["gathers"]]
            assert leaves and not any(leaves), (arch, leaves)


@pytest.mark.parametrize("arch", cases.FAMILIES)
def test_the_serving_shard_refuses_to_gather_a_parameter(arch):
    """``serve_shard``'s ``Shard`` refuses to gather a leaf on use (it
    raises where a layer would), a train-step shard gathers it, and the
    serving layout splits a subset of the train step's leaves."""
    from repro_torch.dist.serve import serve_shard, serve_specs
    from repro_torch.dist.sharding import (P, _spec_leaves, model_dim,
                                           param_shardings)
    from repro_torch.dist.tensor_parallel import Shard, model_shard
    from repro_torch.models import init_model
    cfg = cases.tp_cfg(arch)
    mesh = dryrun.RecordingMesh((1, 2))
    assert serve_shard(cfg, mesh)["periods"].gathers is False
    p = {"w": torch.zeros((4, 6), device="meta")}
    with pytest.raises(ValueError, match="READ_WHOLE"):
        Shard(mesh, {"w": 1}, gathers=False).get(p, "w")
    with pytest.raises(ValueError, match="READ_WHOLE"):
        Shard(mesh, {"w": 1}, gathers=False).relayout(p["w"], 1, 0)
    with pytest.raises(ValueError, match="READ_WHOLE"):
        Shard(mesh, {"w": 0}, gathers=False).entry(p, 0)
    assert model_shard(mesh, {"w": P(None, "model")}).get(
        p, "w").shape == (4, 12)
    train = _spec_leaves(param_shardings(init_model(0, cfg, device="meta"),
                                         mesh))
    serve = _spec_leaves(serve_specs(cfg, mesh))
    assert all(model_dim(s) in (None, model_dim(t))
               for s, t in zip(serve, train))
