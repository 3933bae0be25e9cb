"""The zoo's Byzantine train step (``repro_torch.dist.train``) against the
reference's ``jax.jit(make_train_step(...))``: three steps from the same
weights (``params_from_jax``) and the same ``lm_batches``, n = 7, f = 1,
on reduced llama3.2-3b and gemma3-1b.

Cases: ``bulyan-krum`` under ``omniscient_linf`` (the port's ``fused``
backend), ``average`` with no attack (``xla``), and the stateful
``reputation-krum`` under ``omniscient_linf`` with a clean ``aux_batch``
and ``rep_lr`` (``pallas``), its state carried; all three with
momentum, as the reference's own sharded-vs-single-device test does.
Each leaf's change from the initial weights and each momentum leaf agree
at 1e-4 of the reference's largest entry in that leaf (a parameter's
change also gets one fp32 unit in the last place of the parameter per
step taken: the two packages round ``p + update`` independently);
metrics and the carried reputation at 1e-4 of max(1, |want|),
``byz_weight`` exactly.  AdamW is held apart, on the zoo's trees with
the same gradients fed to both packages: inside the step its update
``m / (sqrt(v) + eps)`` turns gradient noise of 1e-9 between the two
frameworks into up to ``lr`` wherever a coordinate's gradient is near
``eps`` (about 1 in 200 coordinates here, and moving 1e-3 of the
leaf's largest change later on; ROADMAP §3).

Also: step 0's submissions and ``selected`` against the reference's
``inject_byzantine`` + ``distributed_aggregate``, the three distance
backends against each other, ``worker_chunk`` against one ``vmap`` pass,
and ``mesh=`` without a template.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro.dist import train as jtrain  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.dist import robust as trobust  # noqa: E402
from repro_torch.dist import train as ttrain  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from torch_llm_compare import (close_change, scaled_close,  # noqa: E402
                               window_ties)

N, F = 7, 1
LINF = ()
ARCHS = ("llama3_2_3b", "gemma3_1b")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


@functools.lru_cache(maxsize=None)
def _jax_submissions_fn(arch):
    cfg = jget_reduced(arch)
    vg = jax.value_and_grad(jtrain.make_loss_fn(cfg))

    def fn(params, tokens, labels):
        grads = jax.vmap(lambda t, l: vg(params, t, l)[1])(tokens, labels)
        return jrobust.inject_byzantine(grads, F, "omniscient_linf",
                                        gar_name="bulyan-krum")

    return jax.jit(fn)


def _jax_submissions(arch, params, batch):
    """The reference's step-internal submissions: ``vmap`` of
    ``value_and_grad``, then ``omniscient_linf``."""
    return _jax_submissions_fn(arch)(params, batch["tokens"],
                                     batch["labels"])


def _batch(vocab, step, seed=7):
    toks, labs = zip(*(lm_batches(vocab, 2, 16, step * N + w, seed=seed)
                       for w in range(N)))
    return {"tokens": np.stack(toks), "labels": np.stack(labs)}


def _case(name, vocab):
    """(spec kwargs, port backend) of one case."""
    aux = lm_batches(vocab, 2, 16, 999, seed=7)
    return {
        "bulyan": (dict(f=F, gar="bulyan-krum", attack="omniscient_linf",
                        attack_kwargs=LINF), "fused"),
        "average": (dict(f=F, gar="average", attack="none"), "xla"),
        "reputation": (dict(f=F, gar="reputation-krum",
                            attack="omniscient_linf", attack_kwargs=LINF,
                            rep_lr=0.5, aux_batch=aux), "pallas"),
    }[name]


def _run_both(arch, case, steps=3):
    cfg = jget_reduced(arch)
    spec_kw, backend = _case(case, cfg.vocab_size)
    params = jinit_model(jax.random.PRNGKey(1), cfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    jopt = jget_optimizer("momentum", 1e-2)
    topt = get_optimizer("momentum", 1e-2)
    jspec = jtrain.DistByzantineSpec(**spec_kw)
    tspec = ttrain.DistByzantineSpec(distance_backend=backend, **spec_kw)
    jstep = jax.jit(jtrain.make_train_step(cfg, jspec, jopt))
    tstep = ttrain.make_train_step(get_reduced(arch), tspec, topt)
    jstate, tstate = jopt.init(params), topt.init(tparams)
    jagg = jtrain.init_agg_state(jspec, params, N)
    tagg = ttrain.init_agg_state(tspec, tparams, N)
    out, ties = [], None
    init = [np.asarray(l, dtype=np.float64)
            for l in jax.tree_util.tree_leaves(params)]
    tloss = ttrain.make_loss_fn(get_reduced(arch))
    for t in range(steps):
        batch = _batch(cfg.vocab_size, t)
        if "bulyan" in tspec.gar:
            sub = tree_leaves(ttrain.byzantine_grads(tloss, tspec, tparams,
                                                     batch, t)[1])
            tie = window_ties(sub, jax.tree_util.tree_leaves(
                _jax_submissions(arch, params, batch)), F)
            ties = tie if ties is None else [a | b for a, b in zip(ties,
                                                                    tie)]
        if jagg is None:
            params, jstate, jm = jstep(params, jstate, batch)
            tparams, tstate, tm = tstep(tparams, tstate, batch)
        else:
            params, jstate, jm, jagg = jstep(params, jstate, batch, jagg)
            tparams, tstate, tm, tagg = tstep(tparams, tstate, batch, tagg)
        out.append(dict(
            init=init,
            jparams=jax.tree_util.tree_map(np.asarray, params),
            tparams=[p.clone() for p in tree_leaves(tparams)],
            jstate=jax.tree_util.tree_map(np.asarray, jstate),
            tstate=tstate, jm={k: float(v) for k, v in jm.items()},
            tm={k: float(v) for k, v in tm.items()},
            jrep=None if jagg is None else np.asarray(jagg.reputation),
            trep=None if tagg is None else tagg.reputation.clone(),
            ties=ties))
    return out


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch, case):
        if (arch, case) not in cache:
            cache[(arch, case)] = _run_both(arch, case)
        return cache[(arch, case)]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["bulyan", "average", "reputation"])
def test_three_steps_match_the_reference(runs, arch, case):
    for t, r in enumerate(runs(arch, case)):
        jleaves = jax.tree_util.tree_leaves(r["jparams"])
        assert len(jleaves) == len(r["tparams"])
        ties = ([m.numpy() for m in r["ties"]] if r["ties"] is not None
                else [None] * len(jleaves))
        if r["ties"] is not None:   # under 1 in 10,000 coordinates
            tied = sum(int(m.sum()) for m in ties)
            assert tied <= 1e-4 * sum(m.size for m in ties), tied
        for i, (a, b, p0) in enumerate(zip(jleaves, r["tparams"],
                                           r["init"])):
            close_change(b.numpy(), a, p0, t + 1, ties[i],
                          what=(t, "param", i))
        assert r["tstate"]["step"] == int(r["jstate"]["step"])
        assert set(r["tstate"]) == set(r["jstate"]) == {"step", "m"}
        for i, (a, b) in enumerate(zip(
                jax.tree_util.tree_leaves(r["jstate"]["m"]),
                tree_leaves(r["tstate"]["m"]))):
            scaled_close(b.numpy(), a, ties[i], what=(t, "m", i))
        assert set(r["tm"]) == set(r["jm"])
        for k, v in r["jm"].items():
            _close(r["tm"][k], v, what=(t, k))
        assert r["tm"]["byz_weight"] == r["jm"]["byz_weight"]
        if r["jrep"] is not None:
            _close(r["trep"].numpy(), r["jrep"], what=(t, "reputation"))


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_on_the_zoo_tree(arch):
    """Three AdamW updates (lr 3e-4, the default weight decay) of the
    zoo's nested, period-stacked tree from the same seeded gradients in
    both packages: each leaf's change, ``m`` and ``v`` at 1e-4 of the
    reference's largest entry in that leaf."""
    params = jinit_model(jax.random.PRNGKey(1), jget_reduced(arch))
    init = [np.asarray(l, dtype=np.float64)
            for l in jax.tree_util.tree_leaves(params)]
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    jopt, topt = jget_optimizer("adamw", 3e-4), get_optimizer("adamw", 3e-4)
    jstate, tstate = jopt.init(params), topt.init(tparams)
    rng = np.random.default_rng(3)
    for t in range(3):
        g = jax.tree_util.tree_map(
            lambda p: (1e-3 * rng.standard_normal(p.shape)).astype(
                np.float32), params)
        params, jstate = jopt.update(g, jstate, params)
        tparams, tstate = topt.update(params_from_jax(g, "cpu"), tstate,
                                      tparams)
    for i, (a, b, p0) in enumerate(zip(jax.tree_util.tree_leaves(params),
                                       tree_leaves(tparams), init)):
        close_change(b.numpy(), a, p0, 3, what=("param", i))
    assert tstate["step"] == int(jstate["step"]) == 3
    for key in ("m", "v"):
        for i, (a, b) in enumerate(zip(
                jax.tree_util.tree_leaves(jstate[key]),
                tree_leaves(tstate[key]))):
            scaled_close(b.numpy(), a, what=(key, i))


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_submissions_and_selection(arch):
    """The per-worker gradients after ``omniscient_linf`` and Bulyan's
    ``selected`` on them, against the reference's ``vmap`` of
    ``value_and_grad``, ``inject_byzantine`` and
    ``distributed_aggregate``."""
    cfg = jget_reduced(arch)
    params = jinit_model(jax.random.PRNGKey(1), cfg)
    batch = _batch(cfg.vocab_size, 0)
    jgrads = _jax_submissions(arch, params, batch)
    jagg, jres = jax.jit(lambda g: jrobust.distributed_aggregate(
        g, F, "bulyan-krum"))(jgrads)
    spec = ttrain.DistByzantineSpec(f=F, gar="bulyan-krum",
                                    attack="omniscient_linf",
                                    attack_kwargs=LINF)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    _, tgrads = ttrain.byzantine_grads(ttrain.make_loss_fn(get_reduced(arch)),
                                       spec, tparams, batch, 0)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jgrads),
                                   tree_leaves(tgrads))):
        scaled_close(b, a, what=("submissions", i))
    ties = window_ties(tree_leaves(tgrads),
                       jax.tree_util.tree_leaves(jgrads), F)
    for backend in ("xla", "pallas", "fused"):
        tagg, tres = trobust.distributed_aggregate(
            tgrads, F, "bulyan-krum", distance_backend=backend)
        assert np.array_equal(tres.selected.numpy(),
                              np.asarray(jres.selected)), backend
        for i, (a, b, m) in enumerate(zip(jax.tree_util.tree_leaves(jagg),
                                          tree_leaves(tagg), ties)):
            scaled_close(b, a, m, what=(backend, i))


def test_backends_and_worker_chunk_agree():
    """Two steps of ``bulyan-krum`` under ``xla``, ``pallas`` and
    ``fused`` on the CPU agree (each leaf's change at 1e-4 of its largest,
    off Bulyan's window ties, as in the reference comparison), and so
    does ``worker_chunk=3`` (three ``vmap`` passes, whose batched matmuls
    over 3 workers round differently from one pass over 7)."""
    cfg = get_reduced("llama3_2_3b")
    loss = ttrain.make_loss_fn(cfg)
    opt = get_optimizer("momentum", 1e-2)
    init = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jinit_model(jax.random.PRNGKey(1),
                                jget_reduced("llama3_2_3b"))), "cpu")
    runs = {}
    for backend, chunk in (("xla", None), ("pallas", None),
                           ("fused", None), ("fused", 3)):
        spec = ttrain.DistByzantineSpec(
            f=F, gar="bulyan-krum", attack="omniscient_linf",
            attack_kwargs=LINF, distance_backend=backend)
        step = ttrain.make_train_step(cfg, spec, opt, worker_chunk=chunk)
        params, state, subs = init, opt.init(init), []
        for t in range(2):
            batch = _batch(cfg.vocab_size, t)
            subs.append(tree_leaves(ttrain.byzantine_grads(
                loss, spec, params, batch, t, worker_chunk=chunk)[1]))
            params, state, _ = step(params, state, batch)
        runs[(backend, chunk)] = (tree_leaves(params), subs)
    want, wsubs = runs[("xla", None)]
    for key, (leaves, subs) in runs.items():
        ties = None
        for a, b in zip(wsubs, subs):
            tie = window_ties(a, b, F)
            ties = tie if ties is None else [x | y for x, y in zip(ties,
                                                                   tie)]
        tied = sum(int(m.sum()) for m in ties)  # under 1 in 10,000
        assert tied <= 1e-4 * sum(m.numel() for m in ties), (key, tied)
        for i, (a, b, p0) in enumerate(zip(want, leaves,
                                           tree_leaves(init))):
            close_change(b, a, p0, 2, ties[i], what=(key, i))


def test_init_agg_state_and_stateless_signature():
    cfg = get_reduced("gemma3_1b")
    from repro_torch.models import init_model
    params = init_model(0, cfg, device="cpu")
    spec = ttrain.DistByzantineSpec(f=F, gar="bulyan-krum")
    assert ttrain.init_agg_state(spec, params, N) is None
    rep = ttrain.DistByzantineSpec(f=F, gar="reputation-krum")
    state = ttrain.init_agg_state(rep, params, N)
    assert torch.equal(state.reputation, torch.ones(N))
    assert state.step == 0


def test_mesh_is_item_6():
    """ROADMAP item 6 is the mesh path (``tests/test_torch_sharded.py``);
    a mesh without the global parameter template says what it needs."""
    from repro_torch.dist.mesh import make_host_mesh
    spec = ttrain.DistByzantineSpec(f=F, gar="bulyan-krum")
    with pytest.raises(ValueError, match="mesh= needs template="):
        ttrain.make_train_step(get_reduced("llama3_2_3b"), spec,
                               get_optimizer("sgd", 0.1),
                               mesh=make_host_mesh(device="cpu"))


@pytest.mark.parametrize("vocab,batch,seq,step,seed", [
    (1024, 2, 16, 0, 0), (2048, 3, 33, 5, 7), (262144, 1, 64, 11, 3),
    (50, 4, 1, 2, 1)])
def test_lm_batches_bit_identical(vocab, batch, seq, step, seed):
    from repro.data.synthetic import lm_batches as jlm
    for a, b in zip(lm_batches(vocab, batch, seq, step, seed=seed),
                    jlm(vocab, batch, seq, step, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_zoo_imports_no_jax_and_no_reference():
    """The zoo, the configs, the checkpoint store, the train step and the
    example driver import torch and numpy only."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import sys, runpy\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.checkpoint, repro_torch.dist.train\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "runpy.run_path('examples/train_llm_torch.py', run_name='x')\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env={**os.environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no device given, nothing drops to the CPU."""
    from repro_torch.models import init_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(0, get_reduced("gemma3_1b"))
    import runpy
    import pathlib
    ex = runpy.run_path(str(pathlib.Path(__file__).resolve().parent.parent
                            / "examples" / "train_llm_torch.py"),
                        run_name="example")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex["main"](["--steps", "1"])
