"""The serving cache written in place (``models.decode.decode_step_`` /
``verify_step_`` and ``ServingEngine._splice``), on the CPU at reduced
size:

* every leaf of an engine's cache (and of its draft cache) keeps its
  storage across decode steps, verify blocks and admissions;
* the served tokens equal, bit for bit, those of the same engine whose
  steps go through the functional ``decode_step`` / ``verify_step``;
* ``decode_step`` and ``verify_step`` leave their input cache unwritten
  and give the in-place core's logits and new cache bit for bit.

Engines: ensemble, single-model and speculative (``speculative_k=3``)
on reduced llama3.2-3b; ensemble and single-model on reduced
jamba-1.5 with a third layer, a Mamba slot as an unstacked tail, so a
Mamba state written back through a view and a tail cache are covered;
ensemble on reduced gemma3-1b with a third layer, a sliding-window ring
as the tail.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.agg import AggSpec  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.dist import serve_robust  # noqa: E402
from repro_torch.dist.serve_robust import replicate_params  # noqa: E402
from repro_torch.models import (decode_step, init_model,  # noqa: E402
                                prefill, verify_step)
from repro_torch.models.decode import (decode_step_,  # noqa: E402
                                       verify_step_)
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import speculative  # noqa: E402


def _cfg(arch: str, n_layers: int = 0):
    cfg = get_reduced(arch)
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


#: (id, config, ensemble, speculative_k)
ENGINES = {
    "llama-ensemble": ("llama3_2_3b", 0, True, 0),
    "llama-plain": ("llama3_2_3b", 0, False, 0),
    "llama-speculative": ("llama3_2_3b", 0, True, 3),
    "jamba-tail-ensemble": ("jamba_1_5_large", 3, True, 0),
    "jamba-tail-plain": ("jamba_1_5_large", 3, False, 0),
    "gemma3-ring-tail-ensemble": ("gemma3_1b", 3, True, 0),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _engine(case: str) -> ServingEngine:
    arch, n_layers, ensemble, k = ENGINES[case]
    cfg = _cfg(arch, n_layers)
    params = init_model(0, cfg, device="cpu")
    if not ensemble:
        return ServingEngine(params, cfg, n_slots=2, cache_len=32)
    stacked = replicate_params(params, 5, jitter=1e-3,
                               generator=torch.Generator().manual_seed(3))
    spec = AggSpec(f=1, gar="krum", distance_backend="fused",
                   speculative_k=k)
    return ServingEngine(stacked, cfg, n_slots=2, cache_len=32,
                         ensemble=spec)


def _requests(vocab: int):
    """Five requests on two slots, of several lengths, so slots are
    refilled mid-stream."""
    rng = np.random.default_rng(11)
    return [Request(i, rng.integers(0, vocab, 5 + 2 * i).astype(np.int32),
                    3 + (i % 3)) for i in range(5)]


def _caches(engine):
    trees = [engine.cache]
    if engine.spec_k:
        trees.append(engine.draft_cache)
    return [x for t in trees for x in tree_leaves(t)]


def _serve(engine, steps: int = 60):
    """The engine's streams, stepped by hand, and the cache leaves'
    storage after every step."""
    requests = _requests(engine.cfg.vocab_size)
    for req in requests:
        engine.submit(req)
    ptrs = []
    for _ in range(steps):
        if not engine.pending and not any(engine.active):
            break
        engine.step()
        ptrs.append([x.data_ptr() for x in _caches(engine)])
    assert all(r.done for r in requests)
    return {r.rid: r.generated for r in requests}, ptrs


def _through(functional):
    """An in-place step made of a functional one: its new cache copied
    back into the caller's tree."""
    def step(params, cfg, cache, tokens, pos, shard=None):
        logits, new = functional(params, cfg, cache, tokens, pos,
                                 shard=shard)
        for old, leaf in zip(tree_leaves(cache), tree_leaves(new)):
            old.copy_(leaf)
        return logits
    return step


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_cache_keeps_its_storage(case):
    engine = _engine(case)
    before = [x.data_ptr() for x in _caches(engine)]
    _, ptrs = _serve(engine)
    # five requests on two slots: admissions after the first step
    assert len(ptrs) >= 3
    for after in ptrs:
        assert after == before


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_tokens_equal_the_functional_steps(case, monkeypatch):
    got, _ = _serve(_engine(case))
    for mod in (serve_robust, engine_mod, speculative):
        if hasattr(mod, "decode_step_"):
            monkeypatch.setattr(mod, "decode_step_", _through(decode_step))
        if hasattr(mod, "verify_step_"):
            monkeypatch.setattr(mod, "verify_step_", _through(verify_step))
    want, _ = _serve(_engine(case))
    assert got == want


def _filled(cfg, batch: int, cache_len: int, seed: int):
    """A cache with a prompt's keys and values in every slot (and a
    Mamba state), as an admission leaves it."""
    gen = torch.Generator().manual_seed(seed)
    params = init_model(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (batch, 6), generator=gen)
    _, cache = prefill(params, cfg, tokens, cache_len=cache_len)
    return params, cache


@pytest.mark.parametrize("arch,n_layers", [("jamba_1_5_large", 3),
                                           ("gemma3_1b", 3),
                                           ("llama3_2_3b", 0)])
def test_decode_step_leaves_its_input_unwritten(arch, n_layers):
    cfg = _cfg(arch, n_layers)
    params, cache = _filled(cfg, 2, 16, 5)
    keep = tree_map(torch.clone, cache)
    token = torch.tensor([[3], [7]], dtype=torch.int32)
    pos = np.array([6, 6], np.int32)
    logits, new = decode_step(params, cfg, cache, token, pos)
    for a, b in zip(tree_leaves(cache), tree_leaves(keep)):
        assert torch.equal(a, b)
    core = decode_step_(params, cfg, keep, token, pos)
    assert torch.equal(logits, core)
    # every leaf took the step's row (or a Mamba slot's new state)
    for a, b, c in zip(tree_leaves(new), tree_leaves(keep),
                       tree_leaves(cache)):
        assert torch.equal(a, b)
        assert not torch.equal(b, c)


def test_verify_step_leaves_its_input_unwritten():
    cfg = _cfg("llama3_2_3b")
    params, cache = _filled(cfg, 2, 16, 6)
    keep = tree_map(torch.clone, cache)
    block = torch.tensor([[3, 4, 5], [7, 8, 9]], dtype=torch.int32)
    pos = np.array([6, 6], np.int32)
    logits, new = verify_step(params, cfg, cache, block, pos)
    for a, b in zip(tree_leaves(cache), tree_leaves(keep)):
        assert torch.equal(a, b)
    core = verify_step_(params, cfg, keep, block, pos)
    assert torch.equal(logits, core)
    for a, b, c in zip(tree_leaves(new), tree_leaves(keep),
                       tree_leaves(cache)):
        assert torch.equal(a, b)
        assert not torch.equal(b, c)


def test_robust_steps_return_the_tree_they_write():
    cfg = _cfg("jamba_1_5_large", 3)
    params, cache = _filled(cfg, 2, 16, 7)
    stacked = replicate_params(params, 5, jitter=1e-3,
                               generator=torch.Generator().manual_seed(3))
    caches = serve_robust.replicate_cache(cache, 5)
    keep = tree_map(torch.clone, caches)
    step = serve_robust.make_robust_serve_step(
        cfg, AggSpec(f=1, gar="krum", distance_backend="fused"))
    token = torch.tensor([[3], [7]], dtype=torch.int32)
    pos = np.array([6, 6], np.int32)
    agg, out, _, _ = step(stacked, caches, token, pos)
    assert out is caches
    # each replica's rows are what its own in-place core writes
    for r in range(5):
        one = tree_map(lambda x: x[r].clone(), keep)
        decode_step_(tree_map(lambda x: x[r], stacked), cfg, one, token,
                     pos)
        for a, b, c in zip(tree_leaves(one), tree_leaves(caches),
                           tree_leaves(keep)):
            torch.testing.assert_close(b[r], a)
            assert not torch.equal(b[r], c[r])
    assert agg.shape == (2, cfg.vocab_size)
