"""DeepSeek-V2-Lite in the port (``configs/deepseek_v2_lite.py``): latent
attention with YaRN, a leading dense layer and the dropless routed
experts of a held share through the grouped GEMM, held on the CPU at
``reduced()`` against the plain reference of ``deepseek_v2_reference.py``
(the benchmark's ``bench/reference/deepseek_v2.py``), which imports
nothing of the port.  The JAX package has neither mechanism, so no JAX
parity here.

* logits, the loss and every worker's gradient through the train step's
  ``vmap`` path, and one ``make_train_step`` step;
* YaRN's frequencies, ramp and softmax scale against the published
  formulas (``modeling_deepseek.py``);
* dropless routing under a forced imbalance (one held expert takes
  every token, one none), with the row counter;
* the grouped GEMM's oracle, its ``vmap`` rule and its gradient against
  ``torch.mm`` per group;
* the held-share sum: every share's routed part, plus the shared FFN
  counted once, is the uncut layer; renormalized gates and the
  sequence-wise balance loss;
* the registry, the refusals of serving and ``mesh=``, the spans, and
  outputs bit for bit with the recorder on and off.

Tolerances: float32 on both sides, the products taken in different
orders (the port's half-split rope against the reference's
``rotate_half``, the top-k slots summed in another order, batched
against per-sequence products), so values agree to a few float32 ulps of
their scale: 1e-5 of the largest entry for logits and layer outputs,
1e-4 of each leaf's largest entry for gradients (sums of many such
products), 1e-6 relative for losses.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import deepseek_v2_reference as ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.pytree import (tree_leaves,  # noqa: E402
                                     tree_unflatten)
from repro_torch.dist.train import (DistByzantineSpec,  # noqa: E402
                                    byzantine_grads, make_loss_fn,
                                    make_train_step)
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402
from repro_torch.models import forward, init_model, mla, moe  # noqa: E402
from repro_torch.obs.trace import SpanRecorder  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402

CFG = configs.get_reduced("deepseek-v2-lite")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _c(cfg):
    """The reference's sizes, read from the port's configuration."""
    return {"heads": cfg.n_heads, "nope": cfg.qk_nope_head_dim,
            "rope": cfg.qk_rope_head_dim, "v": cfg.v_head_dim,
            "kv_lora": cfg.kv_lora_rank, "eps": 1e-6,
            "rope_theta": cfg.rope_theta,
            "yarn": {"factor": cfg.yarn_factor,
                     "original_max_position_embeddings":
                         cfg.yarn_original_len,
                     "beta_fast": cfg.yarn_beta_fast,
                     "beta_slow": cfg.yarn_beta_slow,
                     "mscale": cfg.yarn_mscale,
                     "mscale_all_dim": cfg.yarn_mscale_all_dim},
            "dense": cfg.n_dense_lead, "layers": cfg.n_layers,
            "top_k": cfg.moe_top_k, "norm_topk": cfg.moe_norm_topk,
            "scaling": cfg.moe_scaling, "held_start": cfg.moe_held_start}


def _close(got, want, rel):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * max(scale, 1e-30), (err, scale)


def _tokens(seed, shape):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, shape, generator=gen)


def test_logits_match_the_reference():
    params = init_model(3, CFG, device="cpu")
    tok = _tokens(0, (2, 48))
    got, aux = forward(params, CFG, tok)
    assert float(aux) == 0.0          # moe_seq_aux 0: no balance loss
    for b in range(2):
        _close(got[b], ref.logits(params, tok[b], _c(CFG)), 1e-5)


def test_loss_and_worker_grads_through_the_vmap_path():
    """``byzantine_grads`` (``vmap(grad)`` over workers, 2 per pass, the
    grouped GEMM's ``vmap`` rule folding them) against the reference's
    autograd, worker by worker; then one step's honest mean loss."""
    params = init_model(4, CFG, device="cpu")
    n, seq = 3, 24
    tok, lab = _tokens(1, (n, 1, seq)), _tokens(2, (n, 1, seq))
    spec = DistByzantineSpec(f=0, gar="average", attack="none")
    losses, grads = byzantine_grads(make_loss_fn(CFG), spec, params,
                                    {"tokens": tok, "labels": lab}, 0,
                                    worker_chunk=2)
    leaves = tree_leaves(params)
    got = tree_leaves(grads)
    want_losses = []
    for w in range(n):
        ps = [p.detach().clone().requires_grad_() for p in leaves]
        tree = tree_unflatten(params, ps)
        lg = ref.logits(tree, tok[w, 0], _c(CFG))
        loss = torch.mean(torch.logsumexp(lg, -1)
                          - lg.gather(-1, lab[w, 0, :, None])[:, 0])
        want = torch.autograd.grad(loss, ps, allow_unused=True)
        want_losses.append(float(loss.detach()))
        assert abs(float(losses[w]) - want_losses[-1]) <= 1e-6 * abs(
            want_losses[-1])
        for g, wg in zip(got, want):
            wg = torch.zeros_like(g[w]) if wg is None else wg
            _close(g[w], wg, 1e-4)
    step = make_train_step(CFG, DistByzantineSpec(f=0, gar="average",
                                                  attack="none"),
                           get_optimizer("adamw", 3e-4), worker_chunk=3)
    opt = get_optimizer("adamw", 3e-4)
    _, _, m = step(params, opt.init(params), {"tokens": tok, "labels": lab})
    mean = sum(want_losses) / n
    assert abs(float(m["loss"]) - mean) <= 1e-6 * mean


def test_yarn_against_the_published_formulas():
    full = configs.get_config("deepseek-v2-lite")
    # the published dims: rope 64, base 1e4, original length 4096
    low = math.floor(64 * math.log(4096 / (32 * 2 * math.pi))
                     / (2 * math.log(1e4)))
    high = math.ceil(64 * math.log(4096 / (1 * 2 * math.pi))
                     / (2 * math.log(1e4)))
    assert (low, high) == (10, 23)
    inv = mla.yarn_inv_freq(full)
    base = 1.0 / (1e4 ** (torch.arange(0, 64, 2, dtype=torch.float32)
                          / 64))
    assert torch.equal(inv[:low], base[:low])              # extrapolated
    assert torch.allclose(inv[high:], base[high:] / 40.0, rtol=1e-6)
    # the reference's cos / sin (cat(freqs, freqs), mscale 1) hold the
    # same frequencies
    c = dict(_c(full), rope=64)
    cos, _ = ref.yarn_cos_sin(5, c, "cpu")
    ang = torch.arange(5, dtype=torch.float32)[:, None] * inv[None]
    assert torch.equal(cos, torch.cat([torch.cos(ang)] * 2, dim=-1))
    m = 0.1 * 0.707 * math.log(40) + 1.0
    assert mla.softmax_scale(full) == pytest.approx(192 ** -0.5 * m * m,
                                                    rel=1e-15)
    assert mla.softmax_scale(full) == ref.softmax_scale(c)
    assert mla.yarn_mscale(40, 0.707) == m


def _moe_params(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return moe.init_grouped_moe(gen, cfg, torch.float32)


def _ref_moe(p, x, cfg):
    """The reference's expert layer (its layer axis given length 1)."""
    stacked = {k: ({kk: vv[None] for kk, vv in v.items()}
                   if isinstance(v, dict) else v[None])
               for k, v in p.items()}
    return ref._moe(stacked, 0, x, _c(cfg))


def test_dropless_routing_under_a_forced_imbalance():
    """Held expert 0 (expert 4) is in every token's top-k, held expert 1
    (expert 5) in none: the grouped layer drops no pair and counts every
    row, against the reference's per-expert products."""
    cfg = CFG
    p = _moe_params(cfg, 5)
    t = 40
    x = torch.randn(1, t, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    x[..., 0] = x[..., 0].abs() + 1.0
    p["router"][0, cfg.moe_held_start] = 50.0
    p["router"][0, cfg.moe_held_start + 1] = -50.0
    gg.reset_expert_rows()
    out, _ = moe.grouped_moe_ffn(p, x, cfg, layer=2)
    _close(out[0], _ref_moe(p, x[0], cfg), 1e-5)
    rows = gg.expert_rows()[2, :cfg.held_experts]
    _, _, idx = moe.grouped_route(p["router"], x[0], cfg)
    local = idx - cfg.moe_held_start
    want = torch.stack([(local == e).sum() for e in range(
        cfg.held_experts)])
    assert int(rows[0]) == t and int(rows[1]) == 0
    assert torch.equal(rows, want)
    gg.reset_expert_rows()


def test_grouped_gemm_oracle_vmap_and_gradient():
    """Groups of 5, 0 (empty), 9 and 3 rows, 4 rows past the last group:
    the oracle against ``torch.mm`` per group, the custom op's ``vmap``
    rule against a loop over workers, and the gradients of ``x`` and
    ``w`` against autograd through the per-group products."""
    gen = torch.Generator().manual_seed(7)
    k, n, groups = 12, 8, 4
    sizes = [5, 0, 9, 3]
    m = sum(sizes) + 4
    offs = torch.tensor([0] + list(torch.cumsum(torch.tensor(sizes), 0)))
    x = torch.randn(3, m, k, generator=gen, dtype=torch.float64)
    w = torch.randn(groups, k, n, generator=gen, dtype=torch.float64)

    def loop(xb, wb):
        out = torch.zeros(m, n, dtype=xb.dtype)
        for j in range(groups):
            s, e = int(offs[j]), int(offs[j + 1])
            if e > s:
                out[s:e] = torch.mm(xb[s:e], wb[j])
        return out

    for b in range(3):
        assert torch.equal(gg.grouped_mm_plain(x[b], w, offs[:-1],
                                               offs[1:]), loop(x[b], w))
    got = torch.func.vmap(lambda xb: gg.grouped_mm(xb, w, offs))(x)
    assert torch.equal(got, torch.stack([loop(x[b], w) for b in range(3)]))

    def loss(fn, xb, wb):
        y = fn(xb, wb)
        return (y * y).sum() + y.sum()

    gx, gw = torch.func.vmap(torch.func.grad(
        lambda xb, wb: loss(lambda a, c: gg.grouped_mm(a, c, offs), xb, wb),
        argnums=(0, 1)), in_dims=(0, None))(x, w)
    for b in range(3):
        rx, rw = torch.func.grad(lambda xb, wb: loss(loop, xb, wb),
                                 argnums=(0, 1))(x[b], w)
        assert torch.allclose(gx[b], rx, rtol=1e-12, atol=1e-12)
        assert torch.allclose(gw[b], rw, rtol=1e-12, atol=1e-12)
    assert torch.all(gw[:, 1] == 0)                         # empty group


def test_held_shares_sum_to_the_uncut_layer():
    """Four shares of 4 experts each hold all 16: their routed parts
    plus the shared FFN once equal the uncut layer (every expert held)
    of the reference."""
    cfg = dataclasses.replace(CFG, moe_held_start=0, moe_held=16)
    p = _moe_params(cfg, 8)
    x = torch.randn(1, 30, cfg.d_model,
                    generator=torch.Generator().manual_seed(9))
    shared = moe.layers.ffn(p["shared"], x, cfg.ffn_act)
    total = -3 * shared
    for r in range(4):
        share = dataclasses.replace(cfg, moe_held_start=4 * r, moe_held=4)
        sp = dict(p, experts={key: v[4 * r:4 * r + 4]
                              for key, v in p["experts"].items()})
        out, _ = moe.grouped_moe_ffn(sp, x, share)
        total = total + out
    uncut = _ref_moe(p, x[0], cfg)
    _close(total[0], uncut, 1e-5)
    out, _ = moe.grouped_moe_ffn(p, x, cfg)
    _close(out[0], uncut, 1e-5)


def test_renormalized_gates_and_the_balance_loss():
    """The routing's other published settings: top-k gates renormalized
    (``norm_topk_prob``) against the reference, and the sequence-wise
    balance loss against DeepSeek's formula (per sequence, each expert's
    share of the top-k picks over ``k / E`` times its mean score, summed
    over experts, the mean over sequences, times the weight)."""
    cfg = dataclasses.replace(CFG, moe_norm_topk=True, moe_seq_aux=0.001)
    p = _moe_params(cfg, 10)
    x = torch.randn(2, 20, cfg.d_model,
                    generator=torch.Generator().manual_seed(11))
    out, aux = moe.grouped_moe_ffn(p, x, cfg)
    for b in range(2):
        _close(out[b], _ref_moe(p, x[b], cfg), 1e-5)
    e, k = cfg.moe_experts, cfg.moe_top_k
    want = 0.0
    for b in range(2):
        scores = torch.softmax(x[b] @ p["router"], dim=-1)
        idx = torch.topk(scores, k, dim=-1).indices
        picks = torch.bincount(idx.reshape(-1), minlength=e).float()
        want += float((picks / (20 * k / e) * scores.mean(0)).sum()) / 2
    assert float(aux) == pytest.approx(0.001 * want, rel=1e-6)


def test_registry_and_refusals():
    assert configs.ALIASES["deepseek-v2-lite"] == "deepseek_v2_lite"
    assert "deepseek_v2_lite" not in configs.ARCH_IDS
    full = configs.get_config("deepseek-v2-lite")
    assert full.param_count() == 15_706_484_224
    cut = dataclasses.replace(full, n_layers=5, moe_held=8,
                              vocab_size=12800)
    assert cut.param_count() == 535_060_992
    assert sum(x.numel() for x in tree_leaves(
        init_model(0, cut, device="meta"))) == 535_060_992
    params = init_model(0, CFG, device="cpu")
    from repro_torch.models import init_cache, prefill
    from repro_torch.serving import ServingEngine
    for call in (lambda: init_cache(CFG, 2, 16, device="cpu"),
                 lambda: prefill(params, CFG, _tokens(0, (1, 8))),
                 lambda: ServingEngine(params, CFG, n_slots=2,
                                       cache_len=16)):
        with pytest.raises(NotImplementedError,
                           match="latent KV cache and absorbed decode"):
            call()
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        make_train_step(CFG, DistByzantineSpec(f=0, gar="average"),
                        get_optimizer("adamw", 3e-4), mesh=object())


def test_spans_and_outputs_on_and_off():
    params = init_model(3, CFG, device="cpu")
    tok = _tokens(0, (1, 16))
    off, _ = forward(params, CFG, tok)
    with SpanRecorder() as rec:
        on, _ = forward(params, CFG, tok)
    assert torch.equal(off, on)
    names = [r["name"] for r in rec.rows]
    assert names.count("model/mla") == CFG.n_layers
    for name in ("moe/route", "moe/experts", "moe/shared"):
        assert names.count(name) == CFG.n_layers - CFG.n_dense_lead
