"""Each configuration's FLOP formula against
``torch.utils.flop_counter.FlopCounterMode`` on the program's forward
and backward at a reduced size."""
from __future__ import annotations

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import (ROOT, TINY_DENSE, TINY_DENSE_PORT, TINY_MAMBA,
                      TINY_MAMBA_PORT)
from bench import harness


def _cfg(base, sizes, port):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{base}.json")
                     .read_text())
    cfg.update(sizes)
    cfg["port"].update(port)
    mod = harness.load_module(ROOT / "bench" / "configs" / f"{base}.py",
                              f"flops_{base.replace('.', '_')}")
    from repro_torch.models.config import ModelConfig
    p = dict(cfg["port"], layer_pattern=tuple(cfg["port"]["layer_pattern"]))
    return cfg, mod, ModelConfig(**p)


def _counted(mcfg, seqs, seq, fn=None):
    from repro_torch.dist.train import make_loss_fn
    from repro_torch.models import init_model
    params = init_model(0, mcfg, device="cpu")
    tokens = torch.randint(0, mcfg.vocab_size, (seqs, seq))
    loss_fn = make_loss_fn(mcfg, impl="naive")
    with FlopCounterMode(display=False) as fc:
        torch.func.grad(loss_fn)(params, tokens, tokens)
    return fc.get_total_flops()


def test_dense_formula_matches_the_counter():
    """The counter counts the whole square of attention scores; the
    formula's ``causal=False`` form counts the same, its default the
    lower triangle."""
    cfg, mod, mcfg = _cfg("qwen1.5-4b-l4", TINY_DENSE, TINY_DENSE_PORT)
    seqs, seq = 3, 24
    assert mod.train_flops(cfg, seqs, seq, causal=False) == _counted(
        mcfg, seqs, seq)
    assert mod.train_flops(cfg, seqs, seq) < mod.train_flops(
        cfg, seqs, seq, causal=False)


def _by_op(mcfg, seqs, seq, grad: bool):
    from repro_torch.dist.train import make_loss_fn
    from repro_torch.models import init_model
    params = init_model(0, mcfg, device="cpu")
    tokens = torch.randint(0, mcfg.vocab_size, (seqs, seq))
    loss_fn = make_loss_fn(mcfg, impl="naive")
    with FlopCounterMode(display=False) as fc:
        if grad:
            torch.func.grad(loss_fn)(params, tokens, tokens)
        else:
            loss_fn(params, tokens, tokens)
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


def test_mamba_formula_matches_the_counter():
    """The program's chunked scan does other products than the linear
    form the formula counts, all of them batched (``bmm``); the
    projections and the head are ``mm``.  So the counter's ``mm`` is the
    formula without its SSM and convolution terms (the program's
    convolution is elementwise, which the counter does not count), three
    times over with the backward.  Of the recurrent step the counter sees
    the read ``C h``, a contraction, which is half the formula's SSM term;
    the write ``B x`` into the state is an outer product and an add, the
    other half, which it does not count as a product."""
    from repro_torch.models import ssm
    cfg, mod, mcfg = _cfg("mamba2-130m", TINY_MAMBA, TINY_MAMBA_PORT)
    seqs, seq = 2, 40
    rest = (mod.forward_flops(cfg, seqs, seq)
            - seqs * seq * cfg["n_layer"] * (mod.ssm_flops(cfg)
                                             + mod.conv_flops(cfg)))
    assert _by_op(mcfg, seqs, seq, grad=False)["aten.mm"] == rest
    assert _by_op(mcfg, seqs, seq, grad=True)["aten.mm"] == 3 * rest
    assert mod.train_flops(cfg, seqs, seq) == 3 * mod.forward_flops(
        cfg, seqs, seq)

    d_in = cfg["expand"] * cfg["d_model"]
    h, n, p = d_in // cfg["headdim"], cfg["d_state"], cfg["headdim"]
    state = torch.zeros(seqs, h, n, p)
    with FlopCounterMode(display=False) as fc:
        ssm.ssd_recurrent_step(state, torch.randn(seqs, h, p),
                               torch.rand(seqs, h), -torch.rand(h),
                               torch.randn(seqs, n), torch.randn(seqs, n))
    assert 2 * fc.get_total_flops() == seqs * mod.ssm_flops(cfg)
