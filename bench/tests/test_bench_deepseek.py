"""The ``deepseek-v2-lite-l5`` files (its configuration, reference, work
formulas, the ``train_moe`` driver, its limits and the three metrics'
readers) at a tiny size on the CPU, through the harness: a sound run is
correct and reports the row counter's metric; each training fault (half
the batch, an altered answer) comes out incorrect; the control, the
reference in TF32, fails the limits that the program passes; the formula
of the forward and backward FLOPs against ``FlopCounterMode``.  (That
the readers return nothing on nothing, ``test_bench_manifest.py`` holds
for every metric of the manifest.)

The tiny twin takes the training cell's metrics and the entries that
``BENCHMARK.json`` gives the cell ``deepseek-v2-lite-l5.train-4k``."""
from __future__ import annotations

import pytest
import torch

from conftest import TINY_TRAIN, TINY_TRAIN_LIMITS, Checkout
from bench import harness

CELL = "tiny-deepseek.train"
#: the published shapes at a small width: 16 routed experts, 4 held
#: (the first 4), top-4, one leading dense layer and two expert layers
TINY_DEEPSEEK = {"hidden_size": 64, "intermediate_size": 96,
                 "moe_intermediate_size": 32, "kv_lora_rank": 32,
                 "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                 "v_head_dim": 16, "num_attention_heads": 4,
                 "num_key_value_heads": 4, "num_hidden_layers": 3,
                 "n_routed_experts": 4, "routed_experts": 16,
                 "num_experts_per_tok": 4, "vocab_size": 97}
TINY_DEEPSEEK_PORT = {"n_layers": 3, "d_model": 64, "n_heads": 4,
                      "n_kv_heads": 4, "d_ff": 96, "vocab_size": 97,
                      "head_dim": 16, "kv_lora_rank": 32,
                      "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                      "v_head_dim": 16, "moe_experts": 16, "moe_top_k": 4,
                      "moe_d_ff": 32, "moe_held": 4}
#: the per-layer entries of the metrics only the expert cell reports: the
#: grouped GEMM's device time and roofline share, the busiest held
#: expert's rows over the held experts' mean
MOE_METRICS = [{k: v for k, v in m.items() if k != "workloads"}
               for m in harness.manifest()["per_layer"]
               if m.get("workloads") == ["deepseek-v2-lite-l5.train-4k"]]


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    co = Checkout(tmp_path, monkeypatch)
    co.add_config("tiny-deepseek", "deepseek-v2-lite-l5", TINY_DEEPSEEK,
                  TINY_DEEPSEEK_PORT)
    co.add_traffic("tiny-train-moe", "train-n7-1x4096", TINY_TRAIN)
    co.add_cell(CELL, "tiny-deepseek", "tiny-train-moe",
                limits_of="qwen1.5-4b-l4.train-long",
                limits=TINY_TRAIN_LIMITS)
    co.man["per_layer"] += [dict(m, workloads=[CELL]) for m in MOE_METRICS]
    co.write()
    return co


def test_sound_run_is_correct_and_counts_rows(tiny, capsys):
    rc, res = tiny.run(CELL, capsys, trace=1)
    assert rc == 0 and res["correct"] is True, res and res["checks"]
    got = res["metrics"]["expert_rows_max.train"]["value"]
    assert got >= 100.0
    # the CPU launches no kernel: the device-trace metrics read nothing
    assert "gmm_ms.train" not in res["metrics"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_each_fault_is_caught(tiny, capsys, monkeypatch, fault):
    import repro_torch.dist.train as dt
    from bench.kinds import train
    make = dt.make_train_step
    monkeypatch.setattr(dt, "make_train_step",
                        lambda *a, **kw: train.FAULTS[fault](make(*a, **kw)))
    rc, res = tiny.run(CELL, capsys)
    assert rc == 0 and res["correct"] is False, res["checks"]


def test_control_fails_the_limits(tiny):
    cell = harness.Cell(CELL, 777, 0.0, False, "cpu")
    r = cell.kind.readings(cell, faults=False)
    ok_prog, _ = harness.check(r["program"], TINY_TRAIN_LIMITS)
    ok_ctl, _ = harness.check(r["control"], TINY_TRAIN_LIMITS)
    assert ok_prog and not ok_ctl, r


def test_flop_formula_matches_the_counter(tiny):
    """Every expert held (16 of 16) and uniform routing forced by a
    zero router, so each token's top-4 falls on the held share exactly
    ``4 x 16 / 16`` times, as the formula assumes: the counter's whole
    square of scores against the formula's ``causal=False``.  The
    counter learns the grouped GEMM's FLOPs here, ``2 K N`` per row of
    its groups, and also counts the gates' weighted sum of each token's
    k expert outputs (a batched product, ``2 k D`` a token, forward and
    backward), which the formula leaves out as no model product."""
    import json
    from torch.utils.flop_counter import (FlopCounterMode,
                                          register_flop_formula)
    import repro_torch.kernels.grouped_gemm  # noqa: F401  (the ops)

    def rows(starts, ends):
        return int((ends - starts).sum())

    @register_flop_formula(torch.ops.repro_torch.gmm, get_raw=True)
    def _gmm(x, w, starts, ends, trans_w, count_base, *a, **kw):
        return 2 * rows(starts, ends) * x.shape[1] * (
            w.shape[1] if trans_w else w.shape[2])

    @register_flop_formula(torch.ops.repro_torch.gmm_dw, get_raw=True)
    def _gmm_dw(x, dy, starts, ends, *a, **kw):
        return 2 * rows(starts, ends) * x.shape[1] * dy.shape[1]

    from repro_torch.dist.train import make_loss_fn
    from repro_torch.models import init_model
    from repro_torch.models.config import ModelConfig
    root = tiny.root / "bench" / "configs"
    cfg = json.loads((root / "tiny-deepseek.json").read_text())
    cfg["n_routed_experts"] = 16
    mod = harness.load_module(root / "tiny-deepseek.py", "flops_deepseek")
    port = dict(cfg["port"], layer_pattern=tuple(cfg["port"]
                                                 ["layer_pattern"]),
                moe_held=16)
    mcfg = ModelConfig(**port)
    params = init_model(0, mcfg, device="cpu")
    params["periods"]["s0"]["moe"]["router"].zero_()
    tokens = torch.randint(0, mcfg.vocab_size, (2, 12))
    with FlopCounterMode(display=False) as fc:
        torch.func.grad(make_loss_fn(mcfg, impl="naive"))(params, tokens,
                                                          tokens)
    combine = 3 * 2 * (2 * 12) * mcfg.moe_top_k * mcfg.d_model * (
        mcfg.n_layers - mcfg.n_dense_lead)
    assert mod.train_flops(cfg, 2, 12, causal=False) == (
        fc.get_total_flops() - combine)


def test_window_replays_the_batches_from_the_checked_state():
    """``train_moe``'s step runs from the checked steps' parameters and
    state at its ``period``-th call and every ``period``-th after, and
    from what it is given otherwise."""
    from bench.kinds import train_moe

    def first_steps():
        return 0, "s0", lambda p, s, b: (p + 1, s + "+", b), "opt", {}

    params, state, step, opt, prog = train_moe.replaying(first_steps, 3)()
    seen = []
    for batch in range(7):
        params, state, _ = step(params, state, batch)
        seen.append(params)
    assert seen == [1, 2, 3, 1, 2, 3, 1]
    assert state == "s0+" and (opt, prog) == ("opt", {})
