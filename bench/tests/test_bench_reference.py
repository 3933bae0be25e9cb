"""The plain references against the program at a reduced size: the
forward's logits, one train step's numbers, and prefill + decode through
the program's cache against the reference's full forward."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import (ROOT, TINY_DENSE, TINY_DENSE_PORT, TINY_MAMBA,
                      TINY_MAMBA_PORT, TINY_TRAIN_LIMITS)
from bench import harness, weights
from bench.kinds.train import layout_of

CASES = {"dense": ("qwen1.5-4b-l4", TINY_DENSE, TINY_DENSE_PORT),
         "mamba": ("mamba2-130m", TINY_MAMBA, TINY_MAMBA_PORT)}


class _Cell:
    def __init__(self, kind):
        base, sizes, port = CASES[kind]
        self.config = json.loads((ROOT / "bench" / "configs"
                                  / f"{base}.json").read_text())
        self.config.update(sizes)
        self.config["port"].update(port)
        self.model = harness.load_module(
            ROOT / "bench" / "configs" / f"{base}.py",
            f"ref_test_{kind}")
        from repro_torch.models.config import ModelConfig
        p = dict(self.config["port"],
                 layer_pattern=tuple(self.config["port"]["layer_pattern"]))
        self.mcfg = ModelConfig(**p)
        self.layout = layout_of(self.mcfg)

    def tree(self, seed=3):
        return weights.draw_tree(self.layout, self.model.init_rule, seed,
                                 "cpu")


@pytest.mark.parametrize("kind", sorted(CASES))
def test_forward_logits_agree(kind):
    from repro_torch.models import forward
    torch.set_num_threads(2)
    c = _Cell(kind)
    tree = c.tree()
    tokens = torch.randint(0, c.mcfg.vocab_size, (1, 40))
    want = c.model.reference_logits(tree, tokens[0], c.config)
    got = forward(tree, c.mcfg, tokens, impl="naive")[0][0]
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 2e-5, err


@pytest.mark.parametrize("kind", sorted(CASES))
def test_one_train_step_agrees(tiny, kind):
    """The program's first steps against the reference's on one seed:
    every number far below the tiny limits the fault tests use."""
    name = [w["name"] for w in tiny.man["workloads"]
            if w["name"].startswith("tiny.")
            and w["config"] == f"tiny-{kind}"
            and "wide" not in w["traffic"] and "chat" not in w["traffic"]][0]
    cell = harness.Cell(name, 12345, 0.0, False, "cpu")
    got = cell.kind.readings(cell, faults=False)["program"]
    for key, lim in TINY_TRAIN_LIMITS.items():
        assert got[key] < lim / 3, (key, got[key])


def test_prefill_and_decode_through_the_cache_agree():
    """``models.prefill`` then ``decode_step`` on the program's cache
    against the reference's full forward over the same tokens."""
    from repro_torch.models import decode_step, prefill
    torch.set_num_threads(2)
    c = _Cell("dense")
    tree = c.tree()
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, c.mcfg.vocab_size, 11))[None]
    logits, cache = prefill(tree, c.mcfg, prompt, cache_len=32)
    seq = [int(t) for t in prompt[0]]
    rows = [logits[0, -1]]
    for _ in range(8):
        tok = int(torch.argmax(rows[-1]))
        out, cache = decode_step(tree, c.mcfg, cache,
                                 torch.tensor([[tok]]),
                                 np.array([len(seq)], np.int32))
        seq.append(tok)
        rows.append(out[0, 0])
    want = c.model.reference_logits(tree, torch.tensor(seq), c.config)
    got = torch.stack(rows)
    ref = want[len(prompt[0]) - 1:]
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < 2e-5, err
