"""The check against a broken timed path: the harness runs a tiny cell on
the CPU (its look for a card skipped) with the program broken
underneath, and ``correct`` comes out false, once for each fault the
cell can have; the same cell unbroken comes out true.  And the control,
the reference in TF32 put in the program's place, fails the limits that
sound runs pass."""
from __future__ import annotations

import pytest
import torch

from conftest import TINY_SERVE_LIMITS, TINY_TRAIN_LIMITS
from bench import harness


def _cells(tiny, kind):
    out = []
    for w in tiny.man["workloads"]:
        if not w["name"].startswith("tiny."):
            continue
        tr = harness.json.loads((tiny.root / "bench" / "traffic"
                                 / f"{w['traffic']}.json").read_text())
        if tr["kind"] == kind:
            out.append(w["name"])
    return out


# -- training: a state left unchanged, half the batch, an altered answer --

def _frozen(step):
    def broken(params, state, batch):
        _, _, m = step(params, state, batch)
        return params, state, m
    return broken


def _train_faults():
    from bench.kinds import train
    return {"frozen_state": _frozen, "half_batch": train.half_batch,
            "altered_answer": train.altered_answer}


def _patch_train(monkeypatch, fault):
    import repro_torch.dist.train as dt
    make = dt.make_train_step

    def broken_make(*a, **kw):
        return fault(make(*a, **kw))
    monkeypatch.setattr(dt, "make_train_step", broken_make)


@pytest.mark.parametrize("fault", ["none", "frozen_state", "half_batch",
                                   "altered_answer"])
def test_train_cells_catch_each_fault(tiny, capsys, monkeypatch, fault):
    if fault != "none":
        _patch_train(monkeypatch, _train_faults()[fault])
    for name in _cells(tiny, "train"):
        rc, res = tiny.run(name, capsys)
        assert rc == 0
        assert res["correct"] is (fault == "none"), (name, res["checks"])


def test_train_control_fails_the_limits(tiny):
    """Each tiny train cell's control reads above a limit that its
    program passes."""
    for name in _cells(tiny, "train"):
        cell = harness.Cell(name, 777, 0.0, False, "cpu")
        r = cell.kind.readings(cell, faults=False)
        ok_prog, _ = harness.check(r["program"], TINY_TRAIN_LIMITS)
        ok_ctl, _ = harness.check(r["control"], TINY_TRAIN_LIMITS)
        assert ok_prog and not ok_ctl, (name, r)


# -- serving: a stale cache, half the slots, an altered token -------------

def _engine_fault(kind):
    from repro_torch.serving import ServingEngine

    class Broken(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            decode = self._decode

            def stale(params, cache, tokens, pos, state=None):
                out = decode(params, cache, tokens, pos, state)
                return (out[0], cache) + tuple(out[2:])

            def half(params, cache, tokens, pos, state=None):
                out = decode(params, cache, tokens, pos, state)
                agg = out[0].clone()
                b = agg.shape[0] // 2
                agg[b:2 * b] = agg[:b]
                return (agg,) + tuple(out[1:])
            if kind == "stale_cache":
                self._decode = stale
            elif kind == "half_batch":
                self._decode = half

        def step(self):
            super().step()
            if kind != "altered_token":
                return
            # each request's second token, as it is produced
            for req in self.active:
                if req is not None and len(req.generated) == 2:
                    req.generated[-1] = ((req.generated[-1] + 1)
                                         % self.cfg.vocab_size)
    return Broken


@pytest.mark.parametrize("fault", ["none", "stale_cache", "half_batch",
                                   "altered_token"])
def test_serve_cells_catch_each_fault(tiny, capsys, monkeypatch, fault):
    import repro_torch.serving as sv
    if fault != "none":
        monkeypatch.setattr(sv, "ServingEngine", _engine_fault(fault))
    for name in _cells(tiny, "serve"):
        rc, res = tiny.run(name, capsys, seconds=2.0)
        assert rc == 0
        assert res["correct"] is (fault == "none"), (name, res["checks"])


def test_serve_control_fails_the_limits(tiny, monkeypatch):
    """TF32 moves a tiny model's logits by about 5e-4 of their spread, so
    it flips the greedy token only at near-ties, which a few thousand
    tokens of a random model rarely hold.  Here every odd row of the
    output table is its even neighbour plus 1e-3 of its spread in noise,
    so every position holds a near-tie that float32 resolves and TF32
    does not; program and reference read the same tree."""
    from bench import weights
    draw = weights.draw_ensemble

    def paired(*a, **kw):
        tree = draw(*a, **kw)
        t = tree["embed"]["table"]
        half = t.shape[1] // 2
        gen = torch.Generator().manual_seed(5)
        noise = torch.randn(t[:, 1:2 * half:2].shape, generator=gen)
        t[:, 1:2 * half:2] = t[:, 0:2 * half:2] * (1 + 1e-3 * noise)
        return tree
    monkeypatch.setattr(weights, "draw_ensemble", paired)
    for name in _cells(tiny, "serve"):
        cell = harness.Cell(name, 779, 0.0, False, "cpu")
        r = cell.kind.readings(cell)
        ok_prog, _ = harness.check(r["program"], TINY_SERVE_LIMITS)
        ok_ctl, _ = harness.check(r["control"], TINY_SERVE_LIMITS)
        assert ok_prog and not ok_ctl, (name, r)
