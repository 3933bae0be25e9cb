"""A stale serving cache, as the program keeps its cache: the engine's
batched cache is one persistent buffer that every decode step writes in
place, so a stale cache is a step whose writes are undone (each leaf put
back as it was before the step).  The harness runs a tiny serving cell
on the CPU with that fault underneath, and ``correct`` comes out
false."""
from __future__ import annotations

from test_bench_faults import _cells


def _stale_engine():
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.serving import ServingEngine

    class Stale(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            decode = self._decode

            def stale(params, cache, tokens, pos, state=None):
                before = [x.clone() for x in tree_leaves(cache)]
                out = decode(params, cache, tokens, pos, state)
                for leaf, old in zip(tree_leaves(cache), before):
                    leaf.copy_(old)
                return out
            self._decode = stale
    return Stale


def test_serve_cells_catch_a_stale_in_place_cache(tiny, capsys,
                                                   monkeypatch):
    import repro_torch.serving as sv
    monkeypatch.setattr(sv, "ServingEngine", _stale_engine())
    names = _cells(tiny, "serve")
    assert names
    for name in names:
        rc, res = tiny.run(name, capsys, seconds=2.0)
        assert rc == 0
        assert res["correct"] is False, (name, res["checks"])
