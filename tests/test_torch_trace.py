"""The port's span recorder (``repro_torch.obs.trace``) and the spans the
train step and the serving engine wear, on the CPU.

* off records nothing; on, nested rows with their parents, kept when a
  block raises, bounded with a count of the rows dropped, one recorder
  at a time, each thread with its own parents;
* a row's interval against its ``record_function`` event in a CPU
  profile's Chrome trace (``baseTimeNanoseconds + ts * 1000``);
* one ``make_train_step`` step and a tiny ensemble ``ServingEngine``
  (per token and speculative): the phases nest as the program's blocks
  do, and the outputs are the same recording on and off, bit for bit.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.dist.serve_robust import replicate_params  # noqa: E402
from repro_torch.dist.train import (DistByzantineSpec,  # noqa: E402
                                    make_train_step)
from repro_torch.models import init_model  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.export import read_jsonl, write_jsonl  # noqa: E402
from repro_torch.obs.trace import SpanRecorder, named_span  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

CFG = get_reduced("llama3_2_3b")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    assert trace._ACTIVE is None


def _tree(rows):
    """``(name, parent's name)`` of every row."""
    return [(r["name"], None if r["parent"] is None
             else rows[r["parent"]]["name"]) for r in rows]


def _inside(rows, k):
    """The row ``k`` lies inside its parent's interval."""
    p = rows[rows[k]["parent"]]
    r = rows[k]
    return p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]


class TestRecorder:
    def test_off_records_nothing(self):
        rec = SpanRecorder()
        with named_span("a/outer", rid=1) as span:
            with named_span("a/inner"):
                pass
            span.note(count=3)
        assert rec.rows == [] and rec.dropped == 0
        assert trace._ACTIVE is None

    def test_no_record_function_outside_a_profile(self, monkeypatch):
        def refused(name):
            raise AssertionError(f"record_function({name!r})")
        monkeypatch.setattr(torch.profiler, "record_function", refused)
        with SpanRecorder() as rec:
            with named_span("a/outer"):
                with named_span("a/inner"):
                    pass
        assert _tree(rec.rows) == [("a/outer", None),
                                   ("a/inner", "a/outer")]

    def test_nested_rows_with_parents(self, tmp_path):
        with SpanRecorder() as rec:
            with named_span("a/outer", rid=7) as span:
                with named_span("a/inner"):
                    with named_span("a/leaf"):
                        pass
                with named_span("a/second"):
                    pass
                span.note(count=2)
            with named_span("a/next"):
                pass
        assert _tree(rec.rows) == [
            ("a/outer", None), ("a/inner", "a/outer"), ("a/leaf", "a/inner"),
            ("a/second", "a/outer"), ("a/next", None)]
        assert rec.rows[0]["attrs"] == {"rid": 7, "count": 2}
        assert "attrs" not in rec.rows[1]
        for k in (1, 2, 3):
            assert _inside(rec.rows, k)
        assert rec.rows[0]["end_ns"] <= rec.rows[4]["start_ns"]
        assert rec.dropped == 0
        # written out by whoever stops the recording
        assert write_jsonl(tmp_path / "spans.jsonl", rec.rows) == 5
        assert read_jsonl(tmp_path / "spans.jsonl") == rec.rows

    def test_rows_kept_when_a_block_raises(self):
        with SpanRecorder() as rec:
            with pytest.raises(RuntimeError, match="kept"):
                with named_span("a/outer"):
                    with named_span("a/failed"):
                        raise RuntimeError("kept on exception")
            with named_span("a/after"):
                pass
        assert _tree(rec.rows) == [("a/outer", None),
                                   ("a/failed", "a/outer"),
                                   ("a/after", None)]
        assert all(r["end_ns"] >= r["start_ns"] for r in rec.rows)

    def test_bounded_with_a_drop_count(self):
        with SpanRecorder(capacity=3) as rec:
            with named_span("a/0"):
                with named_span("a/1"):
                    pass
            with named_span("a/2"):
                with named_span("a/3"):
                    with named_span("a/4"):
                        pass
            with named_span("a/5"):
                pass
        assert [r["name"] for r in rec.rows] == ["a/0", "a/1", "a/2"]
        assert rec.dropped == 3
        assert all(r["end_ns"] is not None for r in rec.rows)

    def test_one_recorder_at_a_time(self):
        first = SpanRecorder().start()
        try:
            with pytest.raises(RuntimeError, match="another"):
                SpanRecorder().start()
            with named_span("a/open"):
                rows = first.stop()
            assert rows[0]["end_ns"] is None
        finally:
            first.stop()
        with SpanRecorder() as second:
            with named_span("a/b"):
                pass
        assert [r["name"] for r in second.rows] == ["a/b"]
        assert [r["name"] for r in first.rows] == ["a/open"]

    def test_each_thread_has_its_own_parents(self):
        gate = threading.Barrier(2, timeout=30)

        def work(tag):
            with named_span(f"t/{tag}"):
                gate.wait()
                with named_span(f"t/{tag}/inner"):
                    gate.wait()

        with SpanRecorder() as rec:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in "ab"]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        got = sorted(_tree(rec.rows))
        assert got == [("t/a", None), ("t/a/inner", "t/a"), ("t/b", None),
                       ("t/b/inner", "t/b")]

    def test_rows_lie_on_the_profiler_trace_clock(self, tmp_path):
        from torch.profiler import ProfilerActivity, profile
        x = torch.randn(64, 64)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with SpanRecorder() as rec:
                for _ in range(20):
                    with named_span("clock/outer"):
                        with named_span("clock/inner"):
                            x = torch.tanh(x @ x)
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
        base = int(data["baseTimeNanoseconds"])
        for name in ("clock/outer", "clock/inner"):
            events = sorted((e["ts"], e["ts"] + e["dur"])
                            for e in data["traceEvents"]
                            if e.get("cat") == "user_annotation"
                            and e["name"] == name)
            rows = [r for r in rec.rows if r["name"] == name]
            assert len(events) == len(rows) == 20
            for (a, b), r in zip(events, rows):
                # 10 ms: a wrong clock is off by seconds or more
                assert abs(base + a * 1e3 - r["start_ns"]) < 1e7
                assert abs(base + b * 1e3 - r["end_ns"]) < 1e7


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _batch(seed=0, n=7):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, CFG.vocab_size, (n, 1, 12)).astype(np.int32)
    return {"tokens": torch.as_tensor(tok),
            "labels": torch.as_tensor(np.roll(tok, -1, axis=-1))}


def test_train_step_spans_and_outputs_on_and_off():
    spec = DistByzantineSpec(f=1, gar="bulyan-krum", attack="omniscient_linf",
                             distance_backend="fused")
    opt = get_optimizer("adamw", 1e-3)
    step = make_train_step(CFG, spec, opt)
    params = init_model(0, CFG, device="cpu")
    state = opt.init(params)
    off = step(params, state, _batch())
    with SpanRecorder() as rec:
        on = step(params, state, _batch())
    got, want = _leaves(on), _leaves(off)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)
    rows = rec.rows
    tree = _tree(rows)
    assert tree[0] == ("train/step", None)
    assert rows[0]["attrs"] == {"workers": 7}
    assert [n for n, p in tree if p == "train/step"] == [
        "train/grad", "train/attack", "train/aggregate", "train/opt"]
    aggs = [k for k, (n, _) in enumerate(tree) if n.startswith("agg/")]
    assert aggs
    for k in aggs:
        chain, p = [], rows[k]["parent"]
        while p is not None:
            chain.append(rows[p]["name"])
            p = rows[p]["parent"]
        assert chain[-2:] == ["train/aggregate", "train/step"]
    for k in range(1, len(rows)):
        assert _inside(rows, k)


def _engine(speculative_k=0):
    params = init_model(0, CFG, device="cpu")
    stacked = replicate_params(params, 5, jitter=1e-3,
                               generator=torch.Generator().manual_seed(3))
    spec = AggSpec(f=1, gar="krum", distance_backend="fused",
                   speculative_k=speculative_k)
    return ServingEngine(stacked, CFG, n_slots=2, cache_len=32,
                         ensemble=spec)


def _requests():
    rng = np.random.default_rng(1)
    return [Request(i, rng.integers(0, CFG.vocab_size, 5 + i)
                    .astype(np.int32), 4) for i in range(3)]


def _parents(rows, name):
    return {rows[r["parent"]]["name"] if r["parent"] is not None else None
            for r in rows if r["name"] == name}


def test_serving_engine_spans_and_tokens_on_and_off():
    off = _engine().run(_requests())
    with SpanRecorder() as rec:
        on = _engine().run(_requests())
    assert on == off
    rows = rec.rows
    assert _parents(rows, "serve/step") == {None}
    assert _parents(rows, "serve/admit") == {"serve/step"}
    assert _parents(rows, "serve/prefill") == {"serve/admit"}
    assert _parents(rows, "serve/splice") == {"serve/admit"}
    assert _parents(rows, "serve/decode") == {"serve/step"}
    assert _parents(rows, "serve/sample") == {"serve/step"}
    assert _parents(rows, "model/cache") == {"serve/decode"}
    assert _parents(rows, "serve/aggregate") == {"serve/decode",
                                                 "serve/prefill"}
    admits = [r for r in rows if r["name"] == "serve/admit"]
    assert sorted(r["attrs"]["rid"] for r in admits) == [0, 1, 2]
    assert {r["attrs"]["prompt_len"] for r in admits} == {5, 6, 7}
    for k, r in enumerate(rows):
        if r["name"] in ("serve/prefill", "serve/splice"):
            assert r["attrs"]["rid"] == rows[r["parent"]]["attrs"]["rid"]
    steps = [r for r in rows if r["name"] == "serve/step"]
    assert sum(r["attrs"]["admitted"] for r in steps) == 3
    assert steps[0]["attrs"] == {"active": 2, "admitted": 2}
    # per decode step: the in-place writes of k and v of each layer
    decodes = [k for k, r in enumerate(rows) if r["name"] == "serve/decode"]
    caches = [r for r in rows if r["name"] == "model/cache"
              and r["parent"] == decodes[0]]
    assert len(caches) == 2 * CFG.n_layers
    for k in range(len(rows)):
        if rows[k]["parent"] is not None:
            assert _inside(rows, k)


def test_speculative_path_spans_its_aggregation():
    off = _engine(speculative_k=3).run(_requests())
    with SpanRecorder() as rec:
        eng = _engine(speculative_k=3)
        on = eng.run(_requests())
    assert on == off
    rows = rec.rows
    assert "serve/verify" not in {r["name"] for r in rows}
    assert _parents(rows, "serve/aggregate") == {"serve/decode",
                                                 "serve/prefill"}
    decodes = [k for k, r in enumerate(rows) if r["name"] == "serve/decode"]
    # one aggregation span per verify block, around its k positions
    for k in decodes:
        inner = [r["name"] for r in rows if r["parent"] == k]
        assert inner.count("serve/aggregate") == 1
        assert "model/cache" in inner
    assert _parents(rows, "serve/sample") == {"serve/step"}
