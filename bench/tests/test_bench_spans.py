"""``bench/spans.py`` on a small hand-written Chrome trace: kernels and
copies tied to their launches by ``correlation``, synchronizing runtime
calls, ``baseTimeNanoseconds``, and a recorder's rows on that clock.
Beside it, ``bench.trace.Trace`` reads the same file as it always has,
and ``bench/span_report.py`` runs on the tiny cells on the CPU."""
from __future__ import annotations

import json

import pytest

from bench import spans
from bench.trace import Trace

BASE = 1_700_000_000_000_000_000


def _row(name, a, b, parent=None, **attrs):
    r = {"name": name, "start_ns": BASE + a * 1000, "end_ns": BASE + b * 1000,
         "parent": parent}
    if attrs:
        r["attrs"] = attrs
    return r


def _trace(ops, calls):
    """``ops``: (name, cat, start, end, launch ts or None); ``calls``:
    (runtime call, ts), all in µs from ``BASE``."""
    ev = []
    for k, (name, cat, a, b, at) in enumerate(ops):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": a,
                   "dur": b - a, "args": {"correlation": 100 + k}})
        if at is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": at, "dur": 2,
                       "args": {"correlation": 100 + k}})
    for name, ts in calls:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
                   "dur": 3, "args": {"correlation": 900 + len(ev)}})
    return {"traceEvents": ev, "baseTimeNanoseconds": BASE}


TRAIN_ROWS = [_row("train/step", 100, 1000, workers=7),
              _row("train/grad", 110, 400, 0),
              _row("train/attack", 401, 500, 0),
              _row("train/aggregate", 501, 700, 0),
              _row("agg/gram", 510, 600, 3),
              _row("train/opt", 701, 900, 0)]
TRAIN_OPS = [("sgemm", "kernel", 130, 330, 120),
             ("elementwise", "kernel", 330, 380, 200),
             ("reduce_kernel", "kernel", 450, 520, 450),
             ("void repro_torch::gram_kernel<float>(float*)", "kernel",
              560, 600, 550),
             ("combine_bulyan_kernel", "kernel", 600, 640, 650),
             ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 750, 760,
              750),
             ("before", "kernel", 50, 90, 40),
             ("Memset (Device)", "gpu_memset", 1100, 1110, 1090),
             ("unlaunched", "kernel", 1300, 1310, None)]
TRAIN_CALLS = [("cudaStreamSynchronize", 460), ("cudaMemcpy", 760),
               ("cudaMemcpyAsync", 755), ("cudaDeviceSynchronize", 928),
               ("cudaStreamSynchronize", 1200)]


def _spans(rows=TRAIN_ROWS, ops=TRAIN_OPS, calls=TRAIN_CALLS):
    return spans.Spans(_trace(ops, calls), rows)


def test_each_operation_lies_under_one_innermost_span_or_outside():
    sp = _spans()
    held = [None if row is None else sp.names[row][0]
            for _, _, _, row in sp.ops]
    assert held == ["train/grad", "train/grad", "train/attack", "agg/gram",
                    "train/aggregate", "train/opt", None, None, None]
    by = sp.by_span()
    assert by == pytest.approx({"train/grad": 250e-6, "train/attack": 70e-6,
                                "agg/gram": 40e-6,
                                "train/aggregate": 40e-6,
                                "train/opt": 10e-6, spans.OUTSIDE: 60e-6})
    assert sum(by.values()) == pytest.approx(
        sum(b - a for _, _, a, b, _ in TRAIN_OPS) * 1e-6)
    assert sp.names[4] == ("agg/gram", "train/aggregate", "train/step")


def test_train_numbers():
    got = spans.numbers(_spans(), traced_s=0.002)
    assert got == pytest.approx({
        "grad_ms.train": 0.25, "attack_ms.train": 0.07,
        "aggregate_ms.train": 0.08, "opt_ms.train": 0.01,
        # the attack's stream sync and the optimizer's blocking copy; not
        # the async copy, the device-wide sync or the one outside
        "host_syncs.train": 2.0,
        # 900 µs inside the step, 410 of them busy, over 2 ms traced
        "program_idle.train": 24.5,
        "covered.train": 100.0})


def test_idle_gaps_carry_the_span_before_the_trace_label(tmp_path):
    """The labels of ``Trace.breakdown`` follow the span prefix
    unchanged; ``Trace`` reads the file as it did."""
    data = _trace(TRAIN_OPS, TRAIN_CALLS)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(data))
    tr = Trace(str(path))
    assert tr.busy_s == pytest.approx(470e-6)
    assert tr.span_s == {}
    assert tr.by_kernel["repro_torch::gram_kernel"] == pytest.approx(40e-6)
    mine = spans.Spans(data, TRAIN_ROWS).idle_gaps()
    assert [s for _, s in mine] == pytest.approx([s for s, _ in tr.gaps])
    prefixes = ["train/step", spans.OUTSIDE, "train/aggregate",
                "train/attack", "train/grad", "agg/gram"]
    assert len(mine) == len(tr.gaps) == len(prefixes)
    assert [label for label, _ in mine] == [
        f"{p}: {doing}" for p, (_, doing) in zip(prefixes, tr.gaps)]
    assert mine[0][0] == ("train/step: host cudaDeviceSynchronize, then "
                          "Memset")


SERVE_ROWS = [_row("serve/step", 0, 1000, active=2, admitted=1),
              _row("serve/admit", 10, 500, 0, rid=4, prompt_len=9, slot=1),
              _row("serve/prefill", 20, 300, 1, rid=4),
              _row("model/cache", 100, 150, 2),
              _row("serve/splice", 310, 450, 1, rid=4),
              _row("serve/decode", 510, 800, 0),
              _row("model/cache", 520, 560, 5),
              _row("model/cache", 570, 600, 5),
              _row("serve/aggregate", 610, 700, 5),
              _row("serve/sample", 810, 990, 0),
              _row("serve/step", 1000, 1400, active=2, admitted=0),
              _row("serve/decode", 1010, 1200, 10),
              _row("model/cache", 1020, 1060, 11),
              _row("serve/sample", 1210, 1390, 10)]
SERVE_OPS = [("prefill_gemm", "kernel", 30, 230, 25),
             ("cache_in_prefill", "kernel", 230, 250, 120),
             ("splice_clone", "kernel", 320, 420, 315),
             ("write_k", "kernel", 525, 545, 525),
             ("write_v", "kernel", 575, 585, 575),
             ("gram_kernel", "kernel", 620, 640, 620),
             ("argmax", "kernel", 820, 825, 815),
             ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 830, 831,
              826),
             ("write_k", "kernel", 1030, 1070, 1030),
             ("argmax", "kernel", 1220, 1225, 1215),
             ("tokens", "gpu_memcpy", 1001, 1002, 1001)]
SERVE_CALLS = [("cudaStreamSynchronize", 827), ("cudaStreamSynchronize", 1230),
               ("cudaStreamSynchronize", 1500)]


def test_serve_numbers():
    sp = _spans(SERVE_ROWS, SERVE_OPS, SERVE_CALLS)
    got = spans.numbers(sp, traced_s=0.004)
    busy = sum(b - a for a, b in sp.busy)
    assert got["cache_ms.serve"] == pytest.approx((20 + 10 + 40) / 2 * 1e-3)
    assert got["splice_ms.serve"] == pytest.approx(0.1)
    assert got["host_syncs.serve"] == pytest.approx(1.0)
    assert got["program_idle.serve"] == pytest.approx(
        100.0 * (1400 - busy) * 1e-6 / 0.004)
    inside = 200 + 20 + 100 + 20 + 10 + 20 + 5 + 1 + 40 + 5 + 1
    assert got["covered.serve"] == pytest.approx(100.0 * (inside - 1)
                                                 / inside)
    rows = sp.per_row("serve/step")
    assert rows[0]["launched_ms"] == pytest.approx(0.376)
    assert rows[0]["serve/admit_ms"] == pytest.approx(0.32)
    assert rows[1]["serve/decode_ms"] == pytest.approx(0.04)


def test_no_rows_no_numbers():
    sp = spans.Spans(_trace(TRAIN_OPS, TRAIN_CALLS), [])
    assert spans.numbers(sp, 0.002) == {}
    assert sp.by_span() == pytest.approx({spans.OUTSIDE: 470e-6})


def test_rows_of_concurrent_threads_are_refused():
    """Spans that two threads hold at once do not nest, so no innermost
    row can be named for their operations: ``Spans`` refuses the rows
    rather than put them under the wrong span."""
    import threading
    from repro_torch.obs.trace import SpanRecorder, named_span
    opened, done = threading.Event(), threading.Event()

    def other():
        with named_span("serve/decode"):
            opened.set()
            done.wait(10)

    with SpanRecorder() as rec:
        worker = threading.Thread(target=other)
        worker.start()
        assert opened.wait(10)
        with named_span("serve/sample"):
            pass
        done.set()
        worker.join()
    assert [r["parent"] for r in rec.rows] == [None, None]
    data = {"traceEvents": [], "baseTimeNanoseconds": BASE}
    with pytest.raises(ValueError, match="concurrent threads"):
        spans.Spans(data, rec.rows)
    with pytest.raises(ValueError, match="concurrent threads"):
        spans.Spans(data, [_row("serve/decode", 0, 100),
                           _row("serve/sample", 50, 150)])


def test_clock_gaps_against_the_profilers_own_events():
    rows = [_row("agg/gram", 10, 20), _row("agg/select", 30, 50),
            _row("agg/gram", 60, 70)]
    data = {"baseTimeNanoseconds": BASE, "traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "agg/gram",
         "ts": 9.996, "dur": 10.0},
        {"ph": "X", "cat": "user_annotation", "name": "agg/gram",
         "ts": 59.99, "dur": 10.02},
        {"ph": "X", "cat": "user_annotation", "name": "agg/select",
         "ts": 29.98, "dur": 20.0}]}
    got = spans.clock_gaps(data, rows)
    assert got["pairs"] == 3
    assert got["start_us_max"] == pytest.approx(0.02)
    assert got["end_us_median"] == pytest.approx(0.01)
    with pytest.raises(ValueError, match="agg/gram"):
        spans.clock_gaps(data, rows + [_row("agg/gram", 80, 90)])


@pytest.mark.parametrize("cell", ["tiny.qwen1.5-4b-l4.train-long",
                                  "tiny.qwen1.5-4b-l4.serve-chat"])
def test_span_report_runs_a_tiny_cell(tiny, cell, capsys):
    from bench import span_report
    assert span_report.main(["--workload", cell, "--seed", str(2 ** 31 + 9),
                             "--device", "cpu", "--cost", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    assert len(out["cost"]["step_s"]["on"]) == 2
    assert out["span_cost"]["span_us_on"] > 0
    kind = "train" if "train" in cell else "serve"
    assert f"host_syncs.{kind}" in out["device_only"]["numbers"]
    assert out["device_only"]["rows"] > 0
    if kind == "train":
        assert out["clock"]["pairs"] > 0
