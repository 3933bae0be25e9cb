"""The program's spans over a cell's profiled steps, from the root of a
checkout:

    python3 -m bench.span_report --workload <cell> --seed <n>
        [--cost N] [--out path.json]

Sets the cell up as ``bench/kinds/<kind>.py`` does, then:

1. the recorder's cost: N steps recording off and N on, in turns (off,
   on, on, off, ...), each timed on the host's clock and ended by a
   synchronize, and the cost of one span off and on in a tight loop;
2. the mix's ``trace_steps`` steps profiled with device activity only,
   as ``bench/run.py --trace 1`` profiles them, while a ``SpanRecorder``
   records: ``bench.spans.numbers``, the device time by
   innermost span, the longest idle gaps under their spans, and each
   step's host time against its device time;
3. for a train cell, one step more profiled with the host's operators: the recorder's rows (``agg/*`` and all) against their
   ``record_function`` events (``bench.spans.clock_gaps``).

Prints one JSON object, and writes it to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, List

from bench import spans as bench_spans
from bench.harness import Cell, power_limit


def _sync(dev: str) -> None:
    if dev == "cuda":
        import torch
        torch.cuda.synchronize()


def _turns(n: int) -> List[bool]:
    """off, on, on, off, ... (``True`` is on), n of each."""
    out: List[bool] = []
    while len(out) < 2 * n:
        out += [False, True] if len(out) % 4 == 0 else [True, False]
    return out[:2 * n]


def span_cost(reps: int = 20000) -> Dict[str, float]:
    """Host µs of one empty ``named_span`` block, recording off and on."""
    from repro_torch.obs.trace import SpanRecorder, named_span
    out = {}
    for mode in ("off", "on", "off_again"):
        rec = SpanRecorder(capacity=reps) if mode == "on" else None
        if rec:
            rec.start()
        t0 = time.perf_counter()
        for _ in range(reps):
            with named_span("x"):
                pass
        out[f"span_us_{mode}"] = (time.perf_counter() - t0) / reps * 1e6
        if rec:
            rec.stop()
    return out


def cost(run_one: Callable[[], None], dev: str, n: int) -> Dict:
    """Host seconds of ``run_one`` recording off and on, in turns; rows
    per step and each on-step's host ms per top-level phase."""
    from repro_torch.obs.trace import SpanRecorder
    times: Dict[str, List[float]] = {"off": [], "on": []}
    turns, rows, phases = [], [], []
    for on in _turns(n):
        rec = SpanRecorder()
        _sync(dev)
        t0 = time.perf_counter()
        if on:
            rec.start()
        run_one()
        _sync(dev)
        if on:
            rec.stop()
        turns.append((on, time.perf_counter() - t0))
        times["on" if on else "off"].append(turns[-1][1])
        if on:
            rows.append(len(rec.rows))
            top = [k for k, r in enumerate(rec.rows) if r["parent"] is None]
            step = {}
            for r in rec.rows:
                if r["parent"] in top and r["end_ns"] is not None:
                    key = r["name"] + "_host_ms"
                    step[key] = step.get(key, 0.0) + (
                        r["end_ns"] - r["start_ns"]) * 1e-6
            phases.append(step)
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"step_s": times, "turns": turns, "median_s": med,
            "on_over_off": med["on"] / med["off"] - 1.0,
            "rows_per_step": rows, "host_ms_by_phase": phases}


def profiled(run_one: Callable[[], None], dev: str, steps: int,
             host: bool):
    """``steps`` calls of ``run_one`` under ``torch.profiler`` (device
    activity only unless ``host``) with a ``SpanRecorder`` on, as
    ``bench.trace.Profiled`` times them: ``(trace, rows, seconds)``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import SpanRecorder
    cuda = dev == "cuda"
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    rec = SpanRecorder()
    _sync(dev)
    prof = profile(activities=acts)
    prof.__enter__()
    t0 = time.perf_counter()
    rec.start()
    for _ in range(steps):
        run_one()
        _sync(dev)
    rec.stop()
    prof.__exit__(None, None, None)
    seconds = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.remove(path)
    return trace, rec.rows, seconds


def _kernels_by_span(sp, top: int = 6) -> Dict[str, list]:
    """The ``top`` operations by device ms under each innermost span."""
    got: Dict[str, Dict[str, float]] = {}
    for a, b, name, row in sp.ops:
        span = bench_spans.OUTSIDE if row is None else sp.names[row][0]
        got.setdefault(span, {})
        got[span][name] = got[span].get(name, 0.0) + (b - a) * 1e-3
    return {span: sorted(([k, v] for k, v in ops.items()),
                         key=lambda kv: -kv[1])[:top]
            for span, ops in got.items()}


def read(trace, rows, seconds: float, step_name: str) -> Dict:
    sp = bench_spans.Spans(trace, rows)
    by = sp.by_span()
    return {"traced_s": seconds, "rows": len(rows),
            "device_s": sum(by.values()), "busy_s": sum(
                b - a for a, b in sp.busy) * 1e-6,
            "numbers": bench_spans.numbers(sp, seconds),
            "device_s_by_innermost_span": dict(
                sorted(by.items(), key=lambda kv: -kv[1])),
            "syncs": [[name, sp.names[row][0] if row is not None
                       else bench_spans.OUTSIDE]
                      for _, name, row in sp.syncs],
            "idle_gaps": sp.idle_gaps(),
            "ops_ms_by_span": _kernels_by_span(sp),
            "steps": sp.per_row(step_name)}


def train(cell: Cell, n_cost: int) -> Dict:
    from bench.kinds import train as kind
    from repro_torch.kernels import _build
    dev = cell.device
    if dev == "cuda":
        _build.build_all()
    mcfg, layout, batches = kind.setup(cell)
    params, state, step, opt, _ = kind.first_steps(cell, mcfg, layout,
                                                   batches)
    k = [0]

    def run_one():
        nonlocal params, state
        params, state, _ = step(params, state, batches[
            (kind.CHECKED + k[0]) % len(batches)])
        k[0] += 1

    out = {"cost": cost(run_one, dev, n_cost)}
    trace, rows, seconds = profiled(run_one, dev,
                                    cell.traffic["trace_steps"], host=False)
    out["device_only"] = read(trace, rows, seconds, "train/step")
    trace, rows, _ = profiled(run_one, dev, 1, host=True)
    out["clock"] = bench_spans.clock_gaps(trace, rows)
    out["clock_all_spans"] = bench_spans.clock_gaps(trace, rows, "")
    return out


def serve(cell: Cell, n_cost: int) -> Dict:
    from bench import weights
    from bench.kinds import serve as kind
    from bench.kinds.train import layout_of, model_config
    from bench.traffic import request_pool
    from repro_torch.kernels import _build
    tr, dev = cell.traffic, cell.device
    if dev == "cuda":
        _build.build_all()
    mcfg = model_config(cell)
    stacked = weights.draw_ensemble(layout_of(mcfg), cell.model.init_rule,
                                    cell.seed, dev, tr["jitters"],
                                    tr["poison_scale"])
    engine = kind.build_program(cell, mcfg, stacked)
    del stacked
    loop = kind.Loop(engine, request_pool(tr, mcfg.vocab_size, cell.seed))
    for _ in range(tr["warmup_steps"]):
        loop.step()
    admitted = []

    def run_one():
        before = len(loop.times)
        loop.step()
        admitted.append(len(loop.times) - before)

    out = {"cost": cost(run_one, dev, n_cost)}
    # the decode steps alone: an admission's prefill dwarfs the recorder
    plain = {"off": [], "on": []}
    for (on, s), a in zip(out["cost"]["turns"], admitted):
        if not a:
            plain["on" if on else "off"].append(s)
    out["cost"]["decode_only_median_s"] = {
        k: statistics.median(v) for k, v in plain.items() if v}
    trace, rows, seconds = profiled(run_one, dev, tr["trace_steps"],
                                    host=False)
    out["device_only"] = read(trace, rows, seconds, "serve/step")
    return out


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", type=int, default=8,
                    help="steps recording off, and as many on")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cuda":
        torch.set_num_threads(2)
    cell = Cell(args.workload, args.seed, 0.0, True, args.device)
    run = {"train": train, "serve": serve}[cell.traffic["kind"]]
    out = {"workload": args.workload, "seed": args.seed,
           "device": (torch.cuda.get_device_name(0)
                      if args.device == "cuda" else args.device),
           "power": power_limit() if args.device == "cuda" else "no card",
           "span_cost": span_cost()}
    out.update(run(cell, args.cost))
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    # the harness's environment (caches inside the checkout, two intra-op
    # threads, ``src`` on the path), set before torch is imported
    import bench.run  # noqa: F401
    sys.exit(main())
