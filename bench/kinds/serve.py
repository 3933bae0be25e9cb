"""Driver of the chat mixes: Byzantine-robust ensemble serving
(``repro_torch.serving.ServingEngine`` over ``dist/serve_robust.py``)
under a closed loop of clients.

Set-up builds the kernels, draws the replicas from the seed
(``bench.weights.draw_ensemble``), builds the engine and runs the closed
loop for the mix's warm-up steps.  The window then runs the same loop
until ``--seconds`` have passed: each client sends its next request as
soon as its last one has finished.  After the window the engine is
freed, and the plain reference reads a sample of the finished requests
drawn from the seed, the longest among them.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from bench import roofline, weights
from bench.kinds.train import (_power, _sync, layout_of, model_config,
                               setup_parts, walk)
from bench.reference import byzantine, precision
from bench.trace import Profiled
from bench.traffic import request_pool


def build_program(cell, mcfg, stacked):
    """The engine the window drives."""
    from repro_torch.agg.specs import AggSpec
    from repro_torch.serving import ServingEngine
    tr = cell.traffic
    spec = AggSpec(f=tr["f"], gar=tr["gar"],
                   distance_backend=tr["distance_backend"])
    return ServingEngine(stacked, mcfg, n_slots=tr["slots"],
                         cache_len=tr["cache_len"], ensemble=spec)


class Loop:
    """The closed loop: one request in flight per client, and each
    token's host time."""

    def __init__(self, engine, pool):
        from repro_torch.serving import Request
        self.engine, self.pool, self.Request = engine, pool, Request
        self.next = [0] * len(pool)
        self.flight: Dict[int, object] = {}
        self.reqs: Dict[int, object] = {}
        self.times: Dict[int, List[float]] = {}
        self.done_at: Dict[int, float] = {}
        self.rid = 0
        admit = engine.admit

        def timed_admit(req):
            ok = admit(req)
            if ok:
                self.times[req.rid] = [time.perf_counter()]
            return ok
        engine.admit = timed_admit

    def pump(self) -> None:
        for c, queue in enumerate(self.pool):
            if c in self.flight:
                continue
            prompt, out = queue[self.next[c] % len(queue)]
            self.next[c] += 1
            req = self.Request(self.rid, prompt, out)
            self.reqs[self.rid] = req
            self.flight[c] = req
            self.engine.submit(req)
            self.rid += 1

    def step(self) -> float:
        self.pump()
        self.engine.step()
        now = time.perf_counter()
        for c, req in list(self.flight.items()):
            seen = self.times.get(req.rid)
            if seen is None:
                continue
            while len(seen) < len(req.generated or ()):
                seen.append(now)
            if req.done:
                self.done_at[req.rid] = now
                del self.flight[c]
        return now


class Timed:
    """A synchronized wrapper around one of the engine's robust steps
    (traced run only): host ms per call and each call's least time."""

    def __init__(self, fn, work):
        self.fn, self.work = fn, work
        self.ms: List[float] = []
        self.least_s = 0.0
        self.calls = []

    def __call__(self, *args, **kw):
        _sync("cuda" if torch.cuda.is_available() else "cpu")
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        _sync("cuda" if torch.cuda.is_available() else "cpu")
        self.ms.append((time.perf_counter() - t0) * 1e3)
        nbytes, flops, d = self.work(args)
        self.least_s += roofline.least_s(nbytes, flops)
        self.calls.append(d)
        return out


def run(cell, t_start: float, control: bool = False) -> Dict:
    from repro_torch.kernels import _build
    tr, dev = cell.traffic, cell.device
    marks = [("imports", time.perf_counter())]
    if dev == "cuda":
        _build.build_all()
    marks.append(("kernels", time.perf_counter()))
    mcfg = model_config(cell)
    layout = layout_of(mcfg)
    reps = len(tr["jitters"]) + 1
    stacked = weights.draw_ensemble(layout, cell.model.init_rule, cell.seed,
                                    dev, tr["jitters"], tr["poison_scale"])
    _sync(dev)
    marks.append(("weights", time.perf_counter()))
    engine = build_program(cell, mcfg, stacked)
    del stacked
    loop = Loop(engine, request_pool(tr, mcfg.vocab_size, cell.seed))
    _sync(dev)
    marks.append(("engine_and_inputs", time.perf_counter()))
    for _ in range(tr["warmup_steps"]):
        loop.step()
    _sync(dev)
    marks.append(("warm_up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start

    vocab = mcfg.vocab_size
    dec = pre = None
    if cell.trace:
        dec = Timed(engine._decode, lambda a: cell.model.decode_work(
            cell.config, reps, a[3]) + (tr["slots"] * vocab,))
        pre = Timed(engine._ens_prefill, lambda a: cell.model.prefill_work(
            cell.config, reps, a[1].shape[-1]) + (vocab,))
        engine._decode, engine._ens_prefill = dec, pre
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prof, dev_tr, k5_calls = None, None, []
    t0 = time.perf_counter()
    k = 0
    while True:
        if cell.trace and k == 1:
            prof = Profiled(host=False).__enter__()
            n_dec, n_pre = len(dec.calls), len(pre.calls)
        now = loop.step()
        k += 1
        if prof is not None and k == 1 + tr["trace_steps"]:
            dev_tr = prof.stop(lambda: _sync(dev))
            k5_calls = dec.calls[n_dec:] + pre.calls[n_pre:]
            prof = None
        if now - t0 >= cell.seconds and (not cell.trace
                                          or k > 1 + tr["trace_steps"]):
            break
    t1 = now
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    itl, tokens, admitted = [], 0, 0
    for rid, ts in loop.times.items():
        if ts[0] >= t0:
            admitted += 1
        tokens += sum(1 for t in ts if t0 <= t <= t1)
        itl += [b - a for a, b in zip(ts, ts[1:]) if a >= t0]
    finished = sorted(rid for rid, t in loop.done_at.items() if t0 <= t <= t1)
    sample = _sample(loop, finished, tr["check_requests"], cell.seed)
    served = [(np.asarray(loop.reqs[r].prompt), list(loop.reqs[r].generated))
              for r in sample]
    # the loop's timed admit closes a cycle through the engine
    del engine, loop
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    window = t1 - t0
    out = {"attempted": admitted, "failed": 0, "memory_peak_bytes": peak,
           "power": _power(dev), "setup_parts": setup_parts(t_start, marks),
           "end_to_end": {
               "setup_s": setup_s,
               "serve_tokens_per_s": tokens / window,
               "itl_ms_p95": 1e3 * _pct(itl, 95)}}
    measured = {"peak_bytes": peak, "window_s": window, "steps": k,
                "serve": True}
    if cell.trace:
        tr_ = dev_tr
        measured.update(
            trace=tr_, traced_s=tr_.seconds, decode_ms=dec.ms,
            prefill_ms=pre.ms,
            least_s=dec.least_s + pre.least_s,
            k5_least_s=sum(roofline.kernel_least_s("k5", reps, d, tr["f"])
                           for d in k5_calls))
        out.update(busy_s=tr_.busy_s, window_s=tr_.seconds,
                   breakdown=tr_.breakdown())
    out["measured"] = measured
    t_ref = time.perf_counter()
    gaps = reference_gaps(cell, layout, served, control)
    out["numbers"] = {"gap": max(gaps["program"])}
    out["readings"] = {"served_tokens": sum(len(g) for _, g in served),
                       "requests": len(served)}
    if control:
        out["readings"]["control_gap"] = max(gaps["control"])
    out["reference_s"] = time.perf_counter() - t_ref
    return out


def readings(cell, faults: bool = True, control: bool = True) -> Dict:
    """One seed's numbers: the program's gap after a window at the
    cell's load, and the control's (the token the TF32 reference puts
    first) on the same prompts and served tokens."""
    del faults
    cell.seconds = cell.traffic["readings_seconds"]
    out = run(cell, time.perf_counter(), control=control)
    got = {"program": out["numbers"],
           "served_tokens": out["readings"]["served_tokens"],
           "end_to_end": out["end_to_end"],
           "reference_s": out["reference_s"]}
    if control:
        got["control"] = {"gap": out["readings"]["control_gap"]}
    return got


def _sample(loop, finished: List[int], count: int, seed: int) -> List[int]:
    """``count`` finished requests drawn from ``seed``, the longest
    (prompt and output) among them."""
    if not finished:
        raise RuntimeError("no request finished inside the window")
    longest = max(finished, key=lambda r: (len(loop.reqs[r].prompt)
                                           + len(loop.reqs[r].generated), r))
    rest = [r for r in finished if r != longest]
    rng = np.random.default_rng((seed, 17))
    pick = rng.permutation(len(rest))[:max(0, count - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def _pct(xs: List[float], q: int) -> float:
    if len(xs) < 2:
        return float("nan")
    return statistics.quantiles(xs, n=100, method="inclusive")[q - 1]


def reference_aggregate(cell, tree, prompt, generated, replicas: int, f: int,
                        dev) -> torch.Tensor:
    """The reference's robust logits ``(T, V)`` at the positions that
    chose each served token: every replica's plain forward over the
    prompt and the served tokens, then Bulyan(Krum) per position."""
    seq = torch.as_tensor(np.concatenate(
        [prompt, np.asarray(generated[:-1], np.int32)]), device=dev)
    first = len(prompt) - 1
    with torch.no_grad():
        stack = torch.stack([
            cell.model.reference_logits(
                weights._nest((p, x[r]) for p, x in walk(tree)), seq,
                cell.config)[first:] for r in range(replicas)])
        out = torch.empty(stack.shape[1:], dtype=stack.dtype, device=dev)
        for t in range(stack.shape[1]):
            agg, _ = byzantine.bulyan_krum([stack[:, t]], f)
            out[t] = agg[0]
    return out


def reference_gaps(cell, layout, served, control: bool = False) -> Dict:
    """For each served token, the gap by which the reference's robust
    logit of it lies below the reference's best at that position; with
    ``control``, also the gap of the token the TF32 reference puts
    first."""
    tr, dev = cell.traffic, cell.device
    reps = len(tr["jitters"]) + 1
    tree = weights.draw_ensemble(layout, cell.model.init_rule, cell.seed,
                                 dev, tr["jitters"], tr["poison_scale"])
    out = {"program": [], "control": []}
    for prompt, generated in served:
        with precision.precision("fp32", dev):
            agg = reference_aggregate(cell, tree, prompt, generated, reps,
                                      tr["f"], dev)
        tok = torch.as_tensor(generated, device=dev).long()[:, None]
        best = agg.max(dim=-1).values
        out["program"] += (best - agg.gather(1, tok)[:, 0]).tolist()
        if control:
            with precision.precision("tf32", dev):
                low = reference_aggregate(cell, tree, prompt, generated,
                                          reps, tr["f"], dev)
            pick = low.argmax(dim=-1)[:, None]
            out["control"] += (best - agg.gather(1, pick)[:, 0]).tolist()
    del tree
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out
