"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: device busy time, kernel time by name and by the program's spans,
and the longest idle gaps with what the host was doing in them.

The trace is the profiler's Chrome-trace export.  A device event
(kernel, copy or set) is tied to the host call that launched it by its
``correlation`` id, and belongs to a span when that launch falls inside
the span's host interval (``user_annotation``: the program's
``named_span`` ranges).
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
#: the program's tree-engine spans (``repro_torch.obs.trace.named_span``)
SPAN_PREFIX = "agg/"


def short_name(name: str) -> str:
    """A kernel name without its return type, namespaces' noise and
    template arguments, at most 100 characters."""
    s = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out)
    s = s.split("(")[0].strip() or s
    return s[:100]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """One exported profile, reduced.

    Attributes:
      busy_s: seconds in which some device operation ran (union).
      by_kernel: short kernel name -> device seconds.
      span_s: top-level ``agg/`` span name -> device seconds of the
        operations launched inside it (a span inside another counts once,
        for the outer one).
      gaps: ``(seconds, host activity)`` of the idle gaps, longest first.
      kernels: ``(full name, seconds)`` of every device kernel.
    """

    def __init__(self, path: str):
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        dev = [e for e in events if e.get("cat") in _DEVICE
               and e.get("ph") == "X"]
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") in _LAUNCH and "correlation" in
                  e.get("args", {})}
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in events if e.get("cat") == "user_annotation"
                       and e["name"].startswith(SPAN_PREFIX))
        top: List[Tuple[float, float, str]] = []
        for a, b, name in spans:
            if top and a >= top[-1][0] and b <= top[-1][1]:
                continue
            top.append((a, b, name))
        starts = [a for a, _, _ in top]
        self.by_kernel: Dict[str, float] = {}
        self.span_s: Dict[str, float] = {}
        self.kernels: List[Tuple[str, float]] = []
        ivals = []
        for e in dev:
            dur = e["dur"] * 1e-6
            ivals.append((e["ts"], e["ts"] + e["dur"]))
            key = short_name(e["name"])
            self.by_kernel[key] = self.by_kernel.get(key, 0.0) + dur
            if e.get("cat") == "kernel":
                self.kernels.append((e["name"], dur))
            t = launch.get(e.get("args", {}).get("correlation"))
            if t is not None and starts:
                k = bisect.bisect_right(starts, t) - 1
                if k >= 0 and t <= top[k][1]:
                    name = top[k][2]
                    self.span_s[name] = self.span_s.get(name, 0.0) + dur
        busy = _union(ivals)
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        host = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                      for e in events
                      if e.get("cat") in ("cpu_op", "user_annotation",
                                          "cuda_runtime")
                      and e.get("ph") == "X")
        starts_dev = sorted((e["ts"], short_name(e["name"])) for e in dev)
        self.gaps = []
        for (_, b0), (a1, _) in zip(busy, busy[1:]):
            k = bisect.bisect_left(starts_dev, (a1, ""))
            after = starts_dev[k][1] if k < len(starts_dev) else "?"
            self.gaps.append(((a1 - b0) * 1e-6,
                              f"{_doing(host, (a1 + b0) / 2)}, then "
                              f"{after[:60]}"))
        self.gaps.sort(key=lambda g: -g[0])

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose full name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.kernels if rx.search(name))

    def breakdown(self) -> Dict:
        """The result line's ``breakdown``: the 10 device operations that
        took most time and the 10 longest idle gaps."""
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[doing, s] for s, doing in self.gaps[:10]]}


def _doing(host, t: float) -> str:
    """The shortest host event that covers time ``t``."""
    best: Optional[Tuple[float, str]] = None
    k = bisect.bisect_right(host, (t, float("inf"), "")) - 1
    # the covering events start before t; look back a bounded distance
    for a, b, name in host[max(0, k - 4000):k + 1]:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return "host " + (best[1][:60] if best else "in Python")


def load(path: str) -> Trace:
    """Reduce the trace at ``path``, then delete the file."""
    try:
        return Trace(path)
    finally:
        os.remove(path)


class Profiled:
    """``torch.profiler`` around a stretch of steps, exported and reduced
    when it stops.  ``host=False`` records device activity only (kernels,
    copies and their launches), which keeps the steps' own pace: the
    host's operator records slow a step of many small operations several
    times over.  ``host=True`` adds them, and the program's spans."""

    def __init__(self, host: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available()
        acts = ([ProfilerActivity.CUDA] if cuda else []) + (
            [ProfilerActivity.CPU] if host or not cuda else [])
        self.prof = profile(activities=acts)
        self.host = host

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def stop(self, sync) -> Trace:
        """Stop after ``sync()``; the reduced trace, with ``seconds`` the
        host time from start to stop."""
        sync()
        self.prof.__exit__(None, None, None)
        seconds = time.perf_counter() - self.t0
        path = os.path.join(tempfile.gettempdir(),
                            f"bench_trace_{os.getpid()}.json")
        self.prof.export_chrome_trace(path)
        tr = load(path)
        tr.seconds = seconds
        return tr
