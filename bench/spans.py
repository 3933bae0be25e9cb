"""A profile read under the program's spans: each device operation under
the phase whose span holds its launch, each idle gap under the phase the
host was in at its midpoint, each synchronizing runtime call under the
phase that made it.

Two inputs share one clock.  The profiler's Chrome-trace export gives
each event's ``ts`` in microseconds from its ``baseTimeNanoseconds``, so
an event begins at ``baseTimeNanoseconds + ts * 1000`` Unix-epoch
nanoseconds; ``repro_torch.obs.trace.SpanRecorder`` stamps its rows
(``name``, ``start_ns``, ``end_ns``, ``parent``) on that clock.  The
rows nest as the program's blocks do, so a time belongs to the
innermost row whose interval holds it, and a row's phases are its chain
of parents.  Times here are microseconds on the trace's own axis.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from bench.trace import _DEVICE, _LAUNCH, _doing, _union, short_name

#: runtime calls that wait for the device: a host sync.
#: ``cudaDeviceSynchronize`` is left out (only the harness's own ``_sync``
#: makes it), and so is every ``*Async`` call, which waits only when a
#: synchronize follows it (that synchronize is counted).
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy")
#: the name of the time that no row holds
OUTSIDE = "outside"


def _innermost(rows: List[Tuple[float, float, int]],
               times: Sequence[float]) -> List[Optional[int]]:
    """For each time (any order), the index of the innermost row whose
    ``[start, end]`` holds it, or ``None``.  ``rows`` are ``(start, end,
    index)`` of properly nested intervals; a NaN time is held by none."""
    order = sorted((k for k, t in enumerate(times) if t == t),
                   key=times.__getitem__)
    spans = sorted(rows, key=lambda r: (r[0], -r[1]))
    out: List[Optional[int]] = [None] * len(times)
    stack: List[Tuple[float, float, int]] = []
    i = 0
    for k in order:
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def _check_nested(rows: Sequence[dict],
                  ivals: List[Tuple[float, float, int]]) -> None:
    """``ValueError`` unless the rows nest as one thread's blocks do: each
    row lies inside its ``parent`` and overlaps no row but its ancestors
    and descendants.  Rows that two threads recorded at once do not, and
    :func:`_innermost` would put their operations under the wrong row."""
    stack: List[Tuple[float, float, int]] = []
    for a, b, k in sorted(ivals, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] <= a:
            stack.pop()
        want = stack[-1][2] if stack else None
        if rows[k].get("parent") != want or (stack and b > stack[-1][1]):
            raise ValueError(
                f"row {k} ({rows[k]['name']!r}) does not nest in row {want}: "
                "rows from concurrent threads cannot be attributed")
        stack.append((a, b, k))


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two unions of disjoint sorted
    intervals."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0.0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return total


class Spans:
    """One Chrome trace (the loaded JSON object) under the rows a
    ``SpanRecorder`` took while the profiler ran, in one thread
    (``ValueError`` for rows that do not nest).

    Attributes:
      rows: the recorder's rows.
      names: each row's chain of names, innermost first.
      ops: ``(start, end, short name, row)`` of every device operation
        (kernel, copy or set); ``row`` holds its launch, ``None`` outside
        every row (also for an operation whose launch the trace lacks).
      syncs: ``(start, name, row)`` of each :data:`SYNC_CALLS` call.
      busy: the union of the operations' intervals.
    """

    def __init__(self, trace: dict, rows: Sequence[dict]):
        events = trace["traceEvents"]
        base = int(trace.get("baseTimeNanoseconds", 0))
        self.rows = list(rows)
        self.names = []
        for r in self.rows:
            chain, p = [r["name"]], r.get("parent")
            while p is not None:
                chain.append(self.rows[p]["name"])
                p = self.rows[p].get("parent")
            self.names.append(tuple(chain))
        self.ivals = [((r["start_ns"] - base) / 1e3,
                       float("inf") if r.get("end_ns") is None
                       else (r["end_ns"] - base) / 1e3, i)
                      for i, r in enumerate(self.rows)]
        _check_nested(self.rows, self.ivals)
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") in _LAUNCH
                  and "correlation" in e.get("args", {})}
        dev = [e for e in events if e.get("cat") in _DEVICE
               and e.get("ph") == "X"]
        at = [launch.get(e.get("args", {}).get("correlation"),
                         float("nan")) for e in dev]
        held = _innermost(self.ivals, at)
        self.ops = [(e["ts"], e["ts"] + e["dur"], short_name(e["name"]),
                     row) for e, row in zip(dev, held)]
        calls = [e for e in events if e.get("cat") == "cuda_runtime"
                 and e.get("ph") == "X" and e.get("name") in SYNC_CALLS]
        held = _innermost(self.ivals, [e["ts"] for e in calls])
        self.syncs = [(e["ts"], e["name"], row)
                      for e, row in zip(calls, held)]
        self.busy = _union([(a, b) for a, b, _, _ in self.ops])
        self._host = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                            for e in events
                            if e.get("cat") in ("cpu_op", "user_annotation",
                                                "cuda_runtime")
                            and e.get("ph") == "X")
        self._starts = sorted((a, name) for a, _, name, _ in self.ops)

    def _in(self, row: Optional[int], name: str,
            under: Optional[str]) -> bool:
        if row is None:
            return False
        chain = self.names[row]
        return name in chain and (under is None or under in
                                  chain[chain.index(name) + 1:])

    def count(self, name: str) -> int:
        """Rows named ``name``."""
        return sum(1 for chain in self.names if chain[0] == name)

    def device_s(self, name: str, under: Optional[str] = None) -> float:
        """Device seconds of the operations launched inside a row named
        ``name`` (itself inside one named ``under``)."""
        return 1e-6 * sum(b - a for a, b, _, row in self.ops
                          if self._in(row, name, under))

    def syncs_in(self, name: str) -> int:
        """Host syncs made inside a row named ``name``."""
        return sum(1 for _, _, row in self.syncs
                   if self._in(row, name, None))

    def idle_s(self, name: str) -> float:
        """Seconds with no device operation running while the host was
        inside a row named ``name``."""
        held = _union([(a, b) for a, b, k in self.ivals
                       if self.names[k][0] == name])
        return 1e-6 * (sum(b - a for a, b in held)
                       - _overlap(held, self.busy))

    def per_row(self, name: str) -> List[Dict[str, float]]:
        """For each row named ``name``: its host ms, the ms the device was
        busy within it, and the device ms of the operations launched
        inside it and inside each of its direct children's names."""
        out = []
        for k, (a, b, _) in enumerate(self.ivals):
            if self.names[k][0] != name:
                continue
            mine = [(x, y, row) for x, y, _, row in self.ops
                    if row is not None and self._holds(k, row)]
            got = {"host_ms": (b - a) * 1e-3,
                   "busy_ms": _overlap([(a, b)], self.busy) * 1e-3,
                   "launched_ms": sum(y - x for x, y, _ in mine) * 1e-3}
            for x, y, row in mine:
                if row == k:
                    continue
                child = self._child_of(k, row)
                key = self.rows[child]["name"] + "_ms"
                got[key] = got.get(key, 0.0) + (y - x) * 1e-3
            out.append(got)
        return out

    def _holds(self, k: int, row: int) -> bool:
        while row is not None:
            if row == k:
                return True
            row = self.rows[row].get("parent")
        return False

    def _child_of(self, k: int, row: int) -> int:
        while self.rows[row].get("parent") != k:
            row = self.rows[row]["parent"]
        return row

    def by_span(self) -> Dict[str, float]:
        """Device seconds by the innermost row's name (:data:`OUTSIDE`
        for none): each operation counted once."""
        out: Dict[str, float] = {}
        for a, b, _, row in self.ops:
            key = OUTSIDE if row is None else self.names[row][0]
            out[key] = out.get(key, 0.0) + (b - a) * 1e-6
        return out

    def idle_gaps(self, top: int = 10) -> List[list]:
        """``[label, seconds]`` of the ``top`` longest gaps between device
        operations, longest first.  The label is ``bench.trace.Trace``'s
        (the host event that covers the gap's midpoint, then the next
        operation) after the innermost row there: ``"serve/sample: host
        in Python, then ..."``."""
        gaps = [(a1 - b0, (a1 + b0) / 2, a1)
                for (_, b0), (a1, _) in zip(self.busy, self.busy[1:])]
        gaps.sort(key=lambda g: -g[0])
        gaps = gaps[:top]
        held = _innermost(self.ivals, [mid for _, mid, _ in gaps])
        out = []
        for (dur, mid, a1), row in zip(gaps, held):
            k = bisect.bisect_left(self._starts, (a1, ""))
            after = self._starts[k][1] if k < len(self._starts) else "?"
            span = OUTSIDE if row is None else self.names[row][0]
            out.append([f"{span}: {_doing(self._host, mid)}, then "
                        f"{after[:60]}", dur * 1e-6])
        return out


def numbers(sp: Spans, traced_s: float) -> Dict[str, float]:
    """The per-layer numbers the spans give, for the phases the rows
    hold: a train step's (``train/step``) or the serving engine's
    (``serve/step``).  ``traced_s`` is the profiled stretch's host
    seconds, as ``device_idle.*`` divides by."""
    out: Dict[str, float] = {}
    steps = sp.count("train/step")
    if steps:
        inside = sp.device_s("train/step")
        parts = {"grad_ms.train": "train/grad",
                 "attack_ms.train": "train/attack",
                 "aggregate_ms.train": "train/aggregate",
                 "opt_ms.train": "train/opt"}
        for key, name in parts.items():
            out[key] = 1e3 * sp.device_s(name) / steps
        out["host_syncs.train"] = sp.syncs_in("train/step") / steps
        out["program_idle.train"] = 100.0 * sp.idle_s("train/step") / traced_s
        out["covered.train"] = (100.0 * sum(sp.device_s(n) for n in
                                            parts.values()) / inside
                                if inside else float("nan"))
    steps = sp.count("serve/step")
    if steps:
        inside = sp.device_s("serve/step")
        decodes = sp.count("serve/decode")
        splices = sp.count("serve/splice")
        if decodes:
            out["cache_ms.serve"] = 1e3 * sp.device_s(
                "model/cache", under="serve/decode") / decodes
        if splices:
            out["splice_ms.serve"] = 1e3 * sp.device_s(
                "serve/splice") / splices
        out["host_syncs.serve"] = sp.syncs_in("serve/step") / steps
        out["program_idle.serve"] = 100.0 * sp.idle_s("serve/step") / traced_s
        out["covered.serve"] = (
            100.0 * sum(sp.device_s(n) for n in ("serve/admit",
                                                 "serve/decode",
                                                 "serve/sample")) / inside
            if inside else float("nan"))
    return out


def clock_gaps(trace: dict, rows: Sequence[dict],
               prefix: str = "agg/") -> Dict[str, float]:
    """How far the rows named ``prefix*`` lie from their own
    ``record_function`` events (``user_annotation``) in a profile that
    recorded the host: the i-th row of a name against the i-th event of
    that name, in microseconds, start and end apart.  Returns the median
    and the largest absolute gap of each, and the pairs compared."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    events: Dict[str, List[Tuple[float, float]]] = {}
    for e in trace["traceEvents"]:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e["name"].startswith(prefix)):
            events.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    mine: Dict[str, List[Tuple[float, float]]] = {}
    for r in rows:
        if r["name"].startswith(prefix) and r.get("end_ns") is not None:
            mine.setdefault(r["name"], []).append(
                ((r["start_ns"] - base) / 1e3, (r["end_ns"] - base) / 1e3))
    starts, ends = [], []
    for name, got in mine.items():
        want = sorted(events.get(name, []))
        if len(want) != len(got):
            raise ValueError(f"{name}: {len(got)} rows against "
                             f"{len(want)} profiler events")
        for (a, b), (wa, wb) in zip(sorted(got), want):
            starts.append(abs(a - wa))
            ends.append(abs(b - wb))
    if not starts:
        return {"pairs": 0}
    return {"pairs": len(starts),
            "start_us_median": statistics.median(starts),
            "start_us_max": max(starts),
            "end_us_median": statistics.median(ends),
            "end_us_max": max(ends)}
