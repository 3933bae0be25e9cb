"""Program spans: profiler phase names and a recorder of their host
intervals (counterpart of ``repro/obs/trace.py``, whose host timer the
port replaces by the recorder).

:func:`named_span` is the one span API.  The hot paths wear it around
their phases (``train/step`` ⊃ ``train/grad``, ``train/attack``,
``train/aggregate`` ⊃ ``agg/*``, ``train/opt``; ``serve/step`` ⊃
``serve/admit`` ⊃ ``serve/prefill``, ``serve/splice``; ``serve/decode``
⊃ ``model/cache``, ``serve/aggregate``; ``serve/sample``;
``kernel/fused``; in the forward of a latent-attention layer
``model/mla``, of a grouped expert layer ``moe/route``, ``moe/experts``
and ``moe/shared``, whose backward kernels fall under ``train/grad``).  While a ``torch.profiler`` profile runs, each span
is a ``torch.profiler.record_function``, so a profile that records the
host's operators groups the kernels and operators of each phase under
its name; outside a profile it makes none (a ``record_function`` costs
some 8-10 µs of host time, which a decode step's dozen spans would add
to every token).  Metadata only: it never changes the computation and
reads no tensor.

While a :class:`SpanRecorder` records, each span also appends one row to
it: ``name``, ``start_ns`` and ``end_ns`` on the clock of the profiler's
Chrome trace (Unix-epoch nanoseconds: an event's ``baseTimeNanoseconds +
ts * 1000``), ``parent`` (the index of the span open in the same thread
when it began, or ``None``) and, where given, ``attrs``.  With no
profile running and no recorder recording, a span costs two flag
tests.  The rows let a
reader put each kernel of a device-only profile, and each idle gap,
under the program phase that launched it or waited.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = ["DEFAULT_CAPACITY", "SpanRecorder", "named_span"]

#: rows a recorder keeps; it counts the spans past them in ``dropped``
DEFAULT_CAPACITY = 1 << 20

#: the recorder that is recording, if any (at most one at a time)
_ACTIVE: Optional["SpanRecorder"] = None
_ACTIVE_LOCK = threading.Lock()


class SpanRecorder:
    """The rows of the spans that run while it records.

    Usage::

        rec = SpanRecorder()
        with rec:                     # or rec.start() ... rec.stop()
            params, opt_state, m = step(params, opt_state, batch)
        rec.rows, rec.dropped         # obs.export.write_jsonl(path, rows)

    Rows are appended when a span begins and closed when it ends, also
    when its block raises; a span still open when recording stops keeps
    ``end_ns`` ``None``.  The stamps are ``time.perf_counter_ns()``
    offset by one ``time.time_ns()`` pair taken at :meth:`start`, so they
    share the profiler trace's epoch clock and do not jump with it.

    Args:
      capacity: rows kept; later spans are counted in ``dropped``.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = int(capacity)
        self.rows: List[Dict[str, Any]] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._offset_ns = 0
        self._recording = False

    def start(self) -> "SpanRecorder":
        """Begin recording (``RuntimeError`` when another recorder is)."""
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("another SpanRecorder is recording")
            self._offset_ns = time.time_ns() - time.perf_counter_ns()
            self._recording = True
            _ACTIVE = self
        return self

    def stop(self) -> List[Dict[str, Any]]:
        """End recording; returns :attr:`rows`."""
        global _ACTIVE
        with _ACTIVE_LOCK:
            self._recording = False
            if _ACTIVE is self:
                _ACTIVE = None
        return self.rows

    def __enter__(self) -> "SpanRecorder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _stack(self) -> List[Optional[int]]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, attrs: Dict[str, Any]) -> Optional[int]:
        stack = self._stack()
        row = {"name": name,
               "start_ns": time.perf_counter_ns() + self._offset_ns,
               "end_ns": None,
               "parent": stack[-1] if stack else None}
        if attrs:
            row["attrs"] = dict(attrs)
        with self._lock:
            if len(self.rows) < self.capacity:
                index = len(self.rows)
                self.rows.append(row)
            else:
                index = None
                self.dropped += 1
        stack.append(index)
        return index

    def _close(self, index: Optional[int]) -> None:
        end = time.perf_counter_ns() + self._offset_ns
        self._stack().pop()
        if index is not None and self._recording:
            self.rows[index]["end_ns"] = end

    def _note(self, index: Optional[int], attrs: Dict[str, Any]) -> None:
        if index is not None and self._recording:
            self.rows[index].setdefault("attrs", {}).update(attrs)


class _Span:
    """One :func:`named_span` block."""

    __slots__ = ("_name", "_attrs", "_rf", "_rec", "_index")

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self._name = name
        self._attrs = attrs
        self._rf = None
        self._rec: Optional[SpanRecorder] = None
        self._index: Optional[int] = None

    def __enter__(self) -> "_Span":
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        rec = _ACTIVE
        if rec is not None:
            self._rec = rec
            self._index = rec._open(self._name, self._attrs)
        return self

    def note(self, **attrs: Any) -> None:
        """Add attributes to the span's row (a no-op unless recording):
        what the block learns only as it runs."""
        if self._rec is not None:
            self._rec._note(self._index, attrs)

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._rec is not None:
            self._rec._close(self._index)
        return False


def named_span(name: str, **attrs: Any) -> _Span:
    """A program phase: a ``torch.profiler.record_function`` while a
    profile runs and, while a :class:`SpanRecorder` records, one row.

    Metadata only: the work run under it is unchanged.

    Args:
      name: phase label, ``layer/phase`` (e.g. ``"agg/gram"``).
      **attrs: host values kept in the row's ``attrs`` (a request's
        ``rid``, a count); never a tensor's value, which would wait for
        the device.

    Returns:
      A context manager whose ``note(**attrs)`` adds attributes.
    """
    return _Span(name, attrs)
