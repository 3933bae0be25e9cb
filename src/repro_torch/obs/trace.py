"""Tracing hooks: profiler phase names and a host-side span timer
(counterpart of ``repro/obs/trace.py``).

Two layers share one event schema (:data:`EVENT_FIELDS`):

* :func:`named_span` — a ``torch.profiler.record_function`` wrapper the
  hot paths wear around their phases (``agg/gram``, ``agg/select``,
  ``agg/coordinate``, ``kernel/fused``), so a ``torch.profiler`` trace
  groups the kernels and operators of each phase under a readable name.
  Metadata only: it never changes the computation.
* :class:`SpanTimer` — a host-side wall-clock timer whose
  ``with timer.span("name")`` blocks become event rows, exported as
  JSONL with the same schema as every other timing row.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, List

import torch

__all__ = ["EVENT_FIELDS", "SpanTimer", "named_span", "span_event"]

#: the shared event schema: every exported timing row carries exactly
#: these keys (``meta`` is a free-form dict — backend, shape, seed, ...)
EVENT_FIELDS = ("name", "us", "meta")


def named_span(name: str):
    """Profiler phase annotation (``torch.profiler.record_function``).

    Metadata only: the work run under it is unchanged.  Outside a
    profiling session it records nothing.

    Args:
      name: phase label, conventionally ``layer/phase`` (e.g.
        ``"agg/gram"``).

    Returns:
      A context manager.
    """
    return torch.profiler.record_function(name)


def span_event(name: str, us: float, **meta: Any) -> Dict[str, Any]:
    """One timing event row in the shared schema.

    Args:
      name: event label (phase or benchmark row name).
      us: duration in microseconds.
      **meta: free-form metadata (backend, n, d, seed, ...).

    Returns:
      Dict with exactly :data:`EVENT_FIELDS`.
    """
    return {"name": name, "us": float(us), "meta": dict(meta)}


class SpanTimer:
    """Host-side wall-clock span collector with JSONL export.

    Usage::

        timer = SpanTimer()
        with timer.span("train/step", model="mnist"):
            trainer.run(batcher, 1)
            torch.cuda.synchronize()
        timer.export_jsonl("events.jsonl")

    Spans time the host's wall clock (``time.perf_counter``): call
    ``torch.cuda.synchronize()`` inside the block when device work must
    be included.  The collected rows follow :data:`EVENT_FIELDS`.
    """

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    @contextlib.contextmanager
    def span(self, name: str, **meta: Any):
        """Time one ``with`` block as an event row.

        Args:
          name: event label.
          **meta: free-form metadata attached to the row.

        Returns:
          A context manager appending one :func:`span_event` row on
          exit (also on exception, so partial runs keep their timeline).
        """
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            us = (time.perf_counter() - t0) * 1e6
            self.events.append(span_event(name, us, **meta))

    def export_jsonl(self, path) -> int:
        """Write the collected events as one JSON object per line.

        Args:
          path: destination file path (overwritten).

        Returns:
          Number of event rows written.
        """
        with open(path, "w") as fh:
            for ev in self.events:
                fh.write(json.dumps(ev) + "\n")
        return len(self.events)
