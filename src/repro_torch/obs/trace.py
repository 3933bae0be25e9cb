"""Profiler phase names (counterpart of ``repro/obs/trace.py``).

Only :func:`named_span` is ported: the tree engine wears it around its
phases (``agg/gram``, ``agg/select``, ``agg/coordinate``,
``kernel/fused``), so a ``torch.profiler`` trace groups the kernels and
operators of each phase under a readable name.  The reference's
host-side ``SpanTimer`` and event schema come with the telemetry port.
"""
from __future__ import annotations

import torch

__all__ = ["named_span"]


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
