"""Observability: aggregation forensics, metrics schema, tracing, export
(counterpart of ``repro/obs``).

* ``repro_torch.obs.buffer`` — the :class:`MetricsBuffer` forensics ring
  carried in ``AggState.obs`` and its host-side :func:`drain`;
* ``repro_torch.obs.forensics`` — the ``obs-<base>`` registry family
  (:func:`make_obs`) recording one :class:`AggDiagnostics` row per
  aggregation call with the base rule's data path untouched;
* ``repro_torch.obs.detect`` — host-side attack detectors
  (selection-entropy collapse, suspicion ranking, ε-margin trajectory);
* ``repro_torch.obs.schema`` / ``export`` — the shared train-metrics
  schema and the JSONL / CSV writers;
* ``repro_torch.obs.trace`` — :func:`named_span`, the program's phase
  spans, and ``SpanRecorder``, which keeps each span's host interval on
  the profiler trace's clock while it records (the port's own: the
  reference's ``SpanTimer`` has no counterpart here).

Enable end to end with ``AggSpec(..., telemetry=True)``: the trainers
then aggregate through ``spec.effective_gar`` (``obs-<gar>``) and their
``telemetry()`` drains the carried ring.
"""
from repro_torch.obs.buffer import (DEFAULT_OBS_CAPACITY, AggDiagnostics,
                                    MetricsBuffer, drain,
                                    init_metrics_buffer, push_record)
from repro_torch.obs.detect import (margin_trajectory, selection_collapsed,
                                    selection_entropy, suspicion_scores)
from repro_torch.obs.export import (read_jsonl, to_jsonable, write_csv,
                                    write_jsonl)
from repro_torch.obs.forensics import (dense_diagnostics, make_obs,
                                       obs_name, tree_diagnostics)
from repro_torch.obs.schema import (METRIC_SCHEMA, async_extras,
                                    core_metrics, global_norm,
                                    selection_weight)
from repro_torch.obs.trace import named_span

__all__ = [
    "AggDiagnostics",
    "DEFAULT_OBS_CAPACITY",
    "METRIC_SCHEMA",
    "MetricsBuffer",
    "async_extras",
    "core_metrics",
    "dense_diagnostics",
    "drain",
    "global_norm",
    "init_metrics_buffer",
    "make_obs",
    "margin_trajectory",
    "named_span",
    "obs_name",
    "push_record",
    "read_jsonl",
    "selection_collapsed",
    "selection_entropy",
    "selection_weight",
    "suspicion_scores",
    "to_jsonable",
    "tree_diagnostics",
    "write_csv",
    "write_jsonl",
]
