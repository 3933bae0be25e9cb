"""Train-step metrics schema and profiler phase names.

The telemetry ring, the ``obs-<base>`` forensics rules, the detectors
and the exporters wait for ROADMAP item 4.
"""
from repro_torch.obs.schema import (METRIC_SCHEMA, async_extras,
                                    core_metrics, global_norm,
                                    selection_weight)
from repro_torch.obs.trace import named_span

__all__ = ["METRIC_SCHEMA", "async_extras", "core_metrics", "global_norm",
           "named_span", "selection_weight"]
