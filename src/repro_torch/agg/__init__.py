"""Aggregation-rule registry, specs and the ``fused-<base>`` composites."""
