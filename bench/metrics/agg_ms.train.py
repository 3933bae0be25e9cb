"""Device ms per step of what the tree engine launched under the
program's ``agg/`` spans (``agg/gram``, ``agg/select``,
``agg/coordinate``), read from the traced run's one step with the host's
operators recorded."""


def read(m):
    t = m.get("agg_span_s")
    return 1e3 * t if t else None
