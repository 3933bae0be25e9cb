"""Median host ms per robust decode call (``ServingEngine._decode``),
synchronized before and after, in the traced run."""
import statistics


def read(m):
    ms = m.get("decode_ms")
    return statistics.median(ms) if ms else None
