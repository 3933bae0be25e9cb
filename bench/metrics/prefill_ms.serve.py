"""Median host ms per admission's robust prefill
(``ServingEngine._ens_prefill``), synchronized before and after, in the
traced run."""
import statistics


def read(m):
    ms = m.get("prefill_ms")
    return statistics.median(ms) if ms else None
