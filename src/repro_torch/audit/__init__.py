"""Adversarial self-audit: corner sweeps and empirical leeway
certification (counterpart of ``repro/audit``).

* ``repro_torch.audit.sweep`` — a corner sweep walking every registered
  aggregation rule and composite against the registered attacks over a
  (n, f, tau, schedule) grid, asserting the shared contracts: declared
  output invariants (``repro_torch.audit.invariants``), the canonical
  quorum error message, bitwise base-equality of uniformly stale
  composites, the bounded-staleness delivery guarantee, and the
  kernels' fp32-accumulation contract under bf16 inputs.
* ``repro_torch.audit.leeway`` — the empirical leeway meter: each rule's
  ε-poisoning margin as the model dimension grows, certified against
  the paper's two scaling laws (Krum-family leeway Omega(sqrt(d)),
  Bulyan's relative margin O(1/sqrt(d))) and a checked-in JSON baseline.

Both are CLIs (``python -m repro_torch.audit [sweep|leeway]``;
``scripts/torch_run_audit.py`` chains them) and both collect violations
instead of raising, so one run reports every broken corner.
"""
from repro_torch.audit import invariants, leeway, sweep
from repro_torch.audit.invariants import (check_quorum_contract,
                                          check_rule_output,
                                          effective_stack)
from repro_torch.audit.leeway import certify, measure_leeway
from repro_torch.audit.sweep import (AuditReport, SweepConfig, audit_roster,
                                     run_sweep)

__all__ = ["AuditReport", "SweepConfig", "audit_roster", "certify",
           "check_quorum_contract", "check_rule_output",
           "effective_stack", "invariants", "leeway", "measure_leeway",
           "run_sweep", "sweep"]
