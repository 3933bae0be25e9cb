"""The invariant catalogue: executable checks behind the self-audit
(counterpart of ``repro/audit/invariants.py``).

Byzantine-tolerant systems rarely fail on the aggregation math; they
fail on threshold and quorum logic.  This module turns the shared
contracts into small checks, each returning a list of human-readable
violation strings (empty = holds), with the reference's texts, so the
sweep (``repro_torch.audit.sweep``) can walk every registered
rule x attack x (n, f, tau, backend) corner.

The output invariants are declared by the rules themselves (each
:class:`~repro_torch.agg.registry.AggregatorRule` carries an
``invariants`` tuple) and are asserted relative to the **effective
stack** the rule body consumed: ``stale-*`` composites reweight the
workers before the base rule runs, ``reputation-*`` composites blend
each row toward the trusted weighted mean, and ``buffered-*`` composites
smooth them through the window means, so :func:`effective_stack` (via
:func:`prewindow_stack`) recomputes that transformation from the carried
``AggState``.  The checks read tensors on any device (copied to the
host) or numpy arrays.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.agg.registry import AggregatorRule
from repro_torch.agg.specs import check_quorum
from repro_torch.agg.state import AggState

__all__ = ["check_convex", "check_finite", "check_hull",
           "check_quorum_contract", "check_rule_output", "check_trimmed",
           "effective_stack", "prewindow_stack"]

#: relative tolerance of the hull / convex checks (fp32 arithmetic)
_RTOL = 1e-4


def _f32(x) -> np.ndarray:
    """A tensor (any device) or array-like as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _tol(stack: np.ndarray) -> float:
    return _RTOL * max(float(np.max(np.abs(stack))), 1.0)


def prewindow_stack(rule: AggregatorRule, grads: torch.Tensor,
                    state: Optional[AggState]) -> np.ndarray:
    """The per-step reweighted stack, *before* any history window-mean.

    Walks ``rule.state_fields`` in order (outermost wrapper first) and
    replays each stack-reweighting transformation from the *pre-call*
    state:

    * ``"reputation"`` (``reputation-*``): the reputation blend
      ``w_i * g_i + (1 - w_i) * g_w`` with weights
      ``reputation_scale(state)``;
    * ``"bus"`` (``stale-*``): multiply by ``stale_scale(state)``.

    ``"history"`` is not applied: the window mean needs the
    caller-tracked history of these per-step stacks
    (:func:`effective_stack` folds it).

    Args:
      rule: the resolved rule under audit.
      grads: raw ``(n, d)`` worker stack fed to ``rule.dense_fn``.
      state: the ``AggState`` passed *into* the call (``None`` for
        stateless rules).

    Returns:
      ``(n, d)`` float32 numpy stack after every per-step reweighting.
    """
    eff = _f32(grads)
    if state is None:
        return eff
    for field in rule.state_fields:
        if field == "reputation":
            from repro_torch.agg.reputation import (blend_stack,
                                                    reputation_scale)
            w = reputation_scale(state)
            eff = _f32(blend_stack(torch.from_numpy(eff).to(w.device), w))
        elif field == "bus":
            from repro_torch.agg.staleness import stale_scale
            weight = "exp" if "-exp-" in rule.name else "inv"
            scale = _f32(stale_scale(state, weight))
            eff = eff * scale[:, None]
    return eff


def effective_stack(rule: AggregatorRule, grads: torch.Tensor,
                    state: Optional[AggState],
                    history: Optional[Sequence[np.ndarray]] = None
                    ) -> np.ndarray:
    """The ``(n, d)`` stack the rule body actually aggregated.

    First the per-step reweightings of :func:`prewindow_stack`, then for
    ``buffered-*`` (``"history"``) the per-worker window means over the
    caller-tracked ``history`` of (already reweighted) stacks.

    Args:
      rule: the resolved rule under audit.
      grads: raw ``(n, d)`` worker stack fed to ``rule.dense_fn``.
      state: the ``AggState`` passed *into* the call (``None`` for
        stateless rules).
      history: for history-buffered rules, the effective inputs of the
        last calls **including this one**, oldest first (each a
        :func:`prewindow_stack` output; at most ``rule.history_window``
        entries are used).  ``None`` treats this as the first step.

    Returns:
      ``(n, d)`` float32 numpy stack the invariants are checked against.
    """
    eff = prewindow_stack(rule, grads, state)
    if "history" in rule.state_fields:
        w = rule.history_window or 1
        window = list(history or [])[-w:] or [eff]
        eff = np.mean(np.stack(window, axis=0), axis=0)
    return eff


def check_finite(agg, label: str = "") -> List[str]:
    """No NaN/inf in the aggregate, the universal invariant.

    Args:
      agg: ``(d,)`` aggregated gradient.
      label: case label prefixed to any violation.

    Returns:
      List of violation strings (empty when every entry is finite).
    """
    a = _f32(agg)
    if np.isfinite(a).all():
        return []
    return [f"{label}: aggregate contains NaN/inf "
            f"({int((~np.isfinite(a)).sum())} coords)"]


def check_hull(agg, stack: np.ndarray, label: str = "") -> List[str]:
    """Per-coordinate convex-hull membership.

    Every declared-``"hull"`` rule promises its output coordinate lies
    within ``[min_w, max_w]`` of the (effective) worker stack.

    Args:
      agg: ``(d,)`` aggregate.
      stack: ``(n, d)`` effective worker stack.
      label: case label for violations.

    Returns:
      Violations (empty when the aggregate is inside the hull + tol).
    """
    a = _f32(agg)
    lo, hi = stack.min(axis=0), stack.max(axis=0)
    tol = _tol(stack)
    bad = (a < lo - tol) | (a > hi + tol)
    if not bad.any():
        return []
    i = int(np.argmax(bad))
    return [f"{label}: aggregate leaves the worker hull at coord {i}: "
            f"{a[i]:.6g} not in [{lo[i]:.6g}, {hi[i]:.6g}] "
            f"({int(bad.sum())} coords total)"]


def check_trimmed(agg, stack: np.ndarray, f: int,
                  label: str = "") -> List[str]:
    """Per-coordinate f-trimmed-hull membership.

    Coordinate-wise rules (``cwmed``, ``trimmed_mean``) promise the
    output lies within ``[sorted[f], sorted[n-1-f]]`` per coordinate.

    Args:
      agg: ``(d,)`` aggregate.
      stack: ``(n, d)`` effective worker stack.
      f: Byzantine bound used by the call.
      label: case label for violations.

    Returns:
      Violations (empty when inside the trimmed range + tol).
    """
    n = stack.shape[0]
    if n <= 2 * f:
        return [f"{label}: trimmed check needs n > 2f (n={n}, f={f})"]
    a = _f32(agg)
    s = np.sort(stack, axis=0)
    lo, hi = s[f], s[n - 1 - f]
    tol = _tol(stack)
    bad = (a < lo - tol) | (a > hi + tol)
    if not bad.any():
        return []
    i = int(np.argmax(bad))
    return [f"{label}: aggregate leaves the f-trimmed hull at coord {i}: "
            f"{a[i]:.6g} not in [{lo[i]:.6g}, {hi[i]:.6g}] "
            f"({int(bad.sum())} coords total)"]


def check_convex(gradient, selected, stack: np.ndarray,
                 label: str = "") -> List[str]:
    """``selected`` is a valid convex-combination certificate.

    Declared-``"convex"`` rules report per-worker weights that must be
    nonnegative, sum to 1, and reproduce the aggregate:
    ``gradient == selected @ stack``.

    Args:
      gradient: ``(d,)`` aggregate.
      selected: ``(n,)`` reported worker weights.
      stack: ``(n, d)`` effective worker stack.
      label: case label for violations.

    Returns:
      Violations (empty when the certificate checks out).
    """
    out: List[str] = []
    w = _f32(selected)
    if (w < -1e-6).any():
        out.append(f"{label}: negative selection weight "
                   f"(min {float(w.min()):.3g})")
    if abs(float(w.sum()) - 1.0) > 1e-4:
        out.append(f"{label}: selection weights sum to "
                   f"{float(w.sum()):.6g}, not 1")
    recon = w @ stack
    err = float(np.max(np.abs(recon - _f32(gradient))))
    if err > _tol(stack):
        out.append(f"{label}: selected @ stack differs from the "
                   f"aggregate by {err:.3g}")
    return out


def check_quorum_contract(gar: str, f: int,
                          history_window: Optional[int] = None
                          ) -> List[str]:
    """The quorum gate raises the one canonical message, and only then.

    For the rule's declared ``min_n(f)``: ``n = min_n - 1`` must raise
    ``ValueError`` with exactly ``"{gar} requires n >= {need} for f={f},
    got n={n}"``, and ``n = min_n`` must pass.

    Args:
      gar: any rule name the resolver accepts.
      f: Byzantine bound to probe.
      history_window: passed to the resolver for buffered rules.

    Returns:
      Violations (empty when both sides of the threshold behave).
    """
    from repro_torch.agg.registry import resolve_rule
    out: List[str] = []
    need = resolve_rule(gar, history_window=history_window).min_n(f)
    short = need - 1
    want = f"{gar} requires n >= {need} for f={f}, got n={short}"
    try:
        check_quorum(gar, short, f, history_window=history_window)
        out.append(f"{gar}: quorum violation n={short} < {need} "
                   f"(f={f}) not rejected")
    except ValueError as e:
        if str(e) != want:
            out.append(f"{gar}: non-canonical quorum message {e!r} "
                       f"(want {want!r})")
    except Exception as e:  # wrong exception type
        out.append(f"{gar}: quorum violation raised {type(e).__name__}, "
                   f"not ValueError")
    try:
        check_quorum(gar, need, f, history_window=history_window)
    except Exception as e:
        out.append(f"{gar}: minimal quorum n={need} (f={f}) wrongly "
                   f"rejected: {e}")
    return out


def check_rule_output(rule: AggregatorRule, gradient, selected,
                      stack: np.ndarray, f: int,
                      label: str = "") -> List[str]:
    """Dispatch every invariant the rule declares against one output.

    Args:
      rule: the resolved rule (its ``invariants`` tuple drives the
        dispatch).
      gradient: ``(d,)`` aggregate the rule returned.
      selected: ``(n,)`` reported selection weights.
      stack: the *effective* ``(n, d)`` stack (:func:`effective_stack`).
      f: Byzantine bound of the call.
      label: case label for violations.

    Returns:
      Concatenated violations of every declared check.
    """
    out: List[str] = []
    if "finite" in rule.invariants:
        out += check_finite(gradient, label)
    if "hull" in rule.invariants:
        out += check_hull(gradient, stack, label)
    if "trimmed" in rule.invariants:
        out += check_trimmed(gradient, stack, f, label)
    if "convex" in rule.invariants:
        out += check_convex(gradient, selected, stack, label)
    w = _f32(selected)
    if (w < -1e-6).any():  # universal, even without "convex"
        out.append(f"{label}: negative selection weight "
                   f"(min {float(w.min()):.3g})")
    return out
