"""The aggregation-rule registry (counterpart of ``repro/agg/registry.py``).

Every rule is one :class:`AggregatorRule` record resolved through one
string resolver, :func:`resolve_rule`.  This slice of the port carries
the flat dense path only: ``rule.dense_fn(grads, f)`` on an ``(n, d)``
matrix.  Plain names hit the static table that ``repro_torch.core.gars``
fills; ``"bulyan-<base>"`` wraps a base in Bulyan's two phases and
``"fused-<base>"`` lowers a base onto the CUDA aggregation kernels
(``repro_torch.agg.fused``).  The stateful, asynchronous, reputation and
telemetry families of the reference are not ported yet and raise
``NotImplementedError``; unknown names raise the reference's
``KeyError``.  Resolved composites are cached.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = ["AggregatorRule", "quorum", "register_rule", "resolve_rule"]

#: composite prefixes of the reference that this slice does not port
_NOT_PORTED_PREFIXES = ("buffered", "stale-", "reputation-", "obs-")

#: plain rules of the reference that this slice does not port
_NOT_PORTED_RULES = ("brute", "centered_clip", "centered_clip_momentum")


@dataclasses.dataclass
class AggregatorRule:
    """One registered aggregation rule.

    name:       canonical registry key (e.g. ``"krum"``).
    min_n:      minimal worker count as a function of f (paper §2.3/§4).
    dense_fn:   flat-path callable ``(grads: (n, d), f) -> AggResult``.
    byzantine_resilient: True when proven (alpha, f)-resilient.
    invariants: declared output invariants (see the reference).
    doc:        one-line human description.
    """

    name: str
    min_n: Callable[[int], int]
    dense_fn: Optional[Callable] = None
    byzantine_resilient: bool = True
    invariants: Tuple[str, ...] = ("finite", "hull")
    doc: str = ""


#: name -> AggregatorRule for every statically registered rule
RULES: Dict[str, AggregatorRule] = {}

#: name -> AggregatorRule cache for resolved composites
_COMPOSITES: Dict[str, AggregatorRule] = {}

_POPULATED = False


def register_rule(name: str, *, min_n: Callable[[int], int],
                  byzantine_resilient: bool = True,
                  invariants: Tuple[str, ...] = ("finite", "hull"),
                  doc: str = ""):
    """Decorator registering a dense-path rule implementation.

    Args:
      name: registry key; must be unique.
      min_n: minimal worker count as a function of f.
      byzantine_resilient: True when the rule is proven resilient.
      invariants: declared output invariants.
      doc: one-line description for listings.

    Returns:
      A decorator that records the function as ``dense_fn`` and returns
      it unchanged.
    """
    def deco(fn):
        if name in RULES:
            raise ValueError(f"rule {name!r} registered twice")
        RULES[name] = AggregatorRule(
            name=name, min_n=min_n, dense_fn=fn,
            byzantine_resilient=byzantine_resilient, invariants=invariants,
            doc=doc or (fn.__doc__ or "").strip().split("\n")[0])
        return fn
    return deco


def _populate() -> None:
    """Import the module whose import side effect fills the registry."""
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    import repro_torch.core.gars  # noqa: F401  dense rules


def _bulyan_rule(name: str) -> AggregatorRule:
    from repro_torch.core.bulyan import make_bulyan
    base = name.split("-", 1)[1] if "-" in name else "krum"
    return AggregatorRule(
        name=name, min_n=lambda f: 4 * f + 3, dense_fn=make_bulyan(base),
        byzantine_resilient=True, invariants=("finite", "hull"),
        doc=f"Bulyan({base}) — recursive selection + trimmed "
            f"coordinate phase")


def resolve_rule(name: str) -> AggregatorRule:
    """Resolve a rule name to its :class:`AggregatorRule` record.

    Args:
      name: a registered key, ``"bulyan-<base>"`` or ``"fused-<base>"``.

    Returns:
      The resolved :class:`AggregatorRule`.  Raises ``KeyError`` for an
      unknown name, with the reference's text, and
      ``NotImplementedError`` for a family the port does not carry yet.
    """
    _populate()
    if name in RULES:
        return RULES[name]
    if name in _COMPOSITES:
        return _COMPOSITES[name]
    if name in _NOT_PORTED_RULES or name.startswith(_NOT_PORTED_PREFIXES):
        raise NotImplementedError(f"rule {name!r} is not ported yet")
    if name.startswith("bulyan"):
        rule = _bulyan_rule(name)
    elif name.startswith("fused-"):
        from repro_torch.agg.fused import make_fused
        rule = make_fused(name)
    else:
        raise KeyError(
            f"unknown GAR {name!r}; have {sorted(RULES)} plus "
            f"'bulyan-<base>', 'buffered-<base>', 'stale-<base>', "
            f"'fused-<base>', 'reputation-<base>' and 'obs-<base>'")
    _COMPOSITES[name] = rule
    return rule


def quorum(name: str, f: int) -> int:
    """Minimal worker count for a rule at a given Byzantine bound.

    Args:
      name: any name :func:`resolve_rule` accepts.
      f: Byzantine bound.

    Returns:
      The smallest n the rule supports for this f.
    """
    return resolve_rule(name).min_n(f)
