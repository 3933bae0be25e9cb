"""The aggregation-rule registry (counterpart of ``repro/agg/registry.py``).

Every rule is one :class:`AggregatorRule` record resolved through one
string resolver, :func:`resolve_rule`, with two paths:

* the **dense** path calls ``rule.dense_fn(grads, f)`` on a flat
  ``(n, d)`` matrix;
* the **tree** path calls ``rule.tree_fn(ctx)`` with a
  :class:`TreeContext` built by the tree engine
  (``repro_torch.dist.robust.distributed_aggregate``).

Plain names hit the static table that ``repro_torch.core.gars`` fills
(their tree implementations come from ``repro_torch.agg.tree``);
``"bulyan-<base>"`` wraps a base in Bulyan's two phases and
``"fused-<base>"`` lowers a base onto the CUDA aggregation kernels
(``repro_torch.agg.fused``).  The stateful, asynchronous, reputation and
telemetry families of the reference are not ported yet and raise
``NotImplementedError``; unknown names raise the reference's
``KeyError``.  Resolved composites are cached.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

__all__ = ["AggregatorRule", "TreeAgg", "TreeContext", "quorum",
           "register_rule", "register_tree_impl", "resolve_rule"]

#: composite prefixes of the reference that this slice does not port
_NOT_PORTED_PREFIXES = ("buffered", "stale-", "reputation-", "obs-")

#: plain rules of the reference that this slice does not port
_NOT_PORTED_RULES = ("brute", "centered_clip", "centered_clip_momentum")


class TreeAgg(NamedTuple):
    """Output of one tree-path rule application.

    leaves:    aggregated per-parameter leaves in the compute dtype (the
               engine casts them back to the input dtypes).
    selected:  (n,) worker weights in the output (diagnostic).
    scores:    (n,) per-worker rule scores (lower = better), or zeros.
    """

    leaves: List[torch.Tensor]
    selected: torch.Tensor
    scores: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TreeContext:
    """Everything a tree-path rule may consume, prepared by the engine.

    The engine (``repro_torch.dist.robust.distributed_aggregate``) owns
    the distance-backend dispatch and the windowed coordinate phase and
    hands them to rules through this context, so rule bodies stay
    backend-agnostic.

    Args:
      leaves: tuple of ``(n, *dims)`` worker-stacked gradient leaves in
        their input dtypes, in the reference's leaf order (sorted keys).
      n: worker count.
      f: Byzantine bound.
      cdt: compute dtype (fp32 by default).
      make_dists: maps a leaves sequence to the ``(n, n)``
        squared-distance matrix through the configured backend.
      coordinate_phase: ``(stack, f) -> agg``, the engine's windowed
        Bulyan phase 2.
    """

    leaves: Tuple[torch.Tensor, ...]
    n: int
    f: int
    cdt: Any
    make_dists: Callable[[Sequence[torch.Tensor]], torch.Tensor]
    coordinate_phase: Callable[[torch.Tensor, int], torch.Tensor]

    def dists(self) -> torch.Tensor:
        """``(n, n)`` squared distances over the concatenated coordinate
        space of this context's leaves, in ``cdt``."""
        return self.make_dists(self.leaves)

    def uniform(self) -> torch.Tensor:
        """Uniform ``(n,)`` selection weights ``1/n`` in ``cdt``."""
        return torch.full((self.n,), 1.0 / self.n, dtype=self.cdt,
                          device=self.leaves[0].device)

    def zeros(self) -> torch.Tensor:
        """All-zero ``(n,)`` score vector in ``cdt``."""
        return torch.zeros((self.n,), dtype=self.cdt,
                           device=self.leaves[0].device)

    def take_worker(self, i) -> List[torch.Tensor]:
        """One worker's row of every leaf.

        Args:
          i: worker index (int or 0-d tensor).

        Returns:
          List of ``(*dims,)`` leaves in ``cdt``.
        """
        return [leaf[i].to(self.cdt) for leaf in self.leaves]

    def weighted_sum(self, weights: torch.Tensor) -> List[torch.Tensor]:
        """Per-leaf ``<weights, workers>`` contraction.

        Args:
          weights: ``(n,)`` worker weights.

        Returns:
          List of ``(*dims,)`` combined leaves in ``cdt``.
        """
        w = weights.to(self.cdt)
        return [torch.tensordot(w, leaf.to(self.cdt), dims=([0], [0]))
                for leaf in self.leaves]


@dataclasses.dataclass
class AggregatorRule:
    """One registered aggregation rule (dense + tree implementations).

    name:       canonical registry key (e.g. ``"krum"``).
    min_n:      minimal worker count as a function of f (paper §2.3/§4).
    dense_fn:   flat-path callable ``(grads: (n, d), f) -> AggResult``.
    tree_fn:    tree-path callable ``(ctx: TreeContext) -> TreeAgg``;
                ``None`` when the rule has no distributed form.
    byzantine_resilient: True when proven (alpha, f)-resilient.
    invariants: declared output invariants (see the reference).
    doc:        one-line human description.
    """

    name: str
    min_n: Callable[[int], int]
    dense_fn: Optional[Callable] = None
    tree_fn: Optional[Callable] = None
    byzantine_resilient: bool = True
    invariants: Tuple[str, ...] = ("finite", "hull")
    doc: str = ""


#: name -> AggregatorRule for every statically registered rule
RULES: Dict[str, AggregatorRule] = {}

#: tree implementations, attached to their rule whichever side
#: registers first
_TREE_IMPLS: Dict[str, Callable] = {}

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
            tree_fn=_TREE_IMPLS.get(name),
            byzantine_resilient=byzantine_resilient, invariants=invariants,
            doc=doc or (fn.__doc__ or "").strip().split("\n")[0])
        return fn
    return deco


def register_tree_impl(name: str):
    """Decorator attaching a tree-path implementation to a rule.

    Order-independent with respect to the dense side: an implementation
    that arrives before its rule is parked and attached on registration.

    Args:
      name: key of the rule the implementation belongs to.

    Returns:
      A decorator that records the function as ``tree_fn`` and returns
      it unchanged.
    """
    def deco(fn):
        _TREE_IMPLS[name] = fn
        if name in RULES:
            RULES[name].tree_fn = fn
        return fn
    return deco


def _populate() -> None:
    """Import the modules whose import side effect fills the registry."""
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    import repro_torch.core.gars  # noqa: F401  dense rules
    import repro_torch.agg.tree   # noqa: F401  tree-path implementations


def _bulyan_rule(name: str) -> AggregatorRule:
    from functools import partial

    from repro_torch.agg.tree import bulyan_tree
    from repro_torch.core.bulyan import make_bulyan
    base = name.split("-", 1)[1] if "-" in name else "krum"
    return AggregatorRule(
        name=name, min_n=lambda f: 4 * f + 3, dense_fn=make_bulyan(base),
        tree_fn=partial(bulyan_tree, base=base),
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
