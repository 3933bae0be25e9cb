"""The aggregation-rule registry (counterpart of ``repro/agg/registry.py``).

Every rule is one :class:`AggregatorRule` record resolved through one
string resolver, :func:`resolve_rule`, with two paths:

* the **dense** path calls ``rule.dense_fn(grads, f)`` on a flat
  ``(n, d)`` matrix (``(grads, f, state) -> (AggResult, state)`` for a
  stateful rule);
* the **tree** path calls ``rule.tree_fn(ctx)`` with a
  :class:`TreeContext` built by the tree engine
  (``repro_torch.dist.robust.distributed_aggregate``; ``(ctx, state)``
  for a stateful rule).

Plain names hit the static table that ``repro_torch.core.gars`` and
``repro_torch.agg.buffered`` fill (their tree implementations come from
``repro_torch.agg.tree``).  Composite families resolve on demand:
``"bulyan-<base>"`` wraps a base in Bulyan's two phases,
``"fused-<base>"`` lowers a base onto the CUDA aggregation kernels
(``repro_torch.agg.fused``), ``"buffered-<base>"`` feeds the base the
means of a per-worker history window (``repro_torch.agg.buffered``),
``"stale[-inv|-exp]-<base>"`` scales the stack by per-worker staleness
read from the carried gradient bus (``repro_torch.agg.staleness``) and
``"reputation-<base>"`` blends it by carried trust scores
(``repro_torch.agg.reputation``), and ``"obs-<base>"`` records per-call
aggregation forensics into the carried state with the base's data path
untouched (``repro_torch.obs.forensics``).  Unknown names raise the
reference's ``KeyError``.  Resolved composites are cached on
``(name, history_window, rep_lr, rep_decay)``.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.device import host_index

__all__ = ["DEFAULT_HISTORY_WINDOW", "AggregatorRule", "TreeAgg",
           "TreeContext", "quorum", "register_rule", "register_tree_impl",
           "resolve_rule", "rule_names"]

#: default sliding-window length of the ``buffered-*`` family
DEFAULT_HISTORY_WINDOW = 4


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
      reduce: maps per-leaf partial reductions over coordinates to their
        total over the whole coordinate space (``None``: their sum in
        leaf order; under a mesh the engine all-reduces the slices').
      sketch: under a mesh's ``model`` axis, ``(leaves, agg_leaves) ->
        (numels, windows)``: each whole leaf's per-worker coordinate
        count and the fp32 ``(n + 1, size)`` values (the workers' rows,
        then the aggregate's) of its telemetry window
        (``repro_torch.obs.forensics.sketch_spans``), gathered from the
        ranks' slices, the same on every rank (``None``: the leaves are
        whole).
    """

    leaves: Tuple[torch.Tensor, ...]
    n: int
    f: int
    cdt: Any
    make_dists: Callable[[Sequence[torch.Tensor]], torch.Tensor]
    coordinate_phase: Callable[[torch.Tensor, int], torch.Tensor]
    reduce: Optional[Callable[[Sequence[torch.Tensor]], torch.Tensor]] = None
    sketch: Optional[Callable] = None

    def dists(self) -> torch.Tensor:
        """``(n, n)`` squared distances over the concatenated coordinate
        space of this context's leaves, in ``cdt``."""
        return self.make_dists(self.leaves)

    def with_leaves(self, leaves: Sequence[torch.Tensor]) -> "TreeContext":
        """A copy of this context over other leaves of the same shapes.

        Args:
          leaves: replacement worker-stacked leaves, same order.

        Returns:
          A new :class:`TreeContext`; ``dists()`` recomputes over the
          new leaves through the same backend closure.
        """
        return dataclasses.replace(self, leaves=tuple(leaves))

    def total(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The total over the whole coordinate space of per-leaf partial
        reductions (``parts[k]`` from leaf ``k``), through ``reduce``."""
        # imported here: ``repro_torch.core`` imports this module
        from repro_torch.core.pytree import sum_in_order
        return (self.reduce or sum_in_order)(parts)

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
        i = host_index(i)
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
    dense_fn:   flat-path callable ``(grads: (n, d), f) -> AggResult``
                (stateful: ``(grads, f, state) -> (AggResult, state)``).
    tree_fn:    tree-path callable ``(ctx: TreeContext) -> TreeAgg``
                (stateful: ``(ctx, state) -> (TreeAgg, state)``);
                ``None`` when the rule has no distributed form.
    byzantine_resilient: True when proven (alpha, f)-resilient.
    stateful:   True when the rule threads an ``AggState``.
    state_fields: the ``AggState`` fields the rule uses, outermost
                wrapper first.
    history_window: sliding-window length of history-buffered rules.
    invariants: declared output invariants (see the reference).
    obs_capacity: ring rows ``init_state`` allocates for the telemetry
                ``MetricsBuffer``; set only by the ``obs-<base>`` family
                (``repro_torch.obs.forensics``), ``None`` otherwise.
    doc:        one-line human description.
    """

    name: str
    min_n: Callable[[int], int]
    dense_fn: Optional[Callable] = None
    tree_fn: Optional[Callable] = None
    byzantine_resilient: bool = True
    stateful: bool = False
    state_fields: Tuple[str, ...] = ()
    history_window: Optional[int] = None
    invariants: Tuple[str, ...] = ("finite", "hull")
    obs_capacity: Optional[int] = None
    doc: str = ""

    @property
    def fn(self) -> Callable:
        """The dense-path callable under the historic ``GarSpec.fn`` name."""
        return self.dense_fn


#: name -> AggregatorRule for every statically registered rule
RULES: Dict[str, AggregatorRule] = {}

#: tree implementations, attached to their rule whichever side
#: registers first
_TREE_IMPLS: Dict[str, Callable] = {}

#: (name, history_window, rep_lr, rep_decay) -> AggregatorRule cache for
#: resolved composites
_COMPOSITES: Dict[Tuple[str, int, float, float], AggregatorRule] = {}

_POPULATED = False


def register_rule(name: str, *, min_n: Callable[[int], int],
                  byzantine_resilient: bool = True, stateful: bool = False,
                  state_fields: Tuple[str, ...] = (),
                  invariants: Tuple[str, ...] = ("finite", "hull"),
                  doc: str = ""):
    """Decorator registering a dense-path rule implementation.

    Args:
      name: registry key; must be unique.
      min_n: minimal worker count as a function of f.
      byzantine_resilient: True when the rule is proven resilient.
      stateful: True when the dense fn threads an ``AggState``.
      state_fields: the ``AggState`` fields the rule uses.
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
            byzantine_resilient=byzantine_resilient, stateful=stateful,
            state_fields=state_fields, invariants=invariants,
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
    import repro_torch.core.gars     # noqa: F401  dense rules
    import repro_torch.agg.tree      # noqa: F401  tree-path implementations
    import repro_torch.agg.buffered  # noqa: F401  stateful rules


def _bulyan_rule(name: str) -> AggregatorRule:
    from functools import partial

    from repro_torch.agg.tree import bulyan_tree
    from repro_torch.core.bulyan import make_bulyan
    base = name.split("-", 1)[1] if "-" in name else "krum"
    # the tree path's phase 1 works from distances alone, so only the
    # distance-only bases get a tree implementation
    tree_fn = (partial(bulyan_tree, base=base)
               if base in ("krum", "geomed") else None)
    return AggregatorRule(
        name=name, min_n=lambda f: 4 * f + 3, dense_fn=make_bulyan(base),
        tree_fn=tree_fn, byzantine_resilient=True,
        invariants=("finite", "hull"),
        doc=f"Bulyan({base}) — recursive selection + trimmed "
            f"coordinate phase")


def _buffered_rule(name: str, window: int) -> AggregatorRule:
    from repro_torch.agg.buffered import make_buffered
    base = name.split("-", 1)[1] if "-" in name else "cwmed"
    base_rule = resolve_rule(base)
    if base_rule.stateful:
        raise KeyError(
            f"buffered-* needs a stateless base rule, got {base!r}")
    return make_buffered(name, base_rule, window)


def _stale_rule(name: str, window: int, rep_lr: float,
                rep_decay: float) -> AggregatorRule:
    from repro_torch.agg.staleness import make_stale
    rest = name.split("-", 1)[1]
    weight = "inv"
    head = rest.split("-", 1)[0]
    if head in ("inv", "exp") and "-" in rest:
        weight, rest = rest.split("-", 1)
    # the reputation schedule passes through, so "stale-reputation-<base>"
    # resolves its inner composite with the caller's parameters
    base_rule = resolve_rule(rest, history_window=window, rep_lr=rep_lr,
                             rep_decay=rep_decay)
    if "bus" in base_rule.state_fields:
        raise KeyError(
            f"stale-* cannot nest another stale rule, got {rest!r}")
    return make_stale(name, base_rule, weight=weight)


def _reputation_rule(name: str, window: int, rep_lr: float,
                     rep_decay: float) -> AggregatorRule:
    from repro_torch.agg.reputation import make_reputation
    rest = name.split("-", 1)[1]
    base_rule = resolve_rule(rest, history_window=window, rep_lr=rep_lr,
                             rep_decay=rep_decay)
    if "reputation" in base_rule.state_fields:
        raise KeyError(
            f"reputation-* cannot nest another reputation rule, "
            f"got {rest!r}")
    return make_reputation(name, base_rule, rep_lr=rep_lr,
                           rep_decay=rep_decay)


def _obs_rule(name: str, window: int, rep_lr: float,
              rep_decay: float) -> AggregatorRule:
    from repro_torch.obs.forensics import make_obs
    rest = name.split("-", 1)[1]
    base_rule = resolve_rule(rest, history_window=window, rep_lr=rep_lr,
                             rep_decay=rep_decay)
    if "obs" in base_rule.state_fields:
        raise KeyError(
            f"obs-* cannot nest another obs rule, got {rest!r}")
    return make_obs(name, base_rule)


def resolve_rule(name: str, history_window: Optional[int] = None,
                 rep_lr: Optional[float] = None,
                 rep_decay: Optional[float] = None) -> AggregatorRule:
    """Resolve a rule name to its :class:`AggregatorRule` record.

    Args:
      name: a registered key, ``"bulyan-<base>"``, ``"buffered-<base>"``,
        ``"stale[-inv|-exp]-<base>"``, ``"reputation-<base>"``,
        ``"fused-<base>"`` or ``"obs-<base>"``; bases nest, e.g.
        ``"stale-fused-bulyan-krum"``, ``"stale-reputation-krum"`` or
        ``"obs-stale-reputation-krum"``.
      history_window: window of ``buffered-*`` rules (``None`` =
        :data:`DEFAULT_HISTORY_WINDOW`; passed through wrapper prefixes).
      rep_lr: EMA rate of ``reputation-*`` rules (``None`` =
        ``repro_torch.agg.reputation.DEFAULT_REP_LR``).
      rep_decay: forgetting factor of ``reputation-*`` rules (``None`` =
        ``DEFAULT_REP_DECAY``).

    Returns:
      The resolved :class:`AggregatorRule`.  Raises ``KeyError`` for an
      unknown name or a forbidden nesting, with the reference's texts.
    """
    _populate()
    if name in RULES:
        return RULES[name]
    from repro_torch.agg.reputation import DEFAULT_REP_DECAY, DEFAULT_REP_LR
    window = (DEFAULT_HISTORY_WINDOW if history_window is None
              else int(history_window))
    lr = DEFAULT_REP_LR if rep_lr is None else float(rep_lr)
    decay = DEFAULT_REP_DECAY if rep_decay is None else float(rep_decay)
    key = (name, window, lr, decay)
    if key in _COMPOSITES:
        return _COMPOSITES[key]
    if name.startswith("bulyan"):
        rule = _bulyan_rule(name)
    elif name.startswith("buffered"):
        rule = _buffered_rule(name, window)
    elif name.startswith("stale-"):
        # exact prefix: a dash-less "stale..." typo falls through to the
        # unknown-name error
        rule = _stale_rule(name, window, lr, decay)
    elif name.startswith("reputation-"):
        rule = _reputation_rule(name, window, lr, decay)
    elif name.startswith("obs-"):
        rule = _obs_rule(name, window, lr, decay)
    elif name.startswith("fused-"):
        from repro_torch.agg.fused import make_fused
        rule = make_fused(name)
    else:
        raise KeyError(
            f"unknown GAR {name!r}; have {sorted(RULES)} plus "
            f"'bulyan-<base>', 'buffered-<base>', 'stale-<base>', "
            f"'fused-<base>', 'reputation-<base>' and 'obs-<base>'")
    _COMPOSITES[key] = rule
    return rule


def rule_names() -> List[str]:
    """Names of every statically registered rule (composites excluded).

    Returns:
      Sorted registry keys; the composite families resolve on top of
      these through :func:`resolve_rule`.
    """
    _populate()
    return sorted(RULES)


def quorum(name: str, f: int) -> int:
    """Minimal worker count for a rule at a given Byzantine bound.

    Args:
      name: any name :func:`resolve_rule` accepts.
      f: Byzantine bound.

    Returns:
      The smallest n the rule supports for this f.
    """
    return resolve_rule(name).min_n(f)
