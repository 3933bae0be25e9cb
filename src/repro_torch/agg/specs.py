"""The Byzantine-protocol spec and the shared quorum check.

Counterpart of ``repro/agg/specs.py``, carrying the fields the flat
synchronous trainer and the tree engine (``repro_torch.dist.robust``)
read.  Message texts are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.agg.registry import resolve_rule

__all__ = ["AggSpec", "check_quorum"]


@dataclasses.dataclass(frozen=True, kw_only=True)
class AggSpec:
    """Static configuration of the Byzantine training protocol.

    ``f`` is both the number of injected Byzantine workers and the bound
    the aggregation rule defends against (``declared_f`` overrides the
    latter).  ``agg_dtype`` and ``distance_backend`` are the tree
    engine's accumulation dtype and distance backend, read by
    :meth:`aggregate_tree` (the flat trainer aggregates one stacked
    matrix and reads neither).  The
    reference's fields for the stateful, asynchronous, reputation,
    telemetry and sharded paths come with those paths.
    """

    f: int
    n_workers: Optional[int] = None
    gar: str = "bulyan-krum"
    attack: str = "none"
    attack_kwargs: tuple = ()          # (("gamma", 10.0), ...)
    declared_f: Optional[int] = None   # f the master *assumes* (>= actual)
    agg_dtype: str = "native"          # native | float32 | bfloat16
    distance_backend: str = "auto"     # auto | xla | pallas | fused

    @property
    def n_honest(self) -> int:
        """Honest worker count (requires ``n_workers``)."""
        if self.n_workers is None:
            raise ValueError("n_honest needs n_workers set on the spec")
        return self.n_workers - self.f

    @property
    def f_declared(self) -> int:
        """The bound the master aggregates with (defaults to ``f``)."""
        return self.declared_f if self.declared_f is not None else self.f

    def rule(self):
        """Resolve this spec's GAR through the registry.

        Returns:
          The resolved ``AggregatorRule``.
        """
        return resolve_rule(self.gar)

    def aggregate_tree(self, tree, *, window: Optional[int] = None):
        """Aggregate a worker-stacked gradient tree under this spec.

        The call the reference's distributed trainer makes:
        ``distributed_aggregate`` with this spec's ``gar``, declared
        ``f``, ``agg_dtype`` and ``distance_backend``.

        Args:
          tree: dict (or list, or one tensor) of ``(n, *dims)`` leaves.
          window: coordinate-phase window of the bulyan rules.

        Returns:
          ``(aggregated tree, DistAggResult)``.
        """
        from repro_torch.dist.robust import distributed_aggregate
        return distributed_aggregate(
            tree, self.f_declared, self.gar, agg_dtype=self.agg_dtype,
            window=window, distance_backend=self.distance_backend)

    def validate(self) -> None:
        """Quorum-check this spec against ``n_workers``.

        Returns:
          None.  Raises ``KeyError`` / ``ValueError`` with the
          reference's texts.
        """
        if self.n_workers is None:
            raise ValueError(
                "validate() needs n_workers — set it on the spec or pass "
                "it explicitly")
        check_quorum(self.gar, self.n_workers, self.f_declared)


def check_quorum(gar: str, n: int, f: int, *, distributed: bool = False,
                 history_window: Optional[int] = None) -> None:
    """The one quorum check every layer shares.

    Args:
      gar: rule name (unknown names raise the registry's ``KeyError``).
      n: worker count.
      f: declared Byzantine bound.
      distributed: when True, additionally require a tree-path
        implementation (distributed Bulyan supports only the
        distance-only bases krum/geomed), raising ``KeyError``.
      history_window: the ``buffered-*`` window of the reference's
        resolver; those rules are not ported, so it changes nothing yet.

    Returns:
      None.  Raises ``ValueError`` as ``"{gar} requires n >= {need} for
      f={f}, got n={n}"`` when the quorum is violated.
    """
    del history_window
    # the port's resolver refuses Bulyan over other bases outright (not
    # ported), so the reference's distributed-path error comes first
    is_bulyan = gar.startswith("bulyan") or "-bulyan" in gar
    if distributed and is_bulyan and gar.rsplit("-", 1)[-1] not in (
            "bulyan", "krum", "geomed"):
        raise KeyError(
            f"distributed bulyan needs a distance-only base "
            f"(krum/geomed), got {gar!r}")
    rule = resolve_rule(gar)
    if distributed and rule.tree_fn is None:
        raise KeyError(f"{gar!r} has no distributed (tree) implementation")
    need = rule.min_n(f)
    if n < need:
        raise ValueError(
            f"{gar} requires n >= {need} for f={f}, got n={n}")
