"""The Byzantine-protocol spec and the shared quorum check.

Counterpart of ``repro/agg/specs.py``, carrying the fields the flat
synchronous trainer reads.  Message texts are the reference's.
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
    latter).  The reference's fields for the stateful, asynchronous,
    reputation, telemetry and sharded paths come with those paths.
    """

    f: int
    n_workers: Optional[int] = None
    gar: str = "bulyan-krum"
    attack: str = "none"
    attack_kwargs: tuple = ()          # (("gamma", 10.0), ...)
    declared_f: Optional[int] = None   # f the master *assumes* (>= actual)

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


def check_quorum(gar: str, n: int, f: int) -> None:
    """The one quorum check every layer shares.

    Args:
      gar: rule name (unknown names raise the registry's ``KeyError``).
      n: worker count.
      f: declared Byzantine bound.

    Returns:
      None.  Raises ``ValueError`` as ``"{gar} requires n >= {need} for
      f={f}, got n={n}"`` when the quorum is violated.
    """
    need = resolve_rule(gar).min_n(f)
    if n < need:
        raise ValueError(
            f"{gar} requires n >= {need} for f={f}, got n={n}")
