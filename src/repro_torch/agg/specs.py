"""The Byzantine-protocol spec and the shared quorum check.

Counterpart of ``repro/agg/specs.py``, carrying the fields the flat
trainers (synchronous and asynchronous) and the tree engine
(``repro_torch.dist.robust``) read.  Message texts are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.agg.registry import resolve_rule

__all__ = ["AggSpec", "check_quorum"]


@dataclasses.dataclass(frozen=True, kw_only=True)
class AggSpec:
    """Static configuration of the Byzantine training protocol.

    ``f`` is both the number of injected Byzantine workers and the bound
    the aggregation rule defends against (``declared_f`` overrides the
    latter).  ``agg_dtype`` and ``distance_backend`` are the tree
    engine's accumulation dtype and distance backend, read by
    :meth:`aggregate_tree` (the flat trainers aggregate one stacked
    matrix and read neither).

    The stateful and asynchronous fields, as in the reference:
      history_window: window of ``buffered-*`` rules.
      seed: seed of the ``random`` delay schedule.
      async_tau / async_schedule: the asynchronous trainer's bounded
        staleness (an int, or one bound per worker) and delay schedule
        (``"fixed"`` staggered round-robin | ``"random"``).
        ``async_tau=0`` reproduces the synchronous step exactly.
      rep_lr / rep_decay: the ``reputation-*`` schedule (``None`` takes
        the defaults); a set ``rep_lr`` also scales the update by
        ``step_size_multiplier``.
      aux_batch: optional ``(inputs, labels)`` clean batch; when set and
        the rule carries reputation, the trainers score agreement
        against its gradient instead of the aggregate.  Excluded from
        equality.
      telemetry: when True every layer resolves the GAR through
        ``effective_gar`` (the ``obs-<gar>`` forensics wrapper,
        ``repro_torch.obs``), so the carried ``AggState.obs`` ring
        records per-worker diagnostics each step.  The data path is the
        same either way, bit for bit; attacks keep targeting the raw
        ``gar`` name.

    The serving fields, as in the reference:
      speculative_k: the serving engine's verify-block length (0: the
        per-token path; 1: the speculative machinery with no draft,
        the per-token stream bit for bit; ``k > 1``: a draft replica
        proposes ``k - 1`` tokens per step).
      draft_replica: the ensemble row whose parameters the draft reads.
    """

    f: int
    n_workers: Optional[int] = None
    gar: str = "bulyan-krum"
    attack: str = "none"
    attack_kwargs: tuple = ()          # (("gamma", 10.0), ...)
    declared_f: Optional[int] = None   # f the master *assumes* (>= actual)
    agg_dtype: str = "native"          # native | float32 | bfloat16
    distance_backend: str = "auto"     # auto | xla | pallas | fused
    history_window: int = 4            # buffered-* window length
    seed: int = 0
    async_tau: "int | tuple" = 0       # bounded staleness (scalar or per-worker)
    async_schedule: str = "fixed"      # fixed | random
    speculative_k: int = 0             # verify-block length (0/1 = per-token)
    draft_replica: int = 0             # ensemble row the draft model reads
    rep_lr: Optional[float] = None     # reputation-* EMA rate (None=default)
    rep_decay: Optional[float] = None  # reputation-* forgetting factor
    telemetry: bool = False            # aggregate through obs-<gar>
    aux_batch: Any = dataclasses.field(default=None, compare=False)

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

    @property
    def effective_gar(self) -> str:
        """The GAR name the runtime aggregates with.

        ``gar`` itself normally; with ``telemetry=True`` the idempotent
        ``obs-<gar>`` forensics wrapper, whose data path is the base
        rule's bit for bit.  The attacks keep reading the raw ``gar``:
        the attacker targets the defense, not its instrumentation.
        """
        if not self.telemetry:
            return self.gar
        from repro_torch.obs.forensics import obs_name
        return obs_name(self.gar)

    def rule(self):
        """Resolve this spec's GAR through the registry.

        Returns:
          The resolved ``AggregatorRule`` of ``effective_gar`` (with this
          spec's ``history_window`` and reputation schedule).
        """
        return resolve_rule(self.effective_gar,
                            history_window=self.history_window,
                            rep_lr=self.rep_lr, rep_decay=self.rep_decay)

    def aggregate_tree(self, tree, *, window: Optional[int] = None,
                       state=None):
        """Aggregate a worker-stacked gradient tree under this spec.

        The call the reference's distributed trainer makes:
        ``distributed_aggregate`` with this spec's ``effective_gar``,
        declared ``f``, ``agg_dtype``, ``distance_backend`` and
        stateful-rule parameters.

        Args:
          tree: dict (or list, or one tensor) of ``(n, *dims)`` leaves.
          window: coordinate-phase window of the bulyan rules.
          state: carried ``AggState`` of a stateful rule.

        Returns:
          ``(aggregated tree, DistAggResult)``, plus the new state for a
          stateful rule.
        """
        from repro_torch.dist.robust import distributed_aggregate
        return distributed_aggregate(
            tree, self.f_declared, self.effective_gar,
            agg_dtype=self.agg_dtype,
            window=window, distance_backend=self.distance_backend,
            state=state, history_window=self.history_window,
            rep_lr=self.rep_lr, rep_decay=self.rep_decay)

    def validate(self, n_workers: Optional[int] = None, *,
                 distributed: bool = False) -> None:
        """Quorum-check this spec.

        Args:
          n_workers: worker count to check (``None``: ``n_workers``).
          distributed: also require a tree-path implementation.

        Returns:
          None.  Raises ``KeyError`` / ``ValueError`` with the
          reference's texts.
        """
        n = self.n_workers if n_workers is None else n_workers
        if n is None:
            raise ValueError(
                "validate() needs n_workers — set it on the spec or pass "
                "it explicitly")
        check_quorum(self.effective_gar, n, self.f_declared,
                     distributed=distributed,
                     history_window=self.history_window)


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
      history_window: passed to ``resolve_rule`` for ``buffered-*``
        rules.

    Returns:
      None.  Raises ``ValueError`` as ``"{gar} requires n >= {need} for
      f={f}, got n={n}"`` when the quorum is violated.
    """
    rule = resolve_rule(gar, history_window=history_window)
    if distributed and rule.tree_fn is None:
        if gar.startswith("bulyan") or "-bulyan" in gar:
            raise KeyError(
                f"distributed bulyan needs a distance-only base "
                f"(krum/geomed), got {gar!r}")
        raise KeyError(f"{gar!r} has no distributed (tree) implementation")
    need = rule.min_n(f)
    if n < need:
        raise ValueError(
            f"{gar} requires n >= {need} for f={f}, got n={n}")
