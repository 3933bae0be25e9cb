"""The train-step metrics schema (counterpart of ``repro/obs/schema.py``).

The flat trainers assemble their metrics through :func:`core_metrics`
and, on the asynchronous path, :func:`async_extras`, so the metric names
are the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.pytree import tree_leaves

__all__ = ["METRIC_SCHEMA", "async_extras", "core_metrics", "global_norm",
           "selection_weight"]

#: canonical metric catalog: name -> (paths, description)
METRIC_SCHEMA: Dict[str, tuple] = {
    "loss": ("all", "mean honest-worker training loss at step start"),
    "byz_weight": ("all", "total selection weight landing on the "
                          "injected Byzantine rows (0 when f == 0)"),
    "agg_dev": ("all", "L2 distance between the emitted aggregate and "
                       "the honest mean (the poisoning-leeway probe)"),
    "grad_norm": ("all", "global L2 norm of the emitted aggregate"),
    "step_scale": ("reputation", "scalar step-size multiplier from "
                                 "carried trust (reputation-* rules "
                                 "with spec.rep_lr set)"),
    "staleness_mean": ("async", "mean per-worker slot age at "
                                "aggregation time"),
    "staleness_max": ("async", "oldest slot age in the aggregated bus"),
    "staleness_excess": ("async", "max overshoot beyond the bounded-"
                                  "staleness bound tau (0 = bound held)"),
    "delivered": ("async", "worker slots refreshed this step"),
}


def global_norm(tree) -> torch.Tensor:
    """Global L2 norm of a parameter dict, accumulated per leaf in fp32.

    Args:
      tree: a tensor or (nested) dict of tensors.

    Returns:
      fp32 scalar ``sqrt(sum_leaves sum(x^2))``.
    """
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        x = leaf.to(torch.float32)
        total = total + torch.sum(x * x)
    return torch.sqrt(total)


def selection_weight(selected: torch.Tensor, n_honest: int) -> torch.Tensor:
    """Total selection weight on the Byzantine rows (``byz_weight``).

    Args:
      selected: ``(n,)`` per-worker selection weights; the injected rows
        come after the ``n_honest`` honest ones.
      n_honest: honest row count.

    Returns:
      The tail sum when Byzantine rows exist, else a float32 zero.
    """
    if selected.shape[0] > n_honest:
        return torch.sum(selected[n_honest:])
    return torch.zeros((), dtype=torch.float32, device=selected.device)


def core_metrics(*, loss, grad_norm, agg_dev, byz_weight,
                 step_scale: Optional[torch.Tensor] = None) -> Dict:
    """Assemble the core metrics dict every train path emits.

    Args:
      loss: scalar training loss.
      grad_norm: scalar aggregate norm.
      agg_dev: scalar aggregate-to-honest-mean deviation.
      byz_weight: scalar Byzantine selection mass.
      step_scale: optional reputation step-size multiplier (``None``
        omits the key).

    Returns:
      Dict with the canonical :data:`METRIC_SCHEMA` names.
    """
    metrics = {"loss": loss, "byz_weight": byz_weight,
               "agg_dev": agg_dev, "grad_norm": grad_norm}
    if step_scale is not None:
        metrics["step_scale"] = step_scale
    if not set(metrics) <= set(METRIC_SCHEMA):
        raise KeyError(f"metrics outside the schema: "
                       f"{sorted(set(metrics) - set(METRIC_SCHEMA))}")
    return metrics


def async_extras(staleness: torch.Tensor, excess: torch.Tensor,
                 deliver: torch.Tensor) -> Dict:
    """The four extra metrics of the asynchronous paths.

    Args:
      staleness: ``(n,)`` int per-worker slot age ``t - bus.versions``.
      excess: ``(n,)`` int overshoot of the staleness bound
        (``repro_torch.dist.async_train.staleness_excess``).
      deliver: ``(n,)`` bool delivery mask of this step.

    Returns:
      Dict with ``staleness_mean`` / ``staleness_max`` /
      ``staleness_excess`` / ``delivered``, fp32 scalars.  The mean is
      the sum times the rounded reciprocal of n, the product XLA runs
      for the reference's ``jnp.mean``.
    """
    s = staleness.to(torch.float32)
    inv_n = torch.tensor(1.0 / s.numel(), dtype=torch.float32,
                         device=s.device)
    return {
        "staleness_mean": torch.sum(s) * inv_n,
        "staleness_max": torch.max(staleness).to(torch.float32),
        "staleness_excess": torch.max(excess).to(torch.float32),
        "delivered": torch.sum(deliver).to(torch.float32),
    }
