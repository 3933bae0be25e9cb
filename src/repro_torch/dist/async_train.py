"""The asynchronous runtime's gradient bus (counterpart of the bus half of
``repro/dist/async_train.py``).

Instead of a synchronous barrier, the master aggregates whatever a
:class:`GradientBus` holds: per-worker gradient slots plus ``(n,)``
int32 ``versions`` (the step each slot's gradient was computed at) and
``arrival_step``.  A delay schedule with per-worker staleness bounds
``tau_w`` decides who delivers at each step: ``"fixed"`` is a staggered
round robin, ``"random"`` a Bernoulli(1 / (tau_w + 1)) draw from a
``torch.Generator`` seeded by ``(seed, step)``, with delivery forced
whenever a slot would exceed its bound.  Both deliver everyone at step
0, so the zero slots never reach an aggregation, and ``tau = 0``
delivers everyone every step (the synchronous special case).

The flat trainer (``repro_torch.training.trainer
.make_async_byzantine_step``) drives the bus.  The sharded asynchronous
train step, ``make_async_train_step``, waits for the multi-rank runtime
(ROADMAP item 6).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves, tree_unflatten

__all__ = ["GradientBus", "delivery_mask", "init_bus", "resolve_tau",
           "staleness_excess", "update_bus"]


class GradientBus(NamedTuple):
    """Per-worker versioned gradient slots.

    grads:        ``(n, d)`` tensor (flat path) or a tree of
                  ``(n, *dims)`` leaves: worker w's row holds the
                  gradient it last delivered.
    versions:     ``(n,)`` int32, the compute step of each slot.
    arrival_step: ``(n,)`` int32, the step each slot was last written.
    """

    grads: Any
    versions: torch.Tensor
    arrival_step: torch.Tensor


def init_bus(template: Any, device=None) -> GradientBus:
    """Zeroed :class:`GradientBus` sized from a worker-stacked template.

    Args:
      template: a ``(n, d)`` tensor or a dict / list of ``(n, *dims)``
        leaves; only shapes and dtypes are read (``"meta"`` tensors
        work).
      device: where the slots live (default: the template's device).

    Returns:
      A bus whose zero slots mirror the template's structure and dtypes,
      with ``versions = arrival_step = 0``.
    """
    leaves = tree_leaves(template)
    if not leaves:
        raise ValueError("empty bus template")
    dev = torch.device(device) if device is not None else leaves[0].device
    n = leaves[0].shape[0]
    grads = tree_unflatten(template, [
        torch.zeros(tuple(l.shape), dtype=l.dtype, device=dev)
        for l in leaves])
    return GradientBus(grads=grads,
                       versions=torch.zeros((n,), dtype=torch.int32,
                                            device=dev),
                       arrival_step=torch.zeros((n,), dtype=torch.int32,
                                                device=dev))


def resolve_tau(tau: Any, n: int, device=None) -> torch.Tensor:
    """Normalize a staleness bound to a per-worker ``(n,)`` int32 tensor.

    Args:
      tau: a non-negative int, or a length-n sequence of per-worker
        bounds.
      n: worker count.
      device: where the tensor lives (default: the CPU).

    Returns:
      ``(n,)`` int32 bounds.  Raises ``ValueError`` for a negative bound
      or a sequence of the wrong length, with the reference's texts.
    """
    if isinstance(tau, int):
        if tau < 0:
            raise ValueError(f"async_tau must be >= 0, got {tau}")
        return torch.full((n,), tau, dtype=torch.int32, device=device)
    arr = np.asarray(tau, dtype=np.int32)
    if arr.ndim == 0:
        arr = np.full((n,), int(arr), np.int32)
    if arr.shape != (n,):
        raise ValueError(
            f"per-worker async_tau needs shape ({n},), got {arr.shape}")
    if (arr < 0).any():
        raise ValueError(f"async_tau must be >= 0, got {tau!r}")
    return torch.as_tensor(arr, device=device)


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator whose stream depends on ``(seed, step)`` only, so a
    step's draw does not depend on the steps before it."""
    key = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device).manual_seed(key)


def delivery_mask(step: int, versions: torch.Tensor, tau: torch.Tensor,
                  schedule: str = "fixed", seed: int = 0) -> torch.Tensor:
    """Arrival mask of one asynchronous step.

    Args:
      step: the global asynchronous step.
      versions: ``(n,)`` int32 slot versions (the ``random`` schedule
        forces delivery where ``step - versions >= tau``).
      tau: ``(n,)`` int32 bounds (:func:`resolve_tau`).
      schedule: ``"fixed"``: worker w delivers when
        ``(step - w mod (tau_w + 1)) % (tau_w + 1) == 0``;
        ``"random"``: Bernoulli(1 / (tau_w + 1)) from a generator seeded
        by ``(seed, step)``.
      seed: seed of the ``random`` schedule.

    Returns:
      ``(n,)`` bool, True where the worker delivers; all True at step 0
      and under ``tau = 0``.
    """
    n = versions.shape[0]
    step = int(step)
    tau = tau.to(versions.device)
    cycle = tau + 1
    if schedule == "fixed":
        phase = torch.arange(n, dtype=torch.int32,
                             device=versions.device) % cycle
        mask = (step - phase) % cycle == 0
    elif schedule == "random":
        r = torch.rand((n,), generator=_step_generator(
            seed, step, versions.device), device=versions.device)
        mask = (r * cycle.to(torch.float32) < 1.0) | (
            (step - versions) >= tau)
    else:
        raise ValueError(
            f"async_schedule must be 'fixed' or 'random', got "
            f"{schedule!r}")
    return mask | (step == 0)


def update_bus(bus: GradientBus, grads: Any, step: int,
               deliver: torch.Tensor) -> GradientBus:
    """Write the delivering workers' fresh gradients into their slots.

    Args:
      bus: the current bus.
      grads: fresh gradients, same structure as ``bus.grads``.
      step: the global step, stamped on every delivered slot.
      deliver: ``(n,)`` bool arrival mask.

    Returns:
      A new bus: delivered rows replaced (by a select, so an all-True
      mask gives ``grads`` exactly), the rest untouched.
    """
    def sel(old, new):
        m = deliver.reshape(tuple(deliver.shape) + (1,) * (new.ndim - 1))
        return torch.where(m, new.to(old.dtype), old)

    olds = tree_leaves(bus.grads)
    news = tree_leaves(grads)
    stamp = torch.full_like(bus.versions, int(step))
    return GradientBus(
        grads=tree_unflatten(bus.grads,
                             [sel(o, g) for o, g in zip(olds, news)]),
        versions=torch.where(deliver, stamp, bus.versions),
        arrival_step=torch.where(deliver, stamp, bus.arrival_step))


def staleness_excess(bus: GradientBus, step: int,
                     tau: torch.Tensor) -> torch.Tensor:
    """Per-worker overshoot of the declared staleness bound.

    Args:
      bus: the bus after this step's update.
      step: the global step it was updated at.
      tau: ``(n,)`` int32 bounds.

    Returns:
      ``(n,)`` int32 ``max(0, (step - versions) - tau)``: 0 everywhere
      while the bound holds.
    """
    return torch.clamp_min((int(step) - bus.versions)
                           - tau.to(bus.versions.device), 0)
