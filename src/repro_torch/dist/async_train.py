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
.make_async_byzantine_step``) drives the bus, and so does
:func:`make_async_train_step`, the asynchronous form of
``repro_torch.dist.train.make_train_step`` over the model zoo, on one
device or on every rank of a mesh (``mesh=``: the bus then holds this
rank's ``gram_pspec`` slices of every worker's row).  The delay
schedule binds only the honest workers: under an attack the last f
deliver every step with a fresh version.  At ``async_tau = 0`` the
step reproduces the synchronous one bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves, tree_unflatten

__all__ = ["GradientBus", "delivery_mask", "init_async_state", "init_bus",
           "make_async_train_step", "resolve_tau", "staleness_excess",
           "update_bus"]


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
    step's draw does not depend on the steps before it (``None`` on the
    ``meta`` device, where a trace draws without one)."""
    if torch.device(device).type == "meta":
        return None
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


def init_async_state(spec, params: Any, n_workers: int, mesh=None):
    """Zeroed ``AggState`` carrying the bus for the asynchronous step.

    The asynchronous step always carries a state, since the bus is the
    asynchrony: a stateful rule gets its own buffers beside the bus, a
    plain rule only ``step`` and the bus.

    Args:
      spec: the protocol spec (``gar`` / ``history_window`` select the
        rule).
      params: the parameter tree; only shapes and dtypes are read (under
        a mesh, the global tree: ``"meta"`` tensors work).
      n_workers: worker count, the leading axis of the bus slots.
      mesh: the step's mesh, or ``None``.

    Returns:
      An ``AggState`` whose bus holds zero ``(n_workers, *dims)`` slots
      in the parameters' dtypes (under a mesh, this rank's
      ``gram_pspec`` slices), with ``step = versions = 0``.
    """
    from repro_torch.agg.state import AggState, init_state
    from repro_torch.dist.train import _state_template
    rule = spec.rule()
    template, dev = _state_template(params, n_workers, mesh)
    if rule.stateful:
        state = init_state(rule, template, flat=False, device=dev)
    else:
        state = AggState(step=0)
    if state.bus == ():
        state = state._replace(bus=init_bus(template, device=dev))
    return state


def make_async_train_step(cfg, spec, optimizer, impl: str = "auto",
                          mesh=None, worker_chunk: Optional[int] = None,
                          template=None) -> Callable:
    """Build the asynchronous Byzantine train step over the model zoo.

    Per step all n workers compute fresh gradients at the current
    parameters; under an attack the last f rows are overwritten (the
    delay attacks ``stale_replay`` / ``slow_drift`` also read their
    previous slots); the delay schedule decides who delivers (the
    Byzantine rows always do); the bus absorbs the deliveries and the
    rule aggregates the slot stack.  With ``spec.async_tau = 0`` this
    reproduces ``repro_torch.dist.train.make_train_step`` bit for bit.

    Args:
      cfg: the model configuration.
      spec: the protocol spec; ``async_tau`` / ``async_schedule`` on top
        of the synchronous fields.
      optimizer: the port's optimizer.
      impl: attention path of the forward.
      mesh: ``None`` or this rank's mesh, as in
        ``repro_torch.dist.train.make_train_step``.
      worker_chunk: workers per ``vmap`` pass (under a mesh with a
        ``model`` or ``pod`` axis ``None`` or 1).
      template: with a mesh, the global parameter tree (shapes only).

    Returns:
      ``step(params, opt_state, batch, agg_state) -> (params, opt_state,
      metrics, agg_state)``, ``agg_state`` from :func:`init_async_state`;
      the metrics add ``staleness_mean`` / ``staleness_max`` /
      ``staleness_excess`` / ``delivered``.
    """
    from repro_torch.dist.robust import distributed_aggregate
    from repro_torch.dist.train import (_MeshLayout, _finish,
                                        _reputation_tail, _submissions,
                                        make_loss_fn)
    from repro_torch.obs.schema import async_extras
    loss_fn = make_loss_fn(cfg, impl)
    rule = spec.rule()
    stateful = rule.stateful
    reputed = "reputation" in rule.state_fields
    layout = (None if mesh is None
              else _MeshLayout(mesh, template, worker_chunk))

    def step(params, opt_state, batch, agg_state):
        n = batch["tokens"].shape[0]
        spec.validate(n, distributed=True)
        n_h = n - spec.f
        t = agg_state.step
        attacked = spec.attack != "none" and spec.f > 0
        prev = None
        if attacked and spec.attack in ("stale_replay", "slow_drift"):
            prev = tree_unflatten(agg_state.bus.grads, [
                l[n_h:] for l in tree_leaves(agg_state.bus.grads)])
        losses, grads = _submissions(
            loss_fn, spec, params, batch, opt_state["step"], t,
            worker_chunk, layout, prev=prev)
        versions = agg_state.bus.versions
        tau = resolve_tau(spec.async_tau, n, device=versions.device)
        deliver = delivery_mask(t, versions, tau,
                                schedule=spec.async_schedule, seed=spec.seed)
        if attacked:
            # Byzantine workers control their own arrival: they deliver
            # every step, stamping a fresh version on adversarial content
            deliver = deliver | (torch.arange(n, device=deliver.device)
                                 >= n_h)
        bus = update_bus(agg_state.bus, grads, t, deliver)
        state_in = agg_state._replace(bus=bus)
        out = distributed_aggregate(
            bus.grads, spec.f_declared, spec.effective_gar,
            agg_dtype=spec.agg_dtype,
            distance_backend=spec.distance_backend, mesh=mesh,
            state=state_in if stateful else None,
            history_window=spec.history_window,
            rep_lr=spec.rep_lr, rep_decay=spec.rep_decay,
            specs=None if layout is None else layout.gram_specs)
        if stateful:
            agg, res, new_state = out
        else:
            agg, res = out
            new_state = state_in._replace(step=t + 1)
        step_scale = None
        if reputed:
            # the clean-batch scores read the slot stack, what was
            # aggregated
            new_state, agg, step_scale = _reputation_tail(
                spec, loss_fn, params, bus.grads, agg, res, agg_state,
                new_state, layout)
        staleness = t - bus.versions
        extra = async_extras(staleness, staleness_excess(bus, t, tau),
                             deliver)
        return _finish(optimizer, params, opt_state, agg, bus.grads, losses,
                       res, n_h, step_scale, layout,
                       extra=extra) + (new_state,)

    return step
