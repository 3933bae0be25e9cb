"""Byzantine distributed-SGD training (counterpart of the flat paths of
``repro/training/trainer.py``).

The paper's protocol (§2): each of n - f honest workers computes a
stochastic gradient on its own mini-batch; the omniscient adversary reads
them and appends f Byzantine submissions; the master aggregates the flat
``(n, d)`` stack with a rule from the registry and updates the model.
Per-worker gradients come from ``torch.func.vmap(torch.func.grad(...))``
over a parameter dict.  With a ``fused-<base>`` rule (alone or under a
``stale-`` / ``buffered-`` / ``reputation-`` wrapper) and a CUDA stack,
the aggregation runs on the port's CUDA kernels.

A stateful rule threads an explicit ``AggState`` through the step and
the trainer loop.  The asynchronous flat path
(:func:`make_async_byzantine_step`, :class:`AsyncByzantineTrainer`)
drops the per-step barrier: submissions live in a ``GradientBus``
(``repro_torch.dist.async_train``), a delay schedule decides who
delivers, and the rule aggregates the slot stack.  With
``spec.async_tau = 0`` it reproduces the synchronous step exactly.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.agg.reputation import (DEFAULT_REP_DECAY, DEFAULT_REP_LR,
                                        reputation_scores,
                                        step_size_multiplier,
                                        update_reputation)
from repro_torch.agg.specs import AggSpec
from repro_torch.agg.state import AggState, init_state
from repro_torch.core import attacks as attacks_lib
from repro_torch.core import pytree as pt
from repro_torch.device import resolve_device
from repro_torch.dist.async_train import (delivery_mask, init_bus,
                                          resolve_tau, staleness_excess,
                                          update_bus)
from repro_torch.obs.schema import (async_extras, core_metrics,
                                    selection_weight)
from repro_torch.optim import Optimizer

__all__ = ["AsyncByzantineTrainer", "ByzantineSpec", "ByzantineTrainer",
           "byzantine_stack", "init_flat_agg_state", "init_flat_async_state",
           "make_async_byzantine_step", "make_byzantine_step"]

#: the reference's alias of the unified spec
ByzantineSpec = AggSpec

#: attacks that read the optimizer's step
_STEP_ATTACKS = (attacks_lib.omniscient_lp, attacks_lib.omniscient_linf,
                 attacks_lib.reputation_burn)

#: attacks that read their previous bus rows and the bus step
_DELAY_ATTACKS = (attacks_lib.stale_replay, attacks_lib.slow_drift)


def _attack_rows(spec: AggSpec) -> int:
    """Rows of the stacked matrix: n under attack, n_honest clean."""
    return (spec.n_workers if spec.f > 0 and spec.attack != "none"
            else spec.n_honest)


def _template(params, n_rows: int) -> torch.Tensor:
    """A shape-only ``(n_rows, d)`` fp32 template of the flat stack."""
    d = sum(math.prod(p.shape) for p in pt.tree_leaves(params))
    return torch.empty((n_rows, d), dtype=torch.float32, device="meta")


def _params_device(params) -> torch.device:
    return pt.tree_leaves(params)[0].device


def init_flat_agg_state(spec: AggSpec, params,
                        n_rows: Optional[int] = None,
                        device=None) -> Optional[AggState]:
    """Zeroed ``AggState`` for a stateful rule on the flat path.

    Args:
      spec: protocol spec (``n_workers`` set).
      params: parameter dict; only the total coordinate count is read.
      n_rows: rows of the stacked matrix (``None``: n under attack,
        n_honest clean).
      device: where the buffers live (default: the parameters').

    Returns:
      An ``AggState`` sized for the ``(n_rows, d)`` stack, or ``None``
      for a stateless rule.
    """
    rule = spec.rule()
    if not rule.stateful:
        return None
    rows = _attack_rows(spec) if n_rows is None else n_rows
    return init_state(rule, _template(params, rows), flat=True,
                      device=device or _params_device(params))


def _flat_grad(loss_fn: Callable, params, batch, device) -> torch.Tensor:
    """The ``(d,)`` gradient of one clean batch, in ``stack_flatten``'s
    coordinate order."""
    x = torch.as_tensor(batch[0], device=device)
    y = torch.as_tensor(batch[1], device=device).long()
    grads = torch.func.grad(loss_fn)(params, x, y)
    return pt.stack_flatten({k: v[None] for k, v in grads.items()})[0][0]


def byzantine_stack(loss_fn: Callable, spec: AggSpec, params, x, y, *,
                    step: int = 0, attack_on: bool = True,
                    generator: Optional[torch.Generator] = None,
                    attack_kw: Optional[dict] = None):
    """The submissions of one step: honest per-worker gradients, then the
    Byzantine rows.

    Args:
      loss_fn: ``loss_fn(params, x, y) -> scalar``.
      spec: protocol spec.
      params: parameter dict.
      x: ``(n_honest, b, ...)`` per-worker inputs.
      y: ``(n_honest, b)`` per-worker labels.
      step: the optimizer's step count (read by the omniscient attacks
        and ``reputation_burn``).
      attack_on: False submits the honest rows only.
      generator: randomness of the attack.
      attack_kw: defaults for the attack's keywords beneath the spec's
        (the asynchronous step passes the delay attacks' ``prev`` and
        ``step``).

    Returns:
      ``(full, flat, ctx)``: the ``(n, d)`` stack, its ``(n_honest, d)``
      honest part and the :func:`repro_torch.core.pytree.unflatten`
      context.
    """
    per_worker = torch.func.vmap(torch.func.grad(loss_fn),
                                 in_dims=(None, 0, 0))
    flat, ctx = pt.stack_flatten(per_worker(params, x, y))
    attack = attacks_lib.get_attack(spec.attack) if attack_on else None
    if attack is None or spec.f <= 0:
        return flat, flat, ctx
    kw = dict(spec.attack_kwargs)
    if attack in _STEP_ATTACKS:
        kw.setdefault("step", step)
    for k, v in (attack_kw or {}).items():
        kw.setdefault(k, v)
    byz = attack(flat, spec.f, generator, **kw)
    return torch.cat([flat, byz], dim=0), flat, ctx


def _reputation_tail(spec: AggSpec, loss_fn, params, stack, rep_prev,
                     state, grad_out):
    """The reputation rules' trainer-side tail: re-score against the
    clean auxiliary batch when one is set (overriding the rule's own
    update), and scale the update by ``step_size_multiplier`` when
    ``spec.rep_lr`` is set.  Returns ``(state, grad_out, step_scale)``."""
    step_scale = torch.ones((), dtype=torch.float32, device=stack.device)
    if spec.aux_batch is not None:
        target = _flat_grad(loss_fn, params, spec.aux_batch, stack.device)
        lr = DEFAULT_REP_LR if spec.rep_lr is None else spec.rep_lr
        decay = (DEFAULT_REP_DECAY if spec.rep_decay is None
                 else spec.rep_decay)
        state = state._replace(reputation=update_reputation(
            rep_prev, reputation_scores(stack, target), lr, decay))
    if spec.rep_lr:
        step_scale = step_size_multiplier(state)
        grad_out = grad_out * step_scale
    return state, grad_out, step_scale


def make_byzantine_step(loss_fn: Callable, optimizer: Optimizer,
                        spec: ByzantineSpec,
                        attack_on: bool = True) -> Callable:
    """Build one training step.

    Args:
      loss_fn: ``loss_fn(params, x, y) -> scalar loss``.
      optimizer: the port's optimizer.
      spec: protocol spec (``n_workers`` set).
      attack_on: False builds the clean step.

    Returns:
      ``step(params, opt_state, x, y, generator=None) -> (params,
      opt_state, metrics)`` with ``x (n_honest, b, ...)``, ``y
      (n_honest, b)`` per honest worker; metrics are 0-d tensors.  A
      stateful rule takes and returns its ``AggState`` as well:
      ``step(params, opt_state, x, y, generator, agg_state) -> (params,
      opt_state, metrics, agg_state)``.
    """
    spec.validate()
    rule = spec.rule()
    reputed = "reputation" in rule.state_fields

    def run_step(params, opt_state, x, y, generator, agg_state):
        full, flat, ctx = byzantine_stack(
            loss_fn, spec, params, x, y, step=opt_state["step"],
            attack_on=attack_on, generator=generator)
        rep_prev = agg_state.reputation if reputed else None
        if rule.stateful:
            res, agg_state = rule.dense_fn(full, spec.f_declared, agg_state)
        else:
            res = rule.dense_fn(full, spec.f_declared)
        grad_out = res.gradient
        step_scale = None
        if reputed:
            agg_state, grad_out, step_scale = _reputation_tail(
                spec, loss_fn, params, full, rep_prev, agg_state, grad_out)
        agg = pt.unflatten(grad_out, ctx)
        new_params, new_state = optimizer.update(agg, opt_state, params)
        honest_mean = torch.mean(flat, dim=0)
        metrics = core_metrics(
            loss=loss_fn(params, x[0], y[0]),
            byz_weight=selection_weight(res.selected, spec.n_honest),
            agg_dev=torch.linalg.vector_norm(res.gradient - honest_mean),
            grad_norm=torch.linalg.vector_norm(res.gradient),
            step_scale=step_scale)
        return new_params, new_state, metrics, agg_state

    if rule.stateful:
        return run_step

    def step(params, opt_state, x, y, generator=None):
        return run_step(params, opt_state, x, y, generator, None)[:3]

    return step


class ByzantineTrainer:
    """Convenience loop: batches -> step -> metrics history.

    A stateful rule's ``AggState`` is owned by the trainer
    (``self.agg_state``) and carried across ``run`` calls.  When
    ``attack_until`` switches from n rows to n_honest, the row-count
    dependent buffers (the history window, the reputation scores)
    restart; the clipping center survives.

    Args:
      loss_fn: ``loss_fn(params, x, y) -> scalar``.
      params: initial parameter dict (moved to ``device``).
      optimizer: the port's optimizer.
      spec: protocol spec.
      seed: seed of the trainer's ``torch.Generator``.
      device: ``"cuda"`` (default; raises when no card is present) or
        ``"cpu"``.
    """

    def __init__(self, loss_fn, params, optimizer: Optimizer,
                 spec: ByzantineSpec, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.spec = spec
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.optimizer = optimizer
        self.opt_state = optimizer.init(self.params)
        self._rule = spec.rule()
        self._stateful = self._rule.stateful
        self._attack_mode = spec.f > 0 and spec.attack != "none"
        self.agg_state = init_flat_agg_state(spec, self.params)
        self._step_attacked = make_byzantine_step(loss_fn, optimizer, spec,
                                                  attack_on=True)
        self._step_clean = make_byzantine_step(loss_fn, optimizer, spec,
                                               attack_on=False)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.history: list = []

    def run(self, batcher, n_steps: int, attack_until: Optional[int] = None,
            eval_fn: Optional[Callable] = None, eval_every: int = 0,
            start_step: int = 0):
        """Run ``n_steps`` steps.

        Args:
          batcher: per-honest-worker batch source (``batcher.batch(t)``
            returning numpy arrays).
          n_steps: steps to run.
          attack_until: step from which the protocol runs clean
            (``None`` = attacked throughout).
          eval_fn: optional ``params -> accuracy`` probe.
          eval_every: evaluation period (0 = never).
          start_step: first step index.

        Returns:
          The accumulated history: one dict of floats per step.
        """
        for t in range(start_step, start_step + n_steps):
            x, y = batcher.batch(t)
            attacked = (attack_until is None) or (t < attack_until)
            use_attack = (attacked and self.spec.f > 0
                          and self.spec.attack != "none")
            fn = self._step_attacked if use_attack else self._step_clean
            if self._stateful and use_attack != self._attack_mode:
                self._attack_mode = use_attack
                if {"history", "reputation"} & set(self._rule.state_fields):
                    rows = (self.spec.n_workers if use_attack
                            else self.spec.n_honest)
                    self.agg_state = init_flat_agg_state(
                        self.spec, self.params, n_rows=rows)
            args = (self.params, self.opt_state,
                    torch.as_tensor(x, device=self.device),
                    torch.as_tensor(y, device=self.device).long(),
                    self.generator)
            if self._stateful:
                self.params, self.opt_state, m, self.agg_state = fn(
                    *args, self.agg_state)
            else:
                self.params, self.opt_state, m = fn(*args)
            self._record(m, t, eval_fn, eval_every)
        return self.history

    def _record(self, m, t, eval_fn, eval_every) -> None:
        rec = {k: float(v) for k, v in m.items()}
        rec["step"] = t
        if eval_fn and eval_every and t % eval_every == 0:
            rec["eval_acc"] = float(eval_fn(self.params))
        self.history.append(rec)

    def telemetry(self):
        """The aggregation-forensics ring of the ``obs-`` rules, which
        are not ported yet: raises ``NotImplementedError`` (ROADMAP
        item 4)."""
        raise NotImplementedError(
            "telemetry needs the obs- rules, which are not ported yet "
            "(ROADMAP item 4)")


# ---------------------------------------------------------------------------
# the asynchronous flat path (a GradientBus over the (n, d) matrix)
# ---------------------------------------------------------------------------

def init_flat_async_state(spec: AggSpec, params,
                          n_rows: Optional[int] = None,
                          device=None) -> AggState:
    """Zeroed bus-carrying ``AggState`` for the flat asynchronous path.

    Never ``None``: the bus itself is the asynchrony, so a stateless
    rule gets ``step`` and the bus, a stateful one its buffers too.

    Args:
      spec: protocol spec (``n_workers`` set).
      params: parameter dict; only the total coordinate count is read.
      n_rows: rows of the stack and the bus (``None``: n under attack,
        n_honest clean).
      device: where the buffers live (default: the parameters').

    Returns:
      An ``AggState`` whose ``bus`` holds a zero ``(n_rows, d)`` slot
      matrix, with ``step = 0`` and zero versions.
    """
    rule = spec.rule()
    rows = _attack_rows(spec) if n_rows is None else n_rows
    template = _template(params, rows)
    dev = device or _params_device(params)
    if rule.stateful:
        state = init_state(rule, template, flat=True, device=dev)
    else:
        state = AggState(step=0)
    if "bus" not in rule.state_fields:
        state = state._replace(bus=init_bus(template, device=dev))
    return state


def make_async_byzantine_step(loss_fn: Callable, optimizer: Optimizer,
                              spec: AggSpec) -> Callable:
    """Build the asynchronous flat training step.

    Every worker computes a fresh gradient, the last f rows are
    rewritten by the attack (``stale_replay`` / ``slow_drift`` read
    their previous bus rows), the delay schedule (``spec.async_tau``,
    ``spec.async_schedule``) decides which honest workers deliver (the
    Byzantine rows always do), and the rule aggregates the slot stack.

    Args:
      loss_fn: ``loss_fn(params, x, y) -> scalar``.
      optimizer: the port's optimizer.
      spec: protocol spec (``n_workers`` set).

    Returns:
      ``step(params, opt_state, x, y, generator, agg_state) -> (params,
      opt_state, metrics, agg_state)``; size the state with
      :func:`init_flat_async_state`.  With ``spec.async_tau = 0`` the
      step reproduces :func:`make_byzantine_step` bitwise.
    """
    spec.validate()
    rule = spec.rule()
    reputed = "reputation" in rule.state_fields
    attack = attacks_lib.get_attack(spec.attack)
    attacked = attack is not None and spec.f > 0
    n_h = spec.n_honest

    def step(params, opt_state, x, y, generator, agg_state):
        t = agg_state.step
        attack_kw = ({"prev": agg_state.bus.grads[n_h:], "step": t}
                     if attack in _DELAY_ATTACKS else None)
        full, _, ctx = byzantine_stack(
            loss_fn, spec, params, x, y, step=opt_state["step"],
            generator=generator, attack_kw=attack_kw)
        n_eff = full.shape[0]
        tau = resolve_tau(spec.async_tau, n_eff, device=full.device)
        deliver = delivery_mask(t, agg_state.bus.versions, tau,
                                schedule=spec.async_schedule,
                                seed=spec.seed)
        if attacked:
            deliver = deliver | (torch.arange(n_eff, device=full.device)
                                 >= n_h)
        bus = update_bus(agg_state.bus, full, t, deliver)
        state_in = agg_state._replace(bus=bus)

        rep_prev = agg_state.reputation if reputed else None
        if rule.stateful:
            res, new_state = rule.dense_fn(bus.grads, spec.f_declared,
                                           state_in)
        else:
            res = rule.dense_fn(bus.grads, spec.f_declared)
            new_state = state_in._replace(step=t + 1)
        grad_out = res.gradient
        step_scale = None
        if reputed:
            new_state, grad_out, step_scale = _reputation_tail(
                spec, loss_fn, params, bus.grads, rep_prev, new_state,
                grad_out)
        agg = pt.unflatten(grad_out, ctx)
        new_params, new_opt = optimizer.update(agg, opt_state, params)

        honest_mean = torch.mean(bus.grads[:n_h], dim=0)
        metrics = core_metrics(
            loss=loss_fn(params, x[0], y[0]),
            byz_weight=selection_weight(res.selected, n_h),
            agg_dev=torch.linalg.vector_norm(res.gradient - honest_mean),
            grad_norm=torch.linalg.vector_norm(res.gradient),
            step_scale=step_scale)
        metrics.update(async_extras(t - bus.versions,
                                    staleness_excess(bus, t, tau),
                                    deliver))
        return new_params, new_opt, metrics, new_state

    return step


class AsyncByzantineTrainer(ByzantineTrainer):
    """Convenience loop of the asynchronous flat path.

    The trainer owns the carried ``AggState`` (``self.agg_state``), whose
    ``bus`` holds every worker's versioned slot.  There is no
    ``attack_until``: the bus's row count is fixed at construction (n
    under attack, n_honest clean).

    Args:
      loss_fn: ``loss_fn(params, x, y) -> scalar``.
      params: initial parameter dict (moved to ``device``).
      optimizer: the port's optimizer.
      spec: protocol spec; ``async_tau``, ``async_schedule`` and
        ``seed`` set the delay schedule.
      seed: seed of the trainer's ``torch.Generator``.
      device: ``"cuda"`` (default; raises when no card is present) or
        ``"cpu"``.
    """

    def __init__(self, loss_fn, params, optimizer: Optimizer,
                 spec: AggSpec, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.spec = spec
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.optimizer = optimizer
        self.opt_state = optimizer.init(self.params)
        self.agg_state = init_flat_async_state(spec, self.params)
        self._step = make_async_byzantine_step(loss_fn, optimizer, spec)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.history: list = []

    def run(self, batcher, n_steps: int,
            eval_fn: Optional[Callable] = None, eval_every: int = 0,
            start_step: int = 0):
        """Run ``n_steps`` asynchronous steps.

        Args:
          batcher: per-honest-worker batch source (``batcher.batch(t)``).
          n_steps: steps to run.
          eval_fn: optional ``params -> accuracy`` probe.
          eval_every: evaluation period (0 = never).
          start_step: first step index.

        Returns:
          The accumulated history: one dict of floats per step.
        """
        for t in range(start_step, start_step + n_steps):
            x, y = batcher.batch(t)
            (self.params, self.opt_state, m,
             self.agg_state) = self._step(
                 self.params, self.opt_state,
                 torch.as_tensor(x, device=self.device),
                 torch.as_tensor(y, device=self.device).long(),
                 self.generator, self.agg_state)
            self._record(m, t, eval_fn, eval_every)
        return self.history
