"""Byzantine distributed-SGD training step (counterpart of the synchronous
flat path of ``repro/training/trainer.py``).

The paper's protocol (§2): each of n - f honest workers computes a
stochastic gradient on its own mini-batch; the omniscient adversary reads
them and appends f Byzantine submissions; the master aggregates the flat
``(n, d)`` stack with a rule from the registry and updates the model.
Per-worker gradients come from ``torch.func.vmap(torch.func.grad(...))``
over a parameter dict.  With a ``fused-<base>`` rule and a CUDA stack the
aggregation runs on the port's CUDA kernels.  Stateful rules wait for a
later slice (the registry raises ``NotImplementedError`` for them).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.agg.specs import AggSpec
from repro_torch.core import attacks as attacks_lib
from repro_torch.core import pytree as pt
from repro_torch.device import resolve_device
from repro_torch.obs.schema import core_metrics, selection_weight
from repro_torch.optim import Optimizer

__all__ = ["ByzantineSpec", "ByzantineTrainer", "byzantine_stack",
           "make_byzantine_step"]

#: the reference's alias of the unified spec
ByzantineSpec = AggSpec

#: attacks that read the training step
_STEP_ATTACKS = (attacks_lib.omniscient_lp, attacks_lib.omniscient_linf)


def byzantine_stack(loss_fn: Callable, spec: AggSpec, params, x, y, *,
                    step: int = 0, attack_on: bool = True,
                    generator: Optional[torch.Generator] = None):
    """The submissions of one step: honest per-worker gradients, then the
    Byzantine rows.

    Args:
      loss_fn: ``loss_fn(params, x, y) -> scalar``.
      spec: protocol spec.
      params: parameter dict.
      x: ``(n_honest, b, ...)`` per-worker inputs.
      y: ``(n_honest, b)`` per-worker labels.
      step: the optimizer's step count (read by the omniscient attacks).
      attack_on: False submits the honest rows only.
      generator: randomness for the attack (none of the ported attacks
        draws any).

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
    byz = attack(flat, spec.f, generator, **kw)
    return torch.cat([flat, byz], dim=0), flat, ctx


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
      (n_honest, b)`` per honest worker; metrics are 0-d tensors.
    """
    spec.validate()
    rule = spec.rule()

    def step(params, opt_state, x, y, generator=None):
        full, flat, ctx = byzantine_stack(
            loss_fn, spec, params, x, y, step=opt_state["step"],
            attack_on=attack_on, generator=generator)
        res = rule.dense_fn(full, spec.f_declared)
        agg = pt.unflatten(res.gradient, ctx)
        new_params, new_state = optimizer.update(agg, opt_state, params)
        honest_mean = torch.mean(flat, dim=0)
        metrics = core_metrics(
            loss=loss_fn(params, x[0], y[0]),
            byz_weight=selection_weight(res.selected, spec.n_honest),
            agg_dev=torch.linalg.vector_norm(res.gradient - honest_mean),
            grad_norm=torch.linalg.vector_norm(res.gradient))
        return new_params, new_state, metrics

    return step


class ByzantineTrainer:
    """Convenience loop: batches -> step -> metrics history.

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
            self.params, self.opt_state, m = fn(
                self.params, self.opt_state,
                torch.as_tensor(x, device=self.device),
                torch.as_tensor(y, device=self.device).long(),
                self.generator)
            rec = {k: float(v) for k, v in m.items()}
            rec["step"] = t
            if eval_fn and eval_every and t % eval_every == 0:
                rec["eval_acc"] = float(eval_fn(self.params))
            self.history.append(rec)
        return self.history
