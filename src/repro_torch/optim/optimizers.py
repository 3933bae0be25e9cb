"""Optimizers and the paper's fading learning-rate schedule (counterpart of
``repro/optim/optimizers.py``).

Each optimizer is an ``Optimizer(init, update)`` pair over parameter
dicts: ``update(grads, state, params) -> (new_params, new_state)``,
functional as in the reference (new tensors, nothing updated in place).
The learning rate is a schedule ``step -> lr`` evaluated on the
optimizer's step count, a Python int.  The paper (§5.1) uses plain SGD
with ``eta(t) = eta0 * r / (t + r)``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

__all__ = ["Optimizer", "adam", "adamw", "fading_lr", "get_optimizer",
           "momentum", "sgd"]

Schedule = Callable[[int], torch.Tensor]

_F32 = torch.float32


def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=_F32)


def fading_lr(eta0: float, r: float) -> Schedule:
    """Paper §5.1: ``eta(t) = eta0 * r / (t + r)``, in float32.

    Args:
      eta0: initial rate.
      r: fading horizon.

    Returns:
      ``step -> 0-d float32 tensor``.
    """
    return lambda step: (torch.tensor(eta0 * r, dtype=_F32)
                         / torch.tensor(float(step), dtype=_F32)
                         .add(torch.tensor(r, dtype=_F32)))


class Optimizer(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (params, state)``."""

    init: Callable[[Any], Any]
    update: Callable[..., Any]


def _tmap(fn, *dicts):
    return {k: fn(*(t[k] for t in dicts)) for k in dicts[0]}


def _on_params(x: torch.Tensor, params) -> torch.Tensor:
    """Move a 0-d schedule value to the device of the parameters."""
    return x.to(next(iter(params.values())).device)


def sgd(lr: Union[float, Schedule]) -> Optimizer:
    """Plain SGD.

    Args:
      lr: rate or schedule.

    Returns:
      The :class:`Optimizer`.
    """
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        eta = _on_params(sched(state["step"]), params)
        new = _tmap(lambda p, g: (p.to(_F32) - eta * g.to(_F32))
                    .to(p.dtype), params, grads)
        return new, {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum(lr: Union[float, Schedule], beta: float = 0.9) -> Optimizer:
    """Heavy-ball momentum.

    Args:
      lr: rate or schedule.
      beta: momentum factor.

    Returns:
      The :class:`Optimizer`.
    """
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0,
                "m": _tmap(lambda p: torch.zeros(p.shape, dtype=_F32,
                                                 device=p.device), params)}

    def update(grads, state, params):
        eta = _on_params(sched(state["step"]), params)
        m = _tmap(lambda m, g: beta * m + g.to(_F32), state["m"], grads)
        new = _tmap(lambda p, m: (p.to(_F32) - eta * m)
                    .to(p.dtype), params, m)
        return new, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam (decoupled weight decay when ``weight_decay`` is set).

    Args:
      lr: rate or schedule.
      b1: first-moment decay.
      b2: second-moment decay.
      eps: denominator floor.
      weight_decay: decoupled decay factor.

    Returns:
      The :class:`Optimizer`.
    """
    sched = _as_schedule(lr)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
        return {"step": 0, "m": _tmap(z, params), "v": _tmap(z, params)}

    def update(grads, state, params):
        t = state["step"] + 1
        eta = _on_params(sched(state["step"]), params)
        m = _tmap(lambda m, g: b1 * m + (1 - b1) * g.to(_F32),
                  state["m"], grads)
        v = _tmap(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(_F32)),
                  state["v"], grads)
        tf = torch.tensor(float(t), dtype=_F32)
        bc1 = _on_params(1 - torch.pow(torch.tensor(b1, dtype=_F32), tf),
                         params)
        bc2 = _on_params(1 - torch.pow(torch.tensor(b2, dtype=_F32), tf),
                         params)

        def upd(p, m, v):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(_F32)
            return (p.to(_F32) - eta * step).to(p.dtype)

        new = _tmap(upd, params, m, v)
        return new, {"step": t, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    """Adam with decoupled weight decay 0.01 by default.

    Args:
      lr: rate or schedule.
      weight_decay: decoupled decay factor.
      **kw: further :func:`adam` arguments.

    Returns:
      The :class:`Optimizer`.
    """
    return adam(lr, weight_decay=weight_decay, **kw)


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    """Optimizer by name.

    Args:
      name: ``"sgd"``, ``"momentum"``, ``"adam"`` or ``"adamw"``.
      lr: rate or schedule.
      **kw: optimizer arguments.

    Returns:
      The :class:`Optimizer`.
    """
    return {"sgd": sgd, "momentum": momentum, "adam": adam,
            "adamw": adamw}[name](lr, **kw)
