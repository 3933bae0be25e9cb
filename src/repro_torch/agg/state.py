"""Explicit aggregation state for stateful rules (counterpart of
``repro/agg/state.py``).

Stateless rules carry no state: the trainers thread an
:class:`AggState` only when ``resolve_rule(gar).stateful`` is True.  The
fields:

* ``step``: a Python int, the number of aggregations absorbed so far
  (the port's optimizers count steps in Python ints too);
* ``history``: the ``buffered-*`` sliding window, one ``(W, n, d)``
  tensor on the dense path, a tuple of ``(W, n, *dims)`` leaves on the
  tree path;
* ``center``: the carried center of ``centered_clip_momentum``, ``(d,)``
  dense or a tuple of ``(*dims,)`` leaves;
* ``bus``: the asynchronous runtime's ``GradientBus``
  (``repro_torch.dist.async_train``), whose slots mirror the template's
  layout;
* ``reputation``: the ``reputation-*`` rules' per-worker fp32 scores,
  initialized to ones (uniform reputation reproduces the base rule
  bitwise);
* ``obs``: the telemetry ring of the ``obs-*`` rules, which are not
  ported yet (ROADMAP item 4); it stays ``()``.

Unused fields stay ``()``.  Rules never update a state in place: each
returns a new :class:`AggState`.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.agg.registry import AggregatorRule
from repro_torch.core.pytree import tree_leaves

__all__ = ["AggState", "init_state"]


class AggState(NamedTuple):
    """Carried state of a stateful aggregation rule.

    step:       aggregations absorbed so far (Python int).
    history:    sliding-window gradient buffer(s), or ``()``.
    center:     momentum-carried center leaves, or ``()``.
    bus:        the asynchronous runtime's ``GradientBus``, or ``()``.
    reputation: per-worker fp32 trust scores in [0, 1], or ``()``.
    obs:        the telemetry ring (not ported; always ``()``).
    """

    step: int = 0
    history: Any = ()
    center: Any = ()
    bus: Any = ()
    reputation: Any = ()
    obs: Any = ()


def init_state(rule: AggregatorRule, template: Any,
               flat: Optional[bool] = None, *,
               rep_dims: Tuple[int, ...] = (),
               device=None) -> AggState:
    """Zero-initialized :class:`AggState` for one rule and gradient shape.

    Args:
      rule: the resolved rule; ``rule.state_fields`` selects the buffers
        and ``rule.history_window`` their window.
      template: the worker-stacked gradients the rule will see: a flat
        ``(n, d)`` tensor (dense path) or a dict / list of ``(n, *dims)``
        leaves (tree path).  Only shapes and dtypes are read, so tensors
        on the ``"meta"`` device work.
      flat: True for the dense layout (single tensors), False for the
        tree layout (tuples of per-leaf tensors); ``None`` infers it: a
        bare tensor means dense.
      rep_dims: trailing dimensions of the ``reputation`` buffer after
        the worker axis (``()`` gives the training layout ``(n,)``).
      device: where the buffers live (default: the template's device).

    Returns:
      An :class:`AggState` with ``step = 0``, fp32 zero buffers for the
      fields in ``rule.state_fields``, a zeroed bus for ``"bus"`` and a
      ones buffer for ``"reputation"``.  Raises ``NotImplementedError``
      for ``"obs"`` (ROADMAP item 4).
    """
    leaves = tree_leaves(template)
    dense = (flat if flat is not None
             else isinstance(template, torch.Tensor))
    dev = torch.device(device) if device is not None else leaves[0].device
    history: Any = ()
    center: Any = ()
    bus: Any = ()
    reputation: Any = ()
    if "obs" in rule.state_fields:
        raise NotImplementedError(
            "the obs- telemetry ring is not ported yet (ROADMAP item 4)")
    if "history" in rule.state_fields:
        w = rule.history_window
        if not w or w < 1:
            raise ValueError(
                f"rule {rule.name!r} needs a positive history_window, "
                f"got {w!r}")
        bufs = [torch.zeros((w,) + tuple(leaf.shape), dtype=torch.float32,
                            device=dev) for leaf in leaves]
        history = bufs[0] if dense else tuple(bufs)
    if "center" in rule.state_fields:
        cs = [torch.zeros(tuple(leaf.shape[1:]), dtype=torch.float32,
                          device=dev) for leaf in leaves]
        center = cs[0] if dense else tuple(cs)
    if "bus" in rule.state_fields:
        from repro_torch.dist.async_train import init_bus
        bus = init_bus(template, device=dev)
    if "reputation" in rule.state_fields:
        n = leaves[0].shape[0]
        reputation = torch.ones((n,) + tuple(rep_dims),
                                dtype=torch.float32, device=dev)
    return AggState(step=0, history=history, center=center, bus=bus,
                    reputation=reputation)
