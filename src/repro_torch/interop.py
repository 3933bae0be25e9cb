"""Carry parameters and carried state across from the JAX reference.

The port's models keep the reference's parameter names and layouts, so a
parameter dict crosses over name for name as numpy arrays: no transpose,
and the flat coordinate order (sorted keys) is the same on both sides.
A telemetry ring crosses over field for field the same way.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["metrics_buffer_from_jax", "params_from_jax"]


def params_from_jax(np_params: Dict[str, Any], device="cuda"
                    ) -> Dict[str, Any]:
    """Copy a dict of numpy arrays into torch tensors.

    Args:
      np_params: parameter dict whose values are numpy arrays (or
        anything ``np.array`` accepts, e.g. the reference's arrays).
      device: target device; ``"cuda"`` raises when no card is present.

    Returns:
      The same dict with ``torch.Tensor`` values on ``device``.
    """
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in np_params.items()}


def metrics_buffer_from_jax(np_buf: Any, device="cuda"):
    """Copy a reference telemetry ring into the port's ``MetricsBuffer``.

    Args:
      np_buf: the reference's ``MetricsBuffer`` with numpy leaves (e.g.
        ``jax.tree_util.tree_map(np.asarray, buf)``): ``cursor``,
        ``records`` (an ``AggDiagnostics`` of ``(capacity, ...)``
        arrays) and ``sel_total``; read by attribute, so no reference
        type is needed here.
      device: target device; ``"cuda"`` raises when no card is present.

    Returns:
      A ``repro_torch.obs.buffer.MetricsBuffer`` with the same cursor
      (a 0-d int32 tensor), ring rows and cumulative selection weight.
    """
    from repro_torch.obs.buffer import AggDiagnostics, MetricsBuffer
    dev = resolve_device(device)

    def tensor(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(dev)

    records = AggDiagnostics(*(
        tensor(getattr(np_buf.records, f), np.float32)
        for f in AggDiagnostics._fields))
    return MetricsBuffer(cursor=tensor(np_buf.cursor, np.int32),
                         records=records,
                         sel_total=tensor(np_buf.sel_total, np.float32))
