"""Carry parameters and carried state across from the JAX reference.

The port's models keep the reference's parameter names and layouts, so a
parameter tree crosses over name for name as numpy arrays: no transpose,
and the flat coordinate order (sorted keys, depth first) is the same on
both sides.
A telemetry ring crosses over field for field the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["metrics_buffer_from_jax", "params_from_jax"]


def _leaf_from_numpy(v: Any, dev: torch.device) -> torch.Tensor:
    arr = np.array(v, copy=True)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (the reference's comes from
        # ml_dtypes): carry the bits across as int16 and reinterpret
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def params_from_jax(np_params: Any, device="cuda") -> Any:
    """Copy a (nested) dict of numpy arrays into torch tensors.

    Args:
      np_params: parameter tree whose leaves are numpy arrays (or
        anything ``np.array`` accepts, e.g. the reference's arrays):
        flat dicts, the model zoo's nested dicts with period-stacked
        leaves, lists and tuples.  bfloat16 leaves (``ml_dtypes``) keep
        their bits.
      device: target device; ``"cuda"`` raises when no card is present.

    Returns:
      The same structure with ``torch.Tensor`` leaves on ``device``.
    """
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return _leaf_from_numpy(t, dev)

    return conv(np_params)


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
