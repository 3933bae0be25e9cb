"""Carry parameters across from the JAX reference.

The port's models keep the reference's parameter names and layouts, so a
parameter dict crosses over name for name as numpy arrays: no transpose,
and the flat coordinate order (sorted keys) is the same on both sides.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_jax"]


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
