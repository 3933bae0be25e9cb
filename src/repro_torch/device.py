"""Device resolution shared by the port's entry points, and the helpers
for the host reads that a ``meta`` dry-run must get past."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["host_index", "host_value", "resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    Args:
      device: ``"cuda"`` (the default everywhere), ``"cpu"``, ``"meta"``
        (shapes only: the launch harness's dry-run asks for it, nothing
        switches to it on its own) or a ``torch.device``.

    Returns:
      The ``torch.device``.  Raises ``RuntimeError`` for a CUDA device
      when no card is present: the port never drops to the CPU unless
      the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(
            f"unsupported device {dev}; use 'cuda', 'cpu' or 'meta'")
    return dev


def host_index(t) -> int:
    """``int(t)``: a value the host reads to pick a row or a coordinate.

    On a ``meta`` tensor (which has no value) it returns the first
    candidate, 0.  That fixed choice is sound for a dry-run because every
    such read in the port picks *which* row or coordinate follows (a
    Bulyan pick, a Krum winner, the attack's ``"top"`` coordinate, a
    random attack's seed): the shapes, the kernel launches and the
    collectives after it are the same whichever one is picked.  The
    launch harness's tests hold exactly that against runs on CPU
    tensors.

    Args:
      t: a 0-d tensor (on any device) or a Python / numpy number.

    Returns:
      The integer.
    """
    if isinstance(t, torch.Tensor) and t.device.type == "meta":
        return 0
    return int(t)


def host_value(t) -> float:
    """``float(t)``, :func:`host_index`'s sibling for a value read to
    rank candidates (the attack's ``"top"`` coordinate): 0.0 on a
    ``meta`` tensor, for the same reason."""
    if isinstance(t, torch.Tensor) and t.device.type == "meta":
        return 0.0
    return float(t)
