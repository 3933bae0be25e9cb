"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    Args:
      device: ``"cuda"`` (the default everywhere), ``"cpu"`` or a
        ``torch.device``.

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
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
