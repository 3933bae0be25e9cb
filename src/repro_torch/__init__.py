"""PyTorch / CUDA port of the Byzantine-robust training stack.

``repro_torch`` mirrors ``repro`` (the JAX reference) module for module:
the same relative paths and public names, so each module's counterpart
is easy to find.  It imports ``torch`` and numpy only.  Entry points
that create tensors take ``device="cuda"`` by default and raise when no
card is present (see :func:`repro_torch.device.resolve_device`); the
kernel wrappers dispatch on the device of the tensor they are given: a
CPU tensor takes the plain PyTorch version, a CUDA tensor the
hand-written kernel in ``repro_torch/csrc``.
"""
