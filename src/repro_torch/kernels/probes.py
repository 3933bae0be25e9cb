"""fp32-accumulation contract probes for the kernel layer.

Counterpart of ``repro/kernels/probes.py``.  Every kernel of the port
promises the reference's numeric contract: inputs may stream from device
memory in their own dtype (bf16 at production scale), but accumulation
happens in fp32 and the result is fp32.  A kernel that accumulated in
bf16 would pass shape checks and most value tests at small d, and
quietly widen the leeway the paper bounds, because distance-based
selection would then run on distances whose error grows with d.

Each probe feeds a kernel a low-precision worker stack and compares it
with the fp32 oracle run on the identical quantized values, so the only
admissible difference is summation order and the relative error bound
stays tight however large d grows.  Inputs come from a seeded
``torch.Generator`` on ``device``, which defaults to ``"cuda"``: there
the kernels run; on ``"cpu"`` the wrappers take their plain versions.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bulyan_select import bulyan_select
from repro_torch.kernels.pairwise_gram import pairwise_gram
from repro_torch.kernels.ref import pairwise_gram_ref

__all__ = ["coord_fp32_contract_error", "fused_fp32_contract_error",
           "gram_fp32_contract_error"]

Device = Union[str, torch.device]


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(torch.max(torch.abs(want.to(torch.float32)))) or 1.0
    return float(torch.max(torch.abs(got.to(torch.float32)
                                     - want.to(torch.float32)))) / scale


def _probe_stack(rows: int, d: int, dtype, seed: int,
                 device: Device) -> torch.Tensor:
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((rows, d), generator=g, device=dev,
                       dtype=torch.float32).to(dtype)


def gram_fp32_contract_error(n: int = 8, d: int = 4096,
                             dtype=torch.bfloat16, *,
                             block_d: Optional[int] = None, seed: int = 0,
                             device: Device = "cuda") -> float:
    """Max relative error of K1 against the fp32 oracle.

    Args:
      n: worker count of the probe stack.
      d: coordinate count; on the card K1 splits it over many chunks, so
        the cross-chunk accumulation is exercised.
      dtype: input dtype streamed to the kernel (default bf16).
      block_d: tile width of the plain version; only for
        ``device="cpu"`` (the kernel picks its own chunking).
      seed: seed of the probe stack's generator.
      device: ``"cuda"`` (default: the kernel) or ``"cpu"`` (the plain
        version).

    Returns:
      ``max |kernel - oracle| / max |oracle|``, where the oracle casts
      the same quantized inputs to fp32 before the Gram contraction.
    """
    g = _probe_stack(n, d, dtype, seed, device)
    got = pairwise_gram(g, block_d=block_d)
    return _rel_err(got, pairwise_gram_ref(g.to(torch.float32)))


def coord_fp32_contract_error(theta: int = 9, f: int = 2, d: int = 4096,
                              dtype=torch.bfloat16, *,
                              block_d: Optional[int] = None, seed: int = 0,
                              device: Device = "cuda") -> float:
    """Max relative error of K2 (Bulyan's coordinate phase) against the
    fp32 oracle.

    Args:
      theta: selected-stack height.
      f: Byzantine bound (``beta = theta - 2f`` window).
      d: coordinate count.
      dtype: input dtype streamed to the kernel.
      block_d: tile width of the plain version; only for
        ``device="cpu"``.
      seed: seed of the probe stack's generator.
      device: ``"cuda"`` (default) or ``"cpu"``.

    Returns:
      Max relative error against
      ``repro_torch.core.bulyan.coordinate_phase`` run on the fp32 cast
      of the identical quantized stack.
    """
    from repro_torch.core.bulyan import coordinate_phase
    s = _probe_stack(theta, d, dtype, seed, device)
    got = bulyan_select(s, f, block_d=block_d)
    return _rel_err(got, coordinate_phase(s.to(torch.float32), f))


def fused_fp32_contract_error(n: int = 11, f: int = 2, d: int = 4096,
                              dtype=torch.bfloat16, *,
                              mode: str = "bulyan-krum",
                              block_d: Optional[int] = None, seed: int = 0,
                              device: Device = "cuda") -> float:
    """Max relative error of K5 (``fused_aggregate``) against the flat
    fp32 rule.

    K5 chains all three accumulation sites (the Gram, the
    selection-weight contraction and the coordinate phase), so a bf16
    accumulator anywhere in the chain shows up here.

    Args:
      n: worker count (``>= 4f + 3`` for the bulyan modes).
      f: Byzantine bound.
      d: coordinate count.
      dtype: input dtype streamed to the kernels (default bf16).
      mode: fused mode to probe (any of
        ``repro_torch.kernels.fused_agg.FUSED_MODES``).
      block_d: Gram tile width of the plain version; only for
        ``device="cpu"``.
      seed: seed of the probe stack's generator.
      device: ``"cuda"`` (default) or ``"cpu"``.

    Returns:
      Max relative error of ``fused_aggregate`` on the quantized stack
      against the registry's dense rule run on the fp32 cast of the
      identical quantized values.
    """
    from repro_torch.agg.registry import resolve_rule
    from repro_torch.kernels.fused_agg import fused_aggregate
    g = _probe_stack(n, d, dtype, seed, device)
    got, _, _ = fused_aggregate(g, f, mode=mode, block_d=block_d)
    want = resolve_rule(mode).dense_fn(g.to(torch.float32), f).gradient
    return _rel_err(got, want)
