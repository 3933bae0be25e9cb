"""K1: pairwise squared-distance (Gram) partial over coordinate chunks.

Counterpart of ``repro/kernels/pairwise_gram.py``.  Replaces the Pallas
kernel ``_gram_kernel`` (``pairwise_gram.py:46``) reached through
``pairwise_gram_partial``; the CUDA source is
``repro_torch/csrc/pairwise_gram.cu`` (split-K over d, the symmetric
half of the Gram in 8 x 8 register blocks of fp32 FFMA, a cp.async ring
of tiles, and the per-chunk partials reduced in the same launch in a
fixed order, so runs repeat bit for bit and the result is exactly
symmetric).  It is bounded by reading the ``(n, d)`` stack once; at
n = 39 the ``n (n + 1) d`` fp32 operations take about half as long.

``pairwise_gram_partial`` dispatches on the tensor's device: a CPU
tensor takes :func:`pairwise_gram_partial_plain`, which repeats the
reference's per-tile arithmetic; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.core.pytree import tree_leaves
from repro_torch.kernels import _build

__all__ = ["finalize_dists", "pairwise_gram", "pairwise_gram_partial",
           "pairwise_gram_partial_plain", "pairwise_gram_tree"]

#: the kernels pad n to a thread tile and keep (n, n) in shared memory
MAX_N = 64
#: coordinates per shared-memory tile of the kernel
_TILE_K = 64
#: CTAs the split-K grid aims at (two per SM of an H100's 132); fixed
#: here, not read from the card, so a result does not depend on the card
_TARGET_CHUNKS = 264
#: chunks per first-level reduce of the kernel (``kGroup`` in the source)
_GROUP = 16
#: (device, stream) -> the kernel's reduce counters, zero between launches
_COUNTERS = {}


def finalize_dists(raw: torch.Tensor) -> torch.Tensor:
    """Turn summed raw partials into a valid distance matrix.

    Args:
      raw: ``(n, n)`` sum of :func:`pairwise_gram_partial` outputs.

    Returns:
      ``(n, n)`` with fp-cancellation negatives clamped to zero and the
      diagonal zeroed.
    """
    n = raw.shape[0]
    out = torch.clamp_min(raw, 0.0)
    return out * (1.0 - torch.eye(n, dtype=out.dtype, device=out.device))


def pairwise_gram_partial_plain(slab: torch.Tensor, *,
                                block_d: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of K1, tile by tile as the reference.

    Args:
      slab: ``(n, *dims)`` worker-stacked coordinates, fp32 or bf16.
      block_d: tile width along the flattened coordinate axis.

    Returns:
      ``(n, n)`` float32 raw partial ``sum over tiles of (sq_i + sq_j -
      2 <x_i, x_j>)``, neither clamped nor with a zeroed diagonal.
    """
    n = slab.shape[0]
    x = slab.reshape(n, -1)
    d = x.shape[1]
    block_d = min(block_d, max(d, 128))
    out = None
    for k0 in range(0, d, block_d):
        blk = x[:, k0:k0 + block_d].to(torch.float32)
        sq = torch.sum(blk * blk, dim=1)
        part = sq[:, None] + sq[None, :] - 2.0 * (blk @ blk.T)
        out = part if out is None else out + part
    return out


def _check_stack(x: torch.Tensor, what: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous (n, d) stack")
    if not 1 <= x.shape[0] <= MAX_N:
        raise ValueError(f"{what}: n <= {MAX_N} (got n={x.shape[0]})")


def _chunking(d: int):
    """(chunk, n_chunks): contiguous coordinate chunks, one per CTA."""
    tiles = math.ceil(d / _TILE_K)
    per = math.ceil(tiles / min(tiles, _TARGET_CHUNKS))
    chunk = per * _TILE_K
    return chunk, math.ceil(d / chunk)


def _plain_block_d(x: torch.Tensor, block_d: Optional[int], what: str):
    """Keyword arguments for a plain version; a CUDA call takes none,
    because the kernel picks its own chunking."""
    if block_d is None:
        return {}
    if x.device.type != "cpu":
        raise ValueError(f"{what}: block_d sets the plain version's tiles; "
                         f"the kernel picks its own chunking")
    return {"block_d": block_d}


def pairwise_gram_partial(slab: torch.Tensor, *,
                          block_d: Optional[int] = None) -> torch.Tensor:
    """Raw distance partial of one coordinate slab (the accumulable form).

    Args:
      slab: ``(n, *dims)`` worker-stacked coordinates, fp32 or bf16,
        n <= 64; trailing dims are flattened.
      block_d: tile width of the plain version, for a CPU tensor only
        (``None``: its default); a CUDA tensor with a ``block_d`` raises.

    Returns:
      ``(n, n)`` float32 raw partial (see
      :func:`pairwise_gram_partial_plain`).  A CPU tensor takes the plain
      version; a CUDA tensor launches the kernel or raises.
    """
    n = slab.shape[0]
    x = slab.reshape(n, -1)
    kw = _plain_block_d(x, block_d, "pairwise_gram_partial")
    if x.device.type == "cpu":
        return pairwise_gram_partial_plain(x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_stack(x, "pairwise_gram_partial")
    d = x.shape[1]
    chunk, n_chunks = _chunking(d)
    n_groups = math.ceil(n_chunks / _GROUP)
    tri = n * (n + 1) // 2                  # packed upper triangle
    partials = torch.empty((n_chunks, tri), dtype=torch.float32,
                           device=x.device)
    group_sums = torch.empty((n_groups, tri), dtype=torch.float32,
                             device=x.device)
    raw = torch.empty((n, n), dtype=torch.float32, device=x.device)
    stream = _build.stream_of(x)
    key = (x.device, stream)
    if key not in _COUNTERS:
        # n_groups + 1 <= 18 counters; the kernel leaves them at zero
        _COUNTERS[key] = torch.zeros(32, dtype=torch.int32, device=x.device)
    lib = _build.library("pairwise_gram")
    fn = (lib.gram_partial_f32 if x.dtype == torch.float32
          else lib.gram_partial_bf16)
    _build.check(fn(x.data_ptr(), n, d, chunk, n_chunks,
                    partials.data_ptr(), group_sums.data_ptr(),
                    _COUNTERS[key].data_ptr(), raw.data_ptr(), stream),
                 "pairwise_gram_partial")
    _build.count("pairwise_gram_partial")
    return raw


def pairwise_gram(grads: torch.Tensor, *, block_d: Optional[int] = None
                  ) -> torch.Tensor:
    """Pairwise squared euclidean distances of worker rows.

    Args:
      grads: ``(n, d)`` worker rows, fp32 or bf16.
      block_d: tile width of the plain version, for a CPU tensor only.

    Returns:
      ``(n, n)`` float32 distances, non-negative, zero diagonal.
    """
    return finalize_dists(pairwise_gram_partial(grads, block_d=block_d))


def pairwise_gram_tree(tree: Any, *, block_d: Optional[int] = None
                       ) -> torch.Tensor:
    """Distances over the concatenation of all leaves of a gradient tree.

    Args:
      tree: a dict (or list) of ``(n, *dims)`` leaves with a shared
        leading worker axis, in the reference's leaf order (sorted keys);
        trailing dims may differ across leaves.
      block_d: tile width of the plain version, for CPU leaves only.

    Returns:
      ``(n, n)`` float32 squared distances over the concatenated
      coordinate space: one :func:`pairwise_gram_partial` per leaf (one
      K1 launch each on the card), summed in leaf order, finalized once;
      no flat ``(n, d)`` matrix is built.
    """
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty gradient tree")
    n = leaves[0].shape[0]
    raw = torch.zeros((n, n), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        raw = raw + pairwise_gram_partial(leaf, block_d=block_d)
    return finalize_dists(raw)
