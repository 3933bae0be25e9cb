"""The grouped GEMM of the dropless expert layer: each group of rows (the
tokens routed to one held expert, in expert order) times its expert's
weight, forward, dX and per-worker dW.

No counterpart in the JAX package (its MoE is the capacity-based
GShard dispatch): the port's own kernel, added for DeepSeek-V2's routed
experts (``models/moe.py::grouped_moe_ffn``).  The CUDA source is
``repro_torch/csrc/grouped_gemm.cu``: fp32 FFMA (TF32 off, as the
configurations run), 128 x 128 output tiles of 8 x 8 per thread, a
double-buffered shared-memory ring of depth-8 slices, a row product's
depth split in two halves added into the zeroed output (the same bits in
either order).  The groups' row
ranges are device tensors (``starts``, ``ends``), so the step makes no
host sync: the launch covers the most row tiles the groups can have
(``ceil(M / 128) + groups``) and each block finds its group by walking
the ranges, a block past the last tile exiting at once.  Empty groups
take no tile; rows outside every group come out zero.  What bounds it
on an H100: the FLOPs (``2 rows K N`` per product at 67 TFLOP/s fp32)
at the expert widths; the bytes (rows, the group's weight, the output)
take a twentieth of that.

Two ``torch.library`` custom ops, each with a ``vmap`` rule that folds
the vmapped worker axis into the groups (``torch.func.vmap`` over the
train step's workers runs one launch for all of them, each worker's row
ranges shifted by its rows):

  ``repro_torch::gmm(x, w, starts, ends, trans_w, count_base)``
      ``out[r] = x[r] @ w[j % Gw]`` (``w[j % Gw].T`` with ``trans_w``)
      for the rows ``r`` of group ``j``; ``Gw`` is ``w``'s group count.
  ``repro_torch::gmm_dw(x, dy, starts, ends)``
      ``out[j] = x[rows of j].T @ dy[rows of j]`` (zero for an empty
      group): the weights' gradient, one per group.

:func:`grouped_mm` is the differentiable entry (a
``torch.autograd.Function`` whose backward runs the same ops).  A CPU
tensor takes the plain per-group loop (the oracle), a CUDA tensor the
kernel (or raises), a ``meta`` tensor an empty result (no launch
counted: the launch harness's dry-run refuses the expert layer).

The row counter: a forward call with ``count_base >= 0`` adds each
group's rows to ``counter[count_base + j % Gw]`` on the device (one
integer atomic per group), never read in the step; :func:`expert_rows`
reads it once, after a run.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from repro_torch.kernels import _build

__all__ = ["COUNTER_EXPERTS", "COUNTER_LAYERS", "expert_rows",
           "grouped_mm", "grouped_mm_plain", "reset_expert_rows"]

#: the row counter's layout: ``layers x experts`` slots
COUNTER_LAYERS = 128
COUNTER_EXPERTS = 256
#: rows and columns of the kernel's output tile
_TILE = 128

_COUNTERS: Dict[torch.device, Tensor] = {}


def _counter(device) -> Tensor:
    dev = torch.device(device)
    if dev not in _COUNTERS:
        _COUNTERS[dev] = torch.zeros(COUNTER_LAYERS * COUNTER_EXPERTS,
                                     dtype=torch.int64, device=dev)
    return _COUNTERS[dev]


def reset_expert_rows() -> None:
    """Zero every device's row counter."""
    for c in _COUNTERS.values():
        c.zero_()


def expert_rows() -> Tensor:
    """``(COUNTER_LAYERS, COUNTER_EXPERTS)`` int64 on the CPU: the rows
    each (layer, held expert) multiplied since the last
    :func:`reset_expert_rows`, summed over devices (one read, which
    waits for the device)."""
    out = torch.zeros(COUNTER_LAYERS * COUNTER_EXPERTS, dtype=torch.int64)
    for c in _COUNTERS.values():
        out += c.cpu()
    return out.view(COUNTER_LAYERS, COUNTER_EXPERTS)


def grouped_mm_plain(x: Tensor, w: Tensor, starts, ends,
                     trans_w: bool = False) -> Tensor:
    """The oracle: one ``torch.mm`` per group over its rows.

    Args:
      x: ``(M, K)`` rows.
      w: ``(Gw, K, N)`` weights (``(Gw, N, K)`` with ``trans_w``).
      starts, ends: per group ``j`` its rows ``[starts[j], ends[j])``
        (sequences or tensors of ints).
      trans_w: multiply by each weight transposed.

    Returns:
      ``(M, N)``, zero on the rows of no group.
    """
    n = w.shape[1] if trans_w else w.shape[2]
    out = x.new_zeros((x.shape[0], n))
    starts = [int(v) for v in starts]
    ends = [int(v) for v in ends]
    gw = w.shape[0]
    for j, (s, e) in enumerate(zip(starts, ends)):
        if e > s:
            wj = w[j % gw]
            out[s:e] = torch.mm(x[s:e], wj.t() if trans_w else wj)
    return out


def _dw_plain(x: Tensor, dy: Tensor, starts, ends) -> Tensor:
    out = x.new_zeros((len(starts), x.shape[1], dy.shape[1]))
    for j, (s, e) in enumerate(zip([int(v) for v in starts],
                                   [int(v) for v in ends])):
        if e > s:
            out[j] = torch.mm(x[s:e].t(), dy[s:e])
    return out


def _check(x: Tensor, what: str, widths) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 (TF32 off), got {x.dtype}")
    for name, v, m in widths:
        if v % m:
            raise ValueError(f"{what}: {name} = {v} must be a multiple of "
                             f"{m} (the kernel's vector loads)")


def _i32(t: Tensor) -> Tensor:
    return t.to(torch.int32).contiguous()


@torch.library.custom_op("repro_torch::gmm", mutates_args=())
def _gmm(x: Tensor, w: Tensor, starts: Tensor, ends: Tensor,
         trans_w: bool, count_base: int) -> Tensor:
    if x.device.type == "cpu":
        s, e = starts.tolist(), ends.tolist()
        if count_base >= 0:
            c = _counter(x.device)
            for j, (a, b) in enumerate(zip(s, e)):
                c[count_base + j % w.shape[0]] += max(0, b - a)
        return grouped_mm_plain(x, w, s, e, trans_w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, w = x.contiguous(), w.contiguous()
    m, k = x.shape
    n = w.shape[1] if trans_w else w.shape[2]
    _check(x, "grouped_mm", (("K", k, 8), ("N", n, 4)))
    _check(w, "grouped_mm", ())
    out = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    groups = starts.shape[0]
    if m == 0 or groups == 0:
        return out
    tiles = (m + _TILE - 1) // _TILE + groups
    # the depth in two halves (see the source), when each is whole slices
    splits = 2 if k % 16 == 0 and k >= 256 else 1
    counter = _counter(x.device).data_ptr() if count_base >= 0 else None
    # named, so the int32 copies live until the launch is queued (a
    # temporary's memory goes back to the caching allocator at once)
    s32, e32 = _i32(starts), _i32(ends)
    lib = _build.library("grouped_gemm")
    _build.check(lib.gmm_rows_f32(
        x.data_ptr(), w.data_ptr(), s32.data_ptr(), e32.data_ptr(), groups,
        w.shape[0], k, n, int(trans_w), counter, max(count_base, 0),
        out.data_ptr(), tiles, splits, _build.stream_of(x)), "grouped_mm")
    _build.count("grouped_gemm")
    return out


@_gmm.register_fake
def _(x, w, starts, ends, trans_w, count_base):
    n = w.shape[1] if trans_w else w.shape[2]
    return x.new_empty((x.shape[0], n))


@torch.library.custom_op("repro_torch::gmm_dw", mutates_args=())
def _gmm_dw(x: Tensor, dy: Tensor, starts: Tensor, ends: Tensor) -> Tensor:
    if x.device.type == "cpu":
        return _dw_plain(x, dy, starts.tolist(), ends.tolist())
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, dy = x.contiguous(), dy.contiguous()
    k, n = x.shape[1], dy.shape[1]
    _check(x, "grouped_mm (dW)", (("K", k, 4), ("N", n, 4)))
    _check(dy, "grouped_mm (dW)", ())
    groups = starts.shape[0]
    out = torch.empty((groups, k, n), dtype=x.dtype, device=x.device)
    if groups == 0:
        return out
    s32, e32 = _i32(starts), _i32(ends)
    lib = _build.library("grouped_gemm")
    _build.check(lib.gmm_dw_f32(
        x.data_ptr(), dy.data_ptr(), s32.data_ptr(), e32.data_ptr(),
        groups, k, n, out.data_ptr(), _build.stream_of(x)),
        "grouped_mm (dW)")
    _build.count("grouped_gemm")
    return out


@_gmm_dw.register_fake
def _(x, dy, starts, ends):
    return x.new_empty((starts.shape[0], x.shape[1], dy.shape[1]))


def _front(t: Tensor, bdim: Optional[int], size: int) -> Tensor:
    """``t`` with its vmapped axis first (expanded when it has none)."""
    if bdim is None:
        return t.expand((size,) + tuple(t.shape))
    return t.movedim(bdim, 0)


def _folded_ranges(starts, ends, sdim, edim, size: int, rows: int):
    """Every worker's group ranges, shifted by its rows, in one list."""
    starts, ends = _front(starts, sdim, size), _front(ends, edim, size)
    base = (torch.arange(size, device=starts.device,
                         dtype=starts.dtype) * rows)[:, None]
    return (starts + base).reshape(-1), (ends + base).reshape(-1)


def _gmm_vmap(info, in_dims, x, w, starts, ends, trans_w, count_base):
    b = info.batch_size
    xd, wd, sd, ed = in_dims[:4]
    x = _front(x, xd, b)
    rows = x.shape[1]
    s, e = _folded_ranges(starts, ends, sd, ed, b, rows)
    if wd is not None:
        w = w.movedim(wd, 0)
        w = w.reshape((-1,) + tuple(w.shape[2:]))
    out = _gmm(x.reshape((b * rows,) + tuple(x.shape[2:])), w, s, e,
               trans_w, count_base)
    return out.reshape((b, rows) + tuple(out.shape[1:])), 0


def _gmm_dw_vmap(info, in_dims, x, dy, starts, ends):
    b = info.batch_size
    xd, dd, sd, ed = in_dims
    x, dy = _front(x, xd, b), _front(dy, dd, b)
    rows, groups = x.shape[1], starts.shape[-1]
    s, e = _folded_ranges(starts, ends, sd, ed, b, rows)
    out = _gmm_dw(x.reshape((b * rows,) + tuple(x.shape[2:])),
                  dy.reshape((b * rows,) + tuple(dy.shape[2:])), s, e)
    return out.reshape((b, groups) + tuple(out.shape[1:])), 0


torch.library.register_vmap("repro_torch::gmm", _gmm_vmap)
torch.library.register_vmap("repro_torch::gmm_dw", _gmm_dw_vmap)


class _GroupedMM(torch.autograd.Function):
    """``gmm`` with its gradient: ``dx = gmm(dy, w, trans)`` and ``dw =
    gmm_dw`` per group; the ``vmap`` rule comes from the ops'."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, starts, ends, count_base):
        return _gmm(x, w, starts, ends, False, count_base)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, starts, ends, _ = inputs
        ctx.save_for_backward(x, w, starts, ends)

    @staticmethod
    def backward(ctx, dy):
        x, w, starts, ends = ctx.saved_tensors
        # first-order only: the ops below carry no gradient of their own
        with torch.no_grad():
            dx = (_gmm(dy, w, starts, ends, True, -1)
                  if ctx.needs_input_grad[0] else None)
            dw = (_gmm_dw(x, dy, starts, ends)
                  if ctx.needs_input_grad[1] else None)
        return dx, dw, None, None, None


def grouped_mm(x: Tensor, w: Tensor, offsets: Tensor,
               count_base: int = -1) -> Tensor:
    """Rows times their group's weight, differentiable.

    Args:
      x: ``(M, K)`` rows, sorted by group.
      w: ``(G, K, N)`` one weight per group.
      offsets: ``(G + 1,)`` integer group boundaries: group ``j`` holds
        rows ``[offsets[j], offsets[j + 1])``; rows at or past
        ``offsets[G]`` belong to none.
      count_base: ``>= 0`` adds each group's rows to the row counter's
        slots ``count_base + j`` (see the module docstring).

    Returns:
      ``(M, N)``: zero on the rows of no group.
    """
    if offsets.shape[-1] != w.shape[0] + 1:
        raise ValueError(f"grouped_mm: {w.shape[0]} groups of weights need "
                         f"{w.shape[0] + 1} offsets, got {offsets.shape[-1]}")
    return _GroupedMM.apply(x, w, offsets[:-1], offsets[1:], count_base)
