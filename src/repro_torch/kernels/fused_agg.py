"""Fused robust aggregation: Gram -> select -> coordinate phase.

Counterpart of ``repro/kernels/fused_agg.py``.  The reference runs the
whole rule in one Pallas megakernel (``_make_megakernel``, K5) or, per
leaf, in a select + combine pair kernel (``_make_pair_kernel``, K4).  On
the card the two phases of the megakernel need a grid-wide barrier, so
K5 is three kernels on one stream, each a wrapper of this package:

  1. K1, :func:`repro_torch.kernels.pairwise_gram.pairwise_gram_partial`:
     the raw ``(n, n)`` Gram over the stack (first read of the stack);
  2. :func:`select_weights`: one CTA finalizes the matrix and runs the
     mode's selection (Krum / GeoMed scores, first-index argmin,
     multikrum, Bulyan's theta = n - 2f extraction loop) into a
     ``(theta_w, n)`` weight matrix;
  3. K4, :func:`fused_coordinate`: each CTA decodes the weight rows
     once (one-hot, all-zero or general); per coordinate a thread
     gathers the picked values into registers (every row still read,
     for the reference's 0 * x rule: an unselected inf makes NaN), sorts
     them with a network fixed at compile time and applies the
     coordinate phase (second read).

So ``fused_aggregate`` equals K1 + ``select_weights`` + K4 bit for bit
by construction, the port's form of the reference's megakernel-vs-pair
identity.  Its traffic is the reference's: read ``2 n d`` elements,
write ``d`` floats plus the ``(n,)`` diagnostics.  Sources:
``repro_torch/csrc/fused_agg.cu`` and ``repro_torch/csrc/common.cuh``.

Every wrapper dispatches on the tensor's device: a CPU tensor takes the
``*_plain`` version beside it (the reference's arithmetic, with the same
masks and tiebreaks), a CUDA tensor launches the kernel or raises, and
a ``meta`` tensor (the launch harness's dry-run) gets an empty result of
the kernel's shape and counts the launch, building nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (bulyan_window, coord_median,
                                        coord_trimmed_mean, oe_sort_rows)
from repro_torch.kernels.pairwise_gram import (MAX_N, _check_stack,
                                               _plain_block_d,
                                               finalize_dists,
                                               pairwise_gram_partial,
                                               pairwise_gram_partial_plain)

__all__ = ["COORD_MODES", "DIST_MODES", "FUSED_MODES", "fused_aggregate",
           "fused_aggregate_plain", "fused_coordinate",
           "fused_coordinate_plain", "select_weights",
           "select_weights_plain"]

#: modes whose selection consumes the (n, n) distance matrix
DIST_MODES: Tuple[str, ...] = ("bulyan-geomed", "bulyan-krum", "geomed",
                               "krum", "multikrum")

#: coordinate-only modes (no distance phase at all)
COORD_MODES: Tuple[str, ...] = ("cwmed", "trimmed_mean")

#: every mode the fused kernels lower
FUSED_MODES: Tuple[str, ...] = tuple(sorted(DIST_MODES + COORD_MODES))

#: mode numbering shared with csrc/fused_agg.cu
_MODE_IDS = {"krum": 0, "geomed": 1, "multikrum": 2, "bulyan-krum": 3,
             "bulyan-geomed": 4, "cwmed": 5, "trimmed_mean": 6}

#: the wrappers whose launches make up K5's
_K5_PARTS = ("pairwise_gram_partial", "select_weights", "fused_coordinate")

_INF = float("inf")
_NAN = float("nan")


def _weight_rows(n: int, f: int, mode: str) -> int:
    """Row count of the selection-weight matrix for one mode."""
    return n - 2 * f if mode.startswith("bulyan") else 1


def _check_mode_shape(n: int, f: int, mode: str) -> None:
    """Structural checks shared by the entry points (reference texts)."""
    if mode not in FUSED_MODES:
        raise KeyError(f"unknown fused mode {mode!r}; have "
                       f"{sorted(FUSED_MODES)}")
    if n > MAX_N:
        raise ValueError(
            f"fused kernels unroll sort/select networks: n <= {MAX_N} "
            f"(got n={n})")
    if mode.startswith("bulyan") and n < 4 * f + 3:
        raise ValueError(f"bulyan requires n >= 4f+3, got n={n}, f={f}")
    if mode in ("krum", "multikrum") and n - f - 2 < 1:
        raise ValueError(
            f"krum needs n >= f + 3 per use (n={n}, f={f})")
    if mode == "trimmed_mean" and n <= 2 * f:
        raise ValueError(f"need n > 2f (n={n}, f={f})")


def _device_of(x: torch.Tensor) -> str:
    """``"cpu"`` (the plain version), ``"cuda"`` (the kernel) or
    ``"meta"`` (a dry-run: an empty result, the launch counted)."""
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# selection on the (n, n) distance matrix
# ---------------------------------------------------------------------------

def _first_argmin_onehot(scores: torch.Tensor, n: int) -> torch.Tensor:
    """(1, n) scores -> (1, n) f32 one-hot at the first minimum (all zero
    when the minimum is NaN, as the reference's iota form)."""
    iota = torch.arange(n, device=scores.device)[None, :]
    m = torch.min(scores)
    idx = torch.min(torch.where(scores == m, iota, n))
    return (iota == idx).to(torch.float32)


def _masked_dists(d2: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """Diagonal and rows/cols of unavailable workers -> +inf."""
    n = d2.shape[0]
    vmat = avail.T @ avail                             # (n, n) outer
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    return torch.where(eye | (vmat < 0.5), _INF, d2)


def _krum_scores(dm, avail, f, n_rem):
    """Per worker, the sum of the k = max(1, n_rem - f - 2) smallest
    remaining distances, smallest first.

    The reference sorts the columns with its odd-even network, whose
    NaN-propagating min / max spread one NaN to every position of its
    column; ``torch.sort`` puts NaN last instead.  The two agree on
    columns without NaN, so a column holding a NaN (masked entries are
    +inf, never NaN) scores NaN here, as it does in the reference."""
    k = max(1, n_rem - f - 2)
    cols = torch.sort(dm, dim=0).values
    s = cols[0:1]
    for r in range(1, k):
        s = s + cols[r:r + 1]
    s = torch.where(torch.isnan(dm).any(dim=0, keepdim=True), _NAN, s)
    return torch.where(avail > 0.5, s, _INF)


def _geomed_scores(dm, avail):
    """Per worker, the sum of non-squared distances to the remaining
    workers, accumulated in row order as the kernel does.  The square
    root is taken in float64 and rounded once to float32: the correctly
    rounded root that CUDA's ``sqrtf`` gives, on every device (PyTorch's
    vectorized float32 root on the CPU is off by an ulp on some
    inputs)."""
    dist = torch.sqrt(torch.where(torch.isinf(dm), 0.0, dm).double()).float()
    s = torch.zeros_like(avail)
    for i in range(dm.shape[0]):
        s = s + dist[i:i + 1]
    return torch.where(avail > 0.5, s, _INF)


def select_weights_plain(dist2: torch.Tensor, n: int, f: int, mode: str):
    """Plain PyTorch version of the selection (reference semantics).

    Args:
      dist2: ``(n, n)`` squared distances, raw or finalized (finalized
        here; finalizing twice is exact).
      n: worker count.
      f: Byzantine bound.
      mode: one of :data:`DIST_MODES`.

    Returns:
      ``(weights, selected, scores)``: the ``(theta_w, n)`` f32
      combination matrix, the ``(1, n)`` selection marks and the
      ``(1, n)`` rule scores (zeros for bulyan).
    """
    d2 = finalize_dists(dist2.to(torch.float32))
    avail = torch.ones((1, n), dtype=torch.float32, device=d2.device)
    if mode in ("krum", "geomed"):
        dm = _masked_dists(d2, avail)
        scores = (_krum_scores(dm, avail, f, n) if mode == "krum"
                  else _geomed_scores(dm, avail))
        hot = _first_argmin_onehot(scores, n)
        return hot, hot, scores
    if mode == "multikrum":
        scores = _krum_scores(_masked_dists(d2, avail), avail, f, n)
        m = max(1, n - f - 2)
        acc = torch.zeros((1, n), dtype=torch.float32, device=d2.device)
        cur = scores
        for _ in range(m):
            hot = _first_argmin_onehot(cur, n)
            acc = acc + hot
            cur = torch.where(hot > 0.5, _INF, cur)
        w = acc / m
        return w, w, scores
    if mode not in ("bulyan-krum", "bulyan-geomed"):
        raise KeyError(f"select_weights needs a distance mode, got "
                       f"{mode!r}")
    base = mode.split("-", 1)[1]
    picks = []
    sel = torch.zeros((1, n), dtype=torch.float32, device=d2.device)
    for t in range(n - 2 * f):
        dm = _masked_dists(d2, avail)
        scores = (_krum_scores(dm, avail, f, n - t) if base == "krum"
                  else _geomed_scores(dm, avail))
        hot = _first_argmin_onehot(scores, n)
        picks.append(hot)
        sel = sel + hot
        avail = avail - hot
    return torch.cat(picks, dim=0), sel, torch.zeros_like(sel)


def select_weights(dist2: torch.Tensor, n: int, f: int, mode: str):
    """Selection weights of one fused mode from the distance matrix.

    Args:
      dist2: ``(n, n)`` float32 squared distances, raw or finalized.
      n: worker count (<= 64).
      f: Byzantine bound.
      mode: one of :data:`DIST_MODES`.

    Returns:
      ``(weights, selected, scores)`` as :func:`select_weights_plain`.
      A CPU tensor takes the plain version; a CUDA tensor launches the
      one-CTA selection kernel or raises.
    """
    if _device_of(dist2) == "cpu":
        return select_weights_plain(dist2, n, f, mode)
    if mode not in DIST_MODES:
        raise KeyError(f"select_weights needs a distance mode, got "
                       f"{mode!r}")
    if dist2.dtype != torch.float32 or tuple(dist2.shape) != (n, n):
        raise ValueError(f"select_weights takes a float32 ({n}, {n}) "
                         f"matrix, got {dist2.dtype} {tuple(dist2.shape)}")
    if n > MAX_N:
        raise ValueError(f"select_weights needs n <= {MAX_N}")
    dist2 = dist2.contiguous()  # the kernel reads rows: copy a strided matrix
    dev = dist2.device
    w = torch.empty((_weight_rows(n, f, mode), n), dtype=torch.float32,
                    device=dev)
    sel = torch.empty((1, n), dtype=torch.float32, device=dev)
    scores = torch.empty((1, n), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        _build.count("select_weights")
        return w, sel, scores
    lib = _build.library("fused_agg")
    _build.check(lib.select_weights_f32(
        dist2.data_ptr(), n, f, _MODE_IDS[mode], w.data_ptr(),
        sel.data_ptr(), scores.data_ptr(), _build.stream_of(dist2)),
        "select_weights")
    _build.count("select_weights")
    return w, sel, scores


# ---------------------------------------------------------------------------
# K4: weight contraction + coordinate phase
# ---------------------------------------------------------------------------

def _check_weights(mode: str, weights: Optional[torch.Tensor]) -> bool:
    coord_only = mode in COORD_MODES
    if coord_only != (weights is None):
        raise ValueError(
            f"mode {mode!r} {'takes no' if coord_only else 'needs'} "
            f"selection weights")
    return coord_only


def fused_coordinate_plain(stack: torch.Tensor,
                           weights: Optional[torch.Tensor], f: int, *,
                           mode: str = "bulyan-krum") -> torch.Tensor:
    """Plain PyTorch version of K4 (the reference's combine body).

    Args:
      stack: ``(n, d)`` worker rows, fp32 or bf16 (widened to fp32).
      weights: ``(theta_w, n)`` f32 selection weights, ``None`` for the
        coordinate-only modes.
      f: Byzantine bound.
      mode: one of :data:`FUSED_MODES`.

    Returns:
      ``(d,)`` f32 aggregated coordinates.
    """
    n = stack.shape[0]
    _check_mode_shape(n, f, mode)
    coord_only = _check_weights(mode, weights)
    x = stack.to(torch.float32)
    if coord_only:
        rows = oe_sort_rows([x[i] for i in range(n)])
        return (coord_median(rows) if mode == "cwmed"
                else coord_trimmed_mean(rows, f))
    y = weights.to(torch.float32) @ x                   # (theta_w, d)
    if mode.startswith("bulyan"):
        rows = oe_sort_rows([y[t] for t in range(y.shape[0])])
        return bulyan_window(rows, f)
    return y[0]


def fused_coordinate(stack: torch.Tensor, weights: Optional[torch.Tensor],
                     f: int, *, mode: str = "bulyan-krum") -> torch.Tensor:
    """Selection-combine + coordinate phase of one ``(n, d)`` stack.

    Args:
      stack: ``(n, d)`` worker rows, fp32 or bf16, n <= 64, any
        strides.
      weights: ``(theta_w, n)`` f32 weights from :func:`select_weights`;
        ``None`` for the coordinate-only modes.
      f: Byzantine bound.
      mode: one of :data:`FUSED_MODES`.

    Returns:
      ``(d,)`` f32 aggregate.  A CPU tensor takes the plain version; a
      CUDA tensor launches the kernel or raises.
    """
    if _device_of(stack) == "cpu":
        return fused_coordinate_plain(stack, weights, f, mode=mode)
    n, d = stack.shape
    _check_mode_shape(n, f, mode)
    coord_only = _check_weights(mode, weights)
    stack = stack.contiguous()  # the kernel reads rows: copy a strided stack
    _check_stack(stack, "fused_coordinate")
    theta_w = 0 if coord_only else _weight_rows(n, f, mode)
    if not coord_only:
        weights = weights.to(torch.float32).contiguous()
        if tuple(weights.shape) != (theta_w, n) or (
                weights.device != stack.device):
            raise ValueError(f"weights must be ({theta_w}, {n}) on "
                             f"{stack.device}, got {tuple(weights.shape)} "
                             f"on {weights.device}")
    out = torch.empty((d,), dtype=torch.float32, device=stack.device)
    if stack.device.type == "meta":
        _build.count("fused_coordinate")
        return out
    lib = _build.library("fused_agg")
    fn = (lib.combine_f32 if stack.dtype == torch.float32
          else lib.combine_bf16)
    _build.check(fn(stack.data_ptr(), n, d,
                    None if coord_only else weights.data_ptr(), theta_w, f,
                    _MODE_IDS[mode], out.data_ptr(), _build.stream_of(stack)),
                 "fused_coordinate")
    _build.count("fused_coordinate")
    return out


# ---------------------------------------------------------------------------
# K5: the whole rule
# ---------------------------------------------------------------------------

def _coord_result(agg: torch.Tensor, n: int):
    return (agg, torch.full((n,), 1.0 / n, dtype=torch.float32,
                            device=agg.device),
            torch.zeros((n,), dtype=torch.float32, device=agg.device))


def fused_aggregate_plain(grads: torch.Tensor, f: int, *,
                          mode: str = "bulyan-krum", block_d: int = 2048):
    """Plain PyTorch version of K5: K1, selection and K4 in sequence.

    Args:
      grads: ``(n, d)`` worker rows, fp32 or bf16.
      f: Byzantine bound.
      mode: one of :data:`FUSED_MODES`.
      block_d: Gram tile width (as the reference's).

    Returns:
      ``(gradient, selected, scores)``: ``(d,)``, ``(n,)``, ``(n,)`` f32.
    """
    n = grads.shape[0]
    _check_mode_shape(n, f, mode)
    if mode in COORD_MODES:
        return _coord_result(fused_coordinate_plain(grads, None, f,
                                                    mode=mode), n)
    raw = pairwise_gram_partial_plain(grads, block_d=block_d)
    w, sel, scores = select_weights_plain(raw, n, f, mode)
    agg = fused_coordinate_plain(grads, w, f, mode=mode)
    return agg, sel[0], scores[0]


def fused_aggregate(grads: torch.Tensor, f: int, *,
                    mode: str = "bulyan-krum",
                    block_d: Optional[int] = None):
    """Robust-aggregate a flat worker stack (K5).

    Args:
      grads: ``(n, d)`` worker rows, fp32 or bf16, n <= 64, any strides.
      f: Byzantine bound.
      mode: one of :data:`FUSED_MODES` (``"krum"``, ``"multikrum"``,
        ``"geomed"``, ``"cwmed"``, ``"trimmed_mean"``, ``"bulyan-krum"``,
        ``"bulyan-geomed"``).
      block_d: Gram tile width of the plain version, for a CPU tensor
        only (``None``: its default); a CUDA tensor with one raises.

    Returns:
      ``(gradient, selected, scores)``: the ``(d,)`` f32 aggregate, the
      ``(n,)`` f32 selection weights and the ``(n,)`` f32 rule scores.
      A CPU tensor takes :func:`fused_aggregate_plain`; a CUDA tensor runs
      K1, the selection kernel and K4 on the current stream, or raises.
    """
    kw = _plain_block_d(grads, block_d, "fused_aggregate")
    if _device_of(grads) == "cpu":
        return fused_aggregate_plain(grads, f, mode=mode, **kw)
    n = grads.shape[0]
    _check_mode_shape(n, f, mode)
    grads = grads.contiguous()  # one copy for both reads of a strided stack
    before = sum(_build.LAUNCHES[k] for k in _K5_PARTS)
    if mode in COORD_MODES:
        out = _coord_result(fused_coordinate(grads, None, f, mode=mode), n)
    else:
        raw = pairwise_gram_partial(grads)
        w, sel, scores = select_weights(raw, n, f, mode)
        out = (fused_coordinate(grads, w, f, mode=mode), sel[0], scores[0])
    # K5 launches nothing of its own: it counts the launches it made
    _build.count("fused_aggregate",
                 sum(_build.LAUNCHES[k] for k in _K5_PARTS) - before)
    return out
