"""Gradient aggregation rules (counterpart of ``repro/core/gars.py``).

Every rule of the reference: the paper's ``average``, ``krum``,
``geomed`` (the Medoid) and ``brute`` (§2.3), and the extra baselines
``multikrum``, ``cwmed``, ``trimmed_mean`` and ``centered_clip``, with
the ``*_scores`` / ``*_select`` helpers that Bulyan's recursion consumes.
Every rule takes ``(grads: (n, d), f)`` and returns an
:class:`AggResult`; ties resolve to the smallest index, as in the
reference (``torch.argmin`` returns the first minimum, orderings use
``torch.argsort(..., stable=True)``, and :func:`top_k_total_order` ranks
as ``jax.lax.top_k`` does).
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import torch

from repro_torch.agg.registry import RULES, register_rule, resolve_rule
from repro_torch.agg.registry import quorum as _registry_quorum
from repro_torch.core.types import AggResult

__all__ = ["REGISTRY", "average", "brute", "brute_subset_diameters",
           "centered_clip", "cwmed", "geomed", "geomed_scores",
           "geomed_select", "get_gar", "krum", "krum_scores", "krum_select",
           "multikrum", "pairwise_sq_dists", "quorum", "top_k_total_order",
           "trimmed_mean"]

_INF = float("inf")


def pairwise_sq_dists(grads: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) squared euclidean distances via the Gram form.

    Args:
      grads: ``(n, d)`` worker rows.

    Returns:
      ``(n, n)`` ``|x|^2 + |y|^2 - 2<x, y>``, floored at zero, with a
      zero diagonal.
    """
    sq = torch.sum(grads * grads, dim=-1)
    gram = grads @ grads.T
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    d2 = torch.clamp_min(d2, 0.0)
    eye = torch.eye(grads.shape[0], dtype=grads.dtype, device=grads.device)
    return d2 * (1.0 - eye)


def _masked(dist2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rows/cols of excluded workers and the diagonal -> +inf."""
    n = dist2.shape[0]
    valid = mask[:, None] & mask[None, :]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=dist2.device)
    return torch.where(valid & off_diag, dist2,
                       torch.full_like(dist2, _INF))


def krum_scores(dist2: torch.Tensor, mask: torch.Tensor, f: int,
                n_remaining: int) -> torch.Tensor:
    """Krum score: sum of squared distances to the ``n_remaining - f - 2``
    closest remaining vectors.

    Args:
      dist2: ``(n, n)`` squared distances.
      mask: ``(n,)`` bool, True for remaining workers.
      f: Byzantine bound.
      n_remaining: count of remaining workers.

    Returns:
      ``(n,)`` scores, +inf for excluded workers.
    """
    k = n_remaining - f - 2
    if k < 1:
        raise ValueError(
            f"krum needs n >= f + 3 per use (n={n_remaining}, f={f})")
    dm = _masked(dist2, mask)
    snn = torch.sort(dm, dim=1).values[:, :k]
    scores = torch.sum(snn, dim=1)
    return torch.where(mask, scores, torch.full_like(scores, _INF))


def krum_select(dist2: torch.Tensor, mask: torch.Tensor, f: int,
                n_remaining: int) -> torch.Tensor:
    """Index of the Krum winner (first among equal scores).

    Args:
      dist2: ``(n, n)`` squared distances.
      mask: ``(n,)`` bool remaining workers.
      f: Byzantine bound.
      n_remaining: count of remaining workers.

    Returns:
      0-d int64 index.
    """
    return torch.argmin(krum_scores(dist2, mask, f, n_remaining))


def geomed_scores(dist2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Medoid score: sum of (non-squared) distances to remaining vectors.

    Args:
      dist2: ``(n, n)`` squared distances.
      mask: ``(n,)`` bool remaining workers.

    Returns:
      ``(n,)`` scores, +inf for excluded workers.
    """
    dm = _masked(dist2, mask)
    dist = torch.sqrt(torch.where(torch.isinf(dm), torch.zeros_like(dm), dm))
    scores = torch.sum(dist, dim=1)
    return torch.where(mask, scores, torch.full_like(scores, _INF))


def geomed_select(dist2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Index of the Medoid with the smallest index among ties.

    Args:
      dist2: ``(n, n)`` squared distances.
      mask: ``(n,)`` bool remaining workers.

    Returns:
      0-d int64 index.
    """
    return torch.argmin(geomed_scores(dist2, mask))


def top_k_total_order(values: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the ``m`` largest values, ranked as ``jax.lax.top_k``.

    ``top_k`` orders floats by XLA's total order, in which the sign bit
    counts for NaN too: ``-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf <
    +NaN``.  Equal keys go to the lower index.  ``torch.sort`` and
    ``torch.argsort`` would put every NaN last instead.

    Args:
      values: ``(n,)`` floating-point keys.
      m: how many indices to return.

    Returns:
      ``(m,)`` int64 indices, largest key first.
    """
    bits = values.to(torch.float32).view(torch.int32).to(torch.int64)
    # a negative float's bits order backwards: flip all but the sign bit
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.argsort(-key, stable=True)[:m]


def _subsets(n: int, size: int) -> List[Tuple[int, ...]]:
    return list(itertools.combinations(range(n), size))


def brute_subset_diameters(dist2: torch.Tensor, n: int,
                           f: int) -> torch.Tensor:
    """Diameter (max pairwise squared distance) of every (n-f)-subset.

    Enumerated on the host, as in the reference: Brute is only practical
    for small n (paper §2.3.1).

    Args:
      dist2: ``(n, n)`` squared distances.
      n: worker count.
      f: Byzantine bound.

    Returns:
      ``(S,)`` diameters, one per subset of ``itertools.combinations``
      order.
    """
    idx = torch.tensor(_subsets(n, n - f), device=dist2.device)
    sub = dist2[idx[:, :, None], idx[:, None, :]]
    return torch.amax(sub.reshape(idx.shape[0], -1), dim=1)


def _one_hot(i: torch.Tensor, n: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n, device=like.device) == i).to(like.dtype)


def _all(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.bool, device=like.device)


@register_rule("average", min_n=lambda f: 1, byzantine_resilient=False,
               invariants=("finite", "hull", "convex"),
               doc="arithmetic mean (not Byzantine-resilient)")
def average(grads: torch.Tensor, f: int = 0) -> AggResult:
    """Arithmetic mean, the non-robust reference (paper Fig. 2/3)."""
    n = grads.shape[0]
    w = torch.full((n,), 1.0 / n, dtype=grads.dtype, device=grads.device)
    return AggResult(torch.mean(grads, dim=0), w, torch.zeros_like(w))


@register_rule("krum", min_n=lambda f: 2 * f + 3,
               invariants=("finite", "hull", "convex"),
               doc="Blanchard et al. 2017")
def krum(grads: torch.Tensor, f: int) -> AggResult:
    """Krum: the vector with the smallest sum of squared distances to its
    n - f - 2 nearest neighbours."""
    n = grads.shape[0]
    if n < 2 * f + 3:
        raise ValueError(f"krum requires n >= 2f+3, got n={n}, f={f}")
    scores = krum_scores(pairwise_sq_dists(grads), _all(n, grads), f, n)
    i = torch.argmin(scores)
    return AggResult(grads[i], _one_hot(i, n, grads), scores)


@register_rule("multikrum", min_n=lambda f: 2 * f + 3,
               invariants=("finite", "hull", "convex"),
               doc="average of m best Krum scores")
def multikrum(grads: torch.Tensor, f: int,
              m: Optional[int] = None) -> AggResult:
    """Multi-Krum: average of the m best-scored vectors (m = n - f - 2 by
    default)."""
    n = grads.shape[0]
    if m is None:
        m = max(1, n - f - 2)
    scores = krum_scores(pairwise_sq_dists(grads), _all(n, grads), f, n)
    top = top_k_total_order(-scores, m)
    sel = torch.zeros((n,), dtype=grads.dtype, device=grads.device)
    sel[top] = 1.0 / m
    return AggResult(sel @ grads, sel, scores)


@register_rule("geomed", min_n=lambda f: 2 * f + 1,
               invariants=("finite", "hull", "convex"),
               doc="medoid with smallest index")
def geomed(grads: torch.Tensor, f: int = 0) -> AggResult:
    """GeoMed: the Medoid with the smallest index (paper §2.3.3)."""
    n = grads.shape[0]
    scores = geomed_scores(pairwise_sq_dists(grads), _all(n, grads))
    i = torch.argmin(scores)
    return AggResult(grads[i], _one_hot(i, n, grads), scores)


@register_rule("brute", min_n=lambda f: 2 * f + 1,
               invariants=("finite", "hull", "convex"),
               doc="min-diameter subset average (small n only)")
def brute(grads: torch.Tensor, f: int) -> AggResult:
    """Brute (paper §2.3.1): average of the most clumped (n-f)-subset,
    the one whose largest pairwise distance is smallest."""
    n = grads.shape[0]
    if n < 2 * f + 1:
        raise ValueError(f"brute requires n >= 2f+1, got n={n}, f={f}")
    diam = brute_subset_diameters(pairwise_sq_dists(grads), n, f)
    sel, scores = _brute_weights(diam, n, f, grads.dtype)
    return AggResult(sel @ grads, sel, scores)


def _brute_weights(diam: torch.Tensor, n: int, f: int, dtype):
    """Brute's ``(n,)`` weights (1/(n-f) on the best subset) and
    per-worker scores (the diameter of the best subset holding the
    worker)."""
    idx = torch.tensor(_subsets(n, n - f), device=diam.device)
    chosen = idx[torch.argmin(diam)]
    sel = torch.zeros((n,), dtype=dtype, device=diam.device)
    sel[chosen] = 1.0 / (n - f)
    member = torch.zeros((idx.shape[0], n), dtype=torch.bool,
                         device=diam.device)
    member[torch.arange(idx.shape[0], device=diam.device)[:, None],
           idx] = True
    scores = torch.amin(torch.where(member, diam[:, None], _INF), dim=0)
    return sel, scores


def _median0(grads: torch.Tensor) -> torch.Tensor:
    """``jnp.median(axis=0)``: the mean of the two middle values for even
    n (``torch.median`` would return the lower one), and NaN for every
    column that holds a NaN (``torch.sort`` would put it last)."""
    n = grads.shape[0]
    s = torch.sort(grads, dim=0).values
    med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return torch.where(torch.isnan(grads).any(dim=0), float("nan"), med)


@register_rule("cwmed", min_n=lambda f: 2 * f + 1,
               invariants=("finite", "hull", "trimmed"),
               doc="coordinate-wise median")
def cwmed(grads: torch.Tensor, f: int = 0) -> AggResult:
    """Coordinate-wise median (Yin et al., 2018)."""
    n = grads.shape[0]
    w = torch.full((n,), 1.0 / n, dtype=grads.dtype, device=grads.device)
    return AggResult(_median0(grads), w, torch.zeros_like(w))


@register_rule("trimmed_mean", min_n=lambda f: 2 * f + 1,
               invariants=("finite", "hull", "trimmed"),
               doc="coordinate-wise trimmed mean")
def trimmed_mean(grads: torch.Tensor, f: int) -> AggResult:
    """Coordinate-wise f-trimmed mean (Yin et al., 2018)."""
    n = grads.shape[0]
    if n <= 2 * f:
        raise ValueError(f"trimmed_mean requires n > 2f, got n={n}, f={f}")
    s = torch.sort(grads, dim=0).values
    w = torch.full((n,), 1.0 / n, dtype=grads.dtype, device=grads.device)
    return AggResult(torch.mean(s[f:n - f], dim=0), w, torch.zeros_like(w))


@register_rule("centered_clip", min_n=lambda f: 2 * f + 1,
               invariants=("finite", "hull"),
               doc="iterative centered clipping")
def centered_clip(grads: torch.Tensor, f: int, tau: float = 10.0,
                  iters: int = 3) -> AggResult:
    """Centered clipping (Karimireddy et al., 2021): clip each worker's
    deviation from a running center to radius ``tau``, ``iters`` times,
    starting from the mean."""
    n = grads.shape[0]
    v = torch.mean(grads, dim=0)
    for _ in range(iters):
        delta = grads - v[None, :]
        norm = torch.linalg.vector_norm(delta, dim=1, keepdim=True)
        scale = torch.clamp_max(tau / torch.clamp_min(norm, 1e-12), 1.0)
        v = v + torch.mean(delta * scale, dim=0)
    w = torch.full((n,), 1.0 / n, dtype=grads.dtype, device=grads.device)
    return AggResult(v, w, torch.zeros_like(w))


#: the reference's historic alias of the live rule table
REGISTRY = RULES


def get_gar(name: str):
    """Resolve a GAR's dense function by name through the registry.

    Args:
      name: any name ``resolve_rule`` accepts.

    Returns:
      The ``(grads, f) -> AggResult`` callable.
    """
    return resolve_rule(name).dense_fn


def quorum(name: str, f: int) -> int:
    """Minimal n for a rule at a given f (delegates to the registry).

    Args:
      name: any name ``resolve_rule`` accepts.
      f: Byzantine bound.

    Returns:
      The smallest n the rule supports.
    """
    return _registry_quorum(name, f)
