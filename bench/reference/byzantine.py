"""Plain reference of the protocol around the model: the omniscient
L-infinity attack (paper §3.3, the §B.1 closed-form ``delta_bar``),
Bulyan over Krum (paper §4) and AdamW.

Leaves are lists of ``(n, *dims)`` float32 stacks; the rule sees their
concatenation, worker by worker.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

#: columns per block of the column-wise passes (bounds their temporaries)
BLOCK = 1 << 24


def _blocks(x: torch.Tensor):
    flat = x.reshape(x.shape[0], -1)
    for s in range(0, flat.shape[1], BLOCK):
        yield flat[:, s:s + BLOCK]


def omniscient_linf(honest: Sequence[torch.Tensor], f: int
                    ) -> List[torch.Tensor]:
    """The ``f`` Byzantine rows of every leaf: the honest mean plus
    ``delta_bar`` on every coordinate, where ``delta_bar`` is
    ``2 / sqrt(pi)`` times the mean over all coordinates of the honest
    rows' population standard deviation."""
    total, count = 0.0, 0
    for h in honest:
        for blk in _blocks(h):
            total += float(torch.sum(torch.std(blk.double(), dim=0,
                                               correction=0)))
        count += h[0].numel()
    delta = 2.0 / math.sqrt(math.pi) * total / count
    return [(h.double().mean(dim=0) + delta).float()[None]
            .expand((f,) + tuple(h.shape[1:])) for h in honest]


def sq_dists(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(n, n)`` float64 squared distances between the workers' whole
    vectors, symmetric by construction."""
    n = leaves[0].shape[0]
    d = torch.zeros((n, n), dtype=torch.float64, device=leaves[0].device)
    for leaf in leaves:
        for blk in _blocks(leaf):
            b = blk.double()
            for i in range(n):
                for j in range(i + 1, n):
                    d[i, j] += torch.sum(torch.square(b[i] - b[j]))
    return d + d.t()


def krum_picks(dist: torch.Tensor, f: int) -> List[int]:
    """Bulyan's first phase: ``theta = n - 2f`` rounds of Krum on the
    remaining workers (each scored by the sum of its ``max(1, n_rem - f -
    2)`` nearest squared distances), the winner (lowest index on a tie)
    moved to the selection."""
    n = dist.shape[0]
    rem, picked = list(range(n)), []
    for _ in range(n - 2 * f):
        k = max(1, len(rem) - f - 2)
        scores = []
        for i in rem:
            others = sorted(float(dist[i, j]) for j in rem if j != i)
            scores.append(sum(others[:k]))
        best = min(range(len(rem)), key=lambda p: (scores[p], p))
        picked.append(rem.pop(best))
    return picked


def coordinate_phase(selected: torch.Tensor, f: int) -> torch.Tensor:
    """Per coordinate of a ``(theta, ...)`` stack, the mean of the
    ``beta = theta - 2f`` values nearest the lower-middle median."""
    theta = selected.shape[0]
    beta = theta - 2 * f
    out = torch.empty(selected.shape[1:], dtype=selected.dtype,
                      device=selected.device).reshape(-1)
    s = 0
    for blk in _blocks(selected):
        med = torch.sort(blk, dim=0).values[(theta - 1) // 2]
        order = torch.argsort(torch.abs(blk - med[None]), dim=0,
                              stable=True)[:beta]
        out[s:s + blk.shape[1]] = torch.mean(
            torch.take_along_dim(blk, order, dim=0), dim=0)
        s += blk.shape[1]
    return out.reshape(selected.shape[1:])


def bulyan_krum(leaves: Sequence[torch.Tensor], f: int
                ) -> Tuple[List[torch.Tensor], List[int]]:
    """Bulyan(Krum) on the workers' concatenated vectors: the aggregate
    leaf by leaf, and the picked workers."""
    picks = krum_picks(sq_dists(leaves), f)
    idx = torch.tensor(picks, device=leaves[0].device)
    return [coordinate_phase(leaf[idx], f) for leaf in leaves], picks


def adamw(params: List[torch.Tensor], grads: List[torch.Tensor],
          m: List[torch.Tensor], v: List[torch.Tensor], step: int,
          lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          wd: float = 0.01):
    """One AdamW update (decoupled weight decay) in place; ``step`` is
    the 1-based count of updates so far, this one included."""
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (mi / c1) / (torch.sqrt(vi / c2) + eps) + wd * p
        p.sub_(lr * upd)
