"""The reference's Byzantine train steps: every honest worker's loss and
gradient from the plain model, the omniscient attack on the last ``f``
rows, Bulyan(Krum), then AdamW; and what the cell compares.
"""
from __future__ import annotations

import statistics
from typing import Callable, Dict, List

import torch

from bench.reference import byzantine


def steps(logits_fn: Callable, params: List[torch.Tensor], unflatten,
          batches, n: int, f: int, lr: float, count: int) -> Dict:
    """``count`` steps from ``params`` (a list of leaves, updated in
    place).

    Args:
      logits_fn: ``logits_fn(tree, tokens (S,)) -> (S, V)``.
      params: the leaves.
      unflatten: leaves -> the tree ``logits_fn`` reads.
      batches: ``count`` ``(tokens, labels)`` tensors of shape
        ``(n, per_worker, seq)``.
      n, f: workers and the Byzantine bound.
      lr: AdamW's rate.
      count: steps.

    Returns:
      ``losses`` (the honest workers' mean loss before each step),
      ``grad1`` (each leaf's norm of the first aggregated gradient) and
      ``change`` (each leaf's norm of its change over the steps).
    """
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, grad1 = [], None
    for t in range(count):
        tokens, labels = batches[t]
        stacks = [torch.empty((n,) + tuple(p.shape), dtype=p.dtype,
                              device=p.device) for p in params]
        honest_loss = 0.0
        for w in range(n - f):
            leaves = [p.detach().requires_grad_() for p in params]
            tree = unflatten(leaves)
            per = tokens.shape[1]
            for b in range(per):
                lg = logits_fn(tree, tokens[w, b])
                nll = torch.logsumexp(lg, dim=-1) - lg.gather(
                    -1, labels[w, b].long()[:, None])[:, 0]
                loss = nll.mean() / per
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
                for st, g in zip(stacks, gs):
                    if g is None:
                        g = torch.zeros_like(st[w])
                    if b == 0:
                        st[w].copy_(g)
                    else:
                        st[w].add_(g)
                honest_loss += float(loss.detach())
                del lg, nll, loss, gs
            del leaves, tree
        losses.append(honest_loss / (n - f))
        byz = byzantine.omniscient_linf([s[:n - f] for s in stacks], f)
        for st, b in zip(stacks, byz):
            st[n - f:] = b
        agg, _ = byzantine.bulyan_krum(stacks, f)
        del stacks, byz
        if t == 0:
            grad1 = [float(torch.linalg.vector_norm(a.double()))
                     for a in agg]
        byzantine.adamw([p.data for p in params], agg, m, v, t + 1, lr)
        del agg
    change = [float(torch.linalg.vector_norm((p - s).double()))
              for p, s in zip(params, start)]
    return {"losses": losses, "grad1": grad1, "change": change}


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a train cell may compare (its limits file names those
    it does).

    ``loss``: the largest relative gap of a step's loss; ``loss1``: the
    first step's.  ``grad1`` and ``change``: the worst leaf's gap between
    the program's norm and the reference's, over the reference's norm of
    that leaf or of the median leaf, whichever is larger;
    ``grad1_median``: the median leaf's such gap.  Leaves whose first
    reference gradient is under a thousandth of the median leaf's (a
    key's bias under softmax) move by round-off alone and are left out
    of ``change``.
    """
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    g_med = statistics.median(ref["grad1"])
    leaf = [abs(a - b) / max(b, g_med)
            for a, b in zip(prog["grad1"], ref["grad1"])]
    kept = [k for k, g in enumerate(ref["grad1"]) if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][k] for k in kept)
    change = max(abs(prog["change"][k] - ref["change"][k])
                 / max(ref["change"][k], c_med) for k in kept)
    return {"loss": max(steps), "loss1": steps[0], "grad1": max(leaf),
            "grad1_median": statistics.median(leaf), "change": change}
