"""Weights drawn on the device from the run's seed, in a few large calls.

A layout is the program's leaf order: a list of ``(path, shape)`` with
``path`` a tuple of dict keys.  The configuration's module says how each
leaf is drawn (``init_rule``).  The benchmark hands the same tree to the
program and, drawn again after the program is gone, to the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Layout = List[Tuple[Tuple[str, ...], Tuple[int, ...]]]


def _nest(pairs) -> Dict:
    tree: Dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves_of(tree, layout: Layout) -> List[torch.Tensor]:
    """The leaves of ``tree`` in ``layout``'s order."""
    out = []
    for path, _ in layout:
        node = tree
        for key in path:
            node = node[key]
        out.append(node)
    return out


def _fill(leaf: torch.Tensor, rule) -> None:
    kind = rule[0]
    if kind == "normal":
        leaf.mul_(rule[1])
    elif kind == "const":
        leaf.fill_(rule[1])
    elif kind == "log_linspace":
        lo, hi = rule[1], rule[2]
        h = leaf.shape[-1]
        leaf.copy_(torch.log(torch.linspace(lo, hi, h, dtype=leaf.dtype,
                                            device=leaf.device))
                   .expand(leaf.shape))
    else:
        raise KeyError(f"unknown init rule {rule!r}")


def draw_tree(layout: Layout, init_rule: Callable, seed: int,
              device) -> Dict:
    """One model's weights: one normal draw over every leaf's entries,
    then each leaf scaled or set by its rule.  The leaves are views of
    one buffer."""
    sizes = [math.prod(shape) for _, shape in layout]
    gen = torch.Generator(device).manual_seed(int(seed))
    buf = torch.randn(sum(sizes), generator=gen, device=device,
                      dtype=torch.float32)
    pairs, off = [], 0
    for (path, shape), size in zip(layout, sizes):
        leaf = buf[off:off + size].view(shape)
        _fill(leaf, init_rule(path, shape))
        pairs.append((path, leaf))
        off += size
    return _nest(pairs)


def draw_ensemble(layout: Layout, init_rule: Callable, seed: int, device,
                  jitters: Sequence[float], poison_scale: float) -> Dict:
    """A replica-stacked ensemble: honest replica ``k`` is the seed's
    model plus ``jitters[k]`` times each leaf's RMS times standard
    normal noise (one draw for all replicas and leaves); one last
    replica is ``-poison_scale`` times the honest replicas' mean (a
    sign-flipped, scaled model).  Leaves are ``(len(jitters) + 1,
    *shape)``."""
    base = draw_tree(layout, init_rule, seed, device)
    honest = len(jitters)
    sizes = [math.prod(shape) for _, shape in layout]
    gen = torch.Generator(device).manual_seed(int(seed) + 1)
    noise = torch.randn(honest * sum(sizes), generator=gen, device=device,
                        dtype=torch.float32)
    scale = torch.tensor(list(jitters), dtype=torch.float32, device=device)
    pairs, off = [], 0
    for (path, shape), leaf, size in zip(layout, leaves_of(base, layout),
                                         sizes):
        rms = torch.sqrt(torch.mean(torch.square(leaf)) + 1e-12)
        nz = noise[off * honest:(off + size) * honest].view(
            (honest,) + tuple(shape))
        out = torch.empty((honest + 1,) + tuple(shape), dtype=torch.float32,
                          device=device)
        out[:honest] = leaf[None] + (scale * rms).view(
            (honest,) + (1,) * len(shape)) * nz
        out[honest] = -poison_scale * torch.mean(out[:honest], dim=0)
        pairs.append((path, out))
        off += size
    del base, noise
    return _nest(pairs)
