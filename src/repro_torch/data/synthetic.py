"""Deterministic synthetic data (the port's own copy of the classification
part of ``repro/data/synthetic.py``).

The paper's MNIST / CIFAR-10 are replaced by look-alike tasks with the
same shapes and class counts: gaussian mixtures around fixed per-class
prototypes.  Everything is numpy and a pure function of (seed, step), so
both packages see bit-identical batches.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["ByzantineBatcher", "cifar_like", "mnist_like"]


def _class_means(dim: int, n_classes: int, seed: int) -> np.ndarray:
    """Sparse [0, 1] per-class prototypes lighting ~15% of the pixels."""
    rng = np.random.default_rng(seed)
    proto = rng.uniform(0.5, 1.0, (n_classes, dim))
    mask = rng.random((n_classes, dim)) < 0.15
    return (proto * mask).astype(np.float32)


def mnist_like(batch: int, step: int, *, seed: int = 0, noise: float = 0.2,
               task_seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(B, 784) float32 in [0, 1] and labels (B,) int32, 10 classes.

    Args:
      batch: sample count.
      step: stream position.
      seed: sampling seed (train and eval streams differ only here).
      noise: gaussian noise scale around the class prototype.
      task_seed: fixes the class prototypes (the task itself).

    Returns:
      ``(x, labels)``.
    """
    means = _class_means(784, 10, task_seed)
    rng = np.random.default_rng((seed, step, 1))
    labels = rng.integers(0, 10, size=batch)
    x = means[labels] + noise * rng.standard_normal((batch, 784))
    return np.clip(x, 0.0, 1.0).astype(np.float32), labels.astype(np.int32)


def cifar_like(batch: int, step: int, *, seed: int = 0, noise: float = 0.25,
               task_seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(B, 32, 32, 3) float32 in [0, 1] and labels (B,) int32, 10 classes.

    Args:
      batch: sample count.
      step: stream position.
      seed: sampling seed.
      noise: gaussian noise scale around the class prototype.
      task_seed: fixes the class prototypes.

    Returns:
      ``(x, labels)``, x in NHWC.
    """
    means = _class_means(32 * 32 * 3, 10, task_seed + 7)
    rng = np.random.default_rng((seed, step, 2))
    labels = rng.integers(0, 10, size=batch)
    x = means[labels] + noise * rng.standard_normal((batch, 32 * 32 * 3))
    return (np.clip(x, 0.0, 1.0).reshape(batch, 32, 32, 3).astype(np.float32),
            labels.astype(np.int32))


@dataclasses.dataclass
class ByzantineBatcher:
    """Per-honest-worker mini-batches: honest workers draw i.i.d. samples
    (paper §2.1); Byzantine workers need no data."""

    kind: str                    # mnist | cifar
    n_honest: int
    per_worker: int
    seed: int = 0
    noise: float = 0.2           # class-overlap knob

    def batch(self, step: int):
        """Stacked ``(n_honest, per_worker, ...)`` inputs and labels.

        Args:
          step: training step.

        Returns:
          ``(xs, ys)`` numpy arrays.
        """
        draw = {"mnist": mnist_like, "cifar": cifar_like}.get(self.kind)
        if draw is None:
            raise KeyError(self.kind)
        xs, ys = [], []
        for w in range(self.n_honest):
            x, y = draw(self.per_worker, step * self.n_honest + w,
                        seed=self.seed, noise=self.noise)
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.stack(ys)
