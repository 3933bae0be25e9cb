"""Deterministic synthetic data (numpy, bit-identical to the reference)."""
from repro_torch.data.synthetic import (ByzantineBatcher, cifar_like,
                                        lm_batches, mnist_like)

__all__ = ["ByzantineBatcher", "cifar_like", "lm_batches", "mnist_like"]
