"""Optimizers and the paper's fading learning-rate schedule."""
from repro_torch.optim.optimizers import (Optimizer, adam, adamw, fading_lr,
                                          get_optimizer, momentum, sgd)

__all__ = ["Optimizer", "adam", "adamw", "fading_lr", "get_optimizer",
           "momentum", "sgd"]
