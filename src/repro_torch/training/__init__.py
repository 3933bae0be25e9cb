"""The flat Byzantine trainers, synchronous and asynchronous."""
from repro_torch.training.trainer import (AsyncByzantineTrainer,
                                          ByzantineSpec, ByzantineTrainer,
                                          init_flat_agg_state,
                                          init_flat_async_state,
                                          make_async_byzantine_step,
                                          make_byzantine_step)

__all__ = ["AsyncByzantineTrainer", "ByzantineSpec", "ByzantineTrainer",
           "init_flat_agg_state", "init_flat_async_state",
           "make_async_byzantine_step", "make_byzantine_step"]
