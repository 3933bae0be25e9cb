"""The distributed runtime (counterpart of ``repro/dist``).

Ported so far: ``robust.py``, the tree-aware aggregation engine (per-leaf
partial Grams, the distance-backend dispatch onto the CUDA kernels, the
windowed coordinate phase, per-leaf attacks); ``train.py``, the
Byzantine train step over the model zoo on one device; and the gradient
bus of ``async_train.py`` that the flat asynchronous trainer drives.
Meshes and sharding (``mesh.py``, ``sharding.py``), the ``mesh=`` path
of ``train.py`` and ``robust.py``, and the sharded asynchronous step
(``make_async_train_step``, ``init_async_state``) wait for ROADMAP item
6; robust serving (``serve.py``, ``serve_robust.py``) for item 8.
"""
from repro_torch.dist.async_train import (GradientBus, delivery_mask,
                                          init_bus, resolve_tau,
                                          staleness_excess, update_bus)
from repro_torch.dist.robust import (DistAggResult, coordinate_phase_nd,
                                     distributed_aggregate,
                                     inject_byzantine,
                                     pairwise_sq_dists_tree,
                                     resolve_distance_backend)
from repro_torch.dist.train import (DistByzantineSpec, byzantine_grads,
                                    init_agg_state, make_loss_fn,
                                    make_train_step)

__all__ = ["DistAggResult", "DistByzantineSpec", "GradientBus",
           "byzantine_grads", "coordinate_phase_nd", "delivery_mask",
           "distributed_aggregate", "init_agg_state", "init_bus",
           "inject_byzantine", "make_loss_fn", "make_train_step",
           "pairwise_sq_dists_tree", "resolve_distance_backend",
           "resolve_tau", "staleness_excess", "update_bus"]
