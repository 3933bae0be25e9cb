"""The distributed runtime (counterpart of ``repro/dist``).

Ported so far: ``robust.py``, the tree-aware aggregation engine (per-leaf
partial Grams, the distance-backend dispatch onto the CUDA kernels, the
windowed coordinate phase, per-leaf attacks), and the gradient bus of
``async_train.py`` that the flat asynchronous trainer drives.  Meshes,
sharding, the sharded train steps and robust serving wait for ROADMAP
items 6 and 8.
"""
from repro_torch.dist.async_train import (GradientBus, delivery_mask,
                                          init_bus, resolve_tau,
                                          staleness_excess, update_bus)
from repro_torch.dist.robust import (DistAggResult, coordinate_phase_nd,
                                     distributed_aggregate,
                                     inject_byzantine,
                                     pairwise_sq_dists_tree,
                                     resolve_distance_backend)

__all__ = ["DistAggResult", "GradientBus", "coordinate_phase_nd",
           "delivery_mask", "distributed_aggregate", "init_bus",
           "inject_byzantine", "pairwise_sq_dists_tree",
           "resolve_distance_backend", "resolve_tau", "staleness_excess",
           "update_bus"]
