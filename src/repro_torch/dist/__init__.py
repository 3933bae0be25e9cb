"""The distributed runtime (counterpart of ``repro/dist``).

Ported so far: ``robust.py``, the tree-aware aggregation engine (per-leaf
partial Grams, the distance-backend dispatch onto the CUDA kernels, the
windowed coordinate phase, per-leaf attacks).  Meshes, sharding, the
sharded and asynchronous train steps and robust serving wait for ROADMAP
items 7, 9 and 11.
"""
from repro_torch.dist.robust import (DistAggResult, coordinate_phase_nd,
                                     distributed_aggregate,
                                     inject_byzantine,
                                     pairwise_sq_dists_tree,
                                     resolve_distance_backend)

__all__ = ["DistAggResult", "coordinate_phase_nd", "distributed_aggregate",
           "inject_byzantine", "pairwise_sq_dists_tree",
           "resolve_distance_backend"]
