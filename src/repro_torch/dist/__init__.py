"""The distributed runtime (counterpart of ``repro/dist``).

Ported so far: ``robust.py``, the tree-aware aggregation engine (per-leaf
partial Grams, the distance-backend dispatch onto the CUDA kernels, the
windowed coordinate phase, per-leaf attacks); ``train.py``, the
Byzantine train step over the model zoo on one device; the gradient bus
of ``async_train.py`` that the flat asynchronous trainer drives; and
serving, ``serve.py`` (prefill and decode steps) and ``serve_robust.py``
(the Byzantine-resilient ensemble: replica stacks, poisoning, robust
logits aggregation, the prefill / decode / speculative-verify steps).
Meshes and sharding (``mesh.py``, ``sharding.py``), the ``mesh=`` paths
and the sharded asynchronous step (``make_async_train_step``,
``init_async_state``) wait for ROADMAP item 6.
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
from repro_torch.dist.serve import make_prefill_step, make_serve_step
from repro_torch.dist.serve_robust import (aggregate_logits,
                                           init_ensemble_state,
                                           make_robust_prefill_step,
                                           make_robust_serve_step,
                                           poison_replicas, replicate_cache,
                                           replicate_params, stack_replicas)

__all__ = ["DistAggResult", "DistByzantineSpec", "GradientBus",
           "aggregate_logits", "byzantine_grads", "coordinate_phase_nd",
           "delivery_mask", "distributed_aggregate", "init_agg_state",
           "init_bus", "init_ensemble_state", "inject_byzantine",
           "make_loss_fn", "make_prefill_step", "make_robust_prefill_step",
           "make_robust_serve_step", "make_serve_step", "make_train_step",
           "pairwise_sq_dists_tree", "poison_replicas", "replicate_cache",
           "replicate_params", "resolve_distance_backend", "resolve_tau",
           "stack_replicas", "staleness_excess", "update_bus"]
