"""The distributed runtime (counterpart of ``repro/dist``).

  mesh.py         meshes over ``torch.distributed`` ranks (one process
                  per mesh position, a process group per axis, the
                  collectives) and ``run_on_mesh``, the rank launcher
  sharding.py     the reference's partition rules leaf by leaf (``P``
                  per leaf) and the moves between a rank's slice and
                  the whole leaf
  robust.py       the tree-aware aggregation engine: per-leaf partial
                  Grams (K1 per leaf, or per local slice with the
                  ``(n, n)`` partials all-reduced over ``model``), the
                  distance-backend dispatch, the windowed coordinate
                  phase, per-leaf attacks
  tensor_parallel.py  the ``model`` axis inside one worker or replica:
                  the split forward's collectives as autograd Functions
                  (with ``vmap`` rules for the serving steps' replica
                  axis), the ``Shard`` the models read, the serving
                  layout, the vocabulary-parallel cross-entropy
  train.py        the Byzantine train step over the model zoo, on one
                  device or on every rank of a mesh
  async_train.py  the gradient bus and the asynchronous train step
  serve.py        prefill and decode steps (with ``mesh=``, on the
                  rank's ``param_shardings`` slices), the serving layout
  serve_robust.py the Byzantine-resilient ensemble (replica stacks,
                  poisoning, robust logits aggregation, the prefill /
                  decode / speculative-verify steps), on one device or
                  with ``mesh=`` (replicas on ``data``, each replica's
                  inner dims and the vocabulary of the logits stack on
                  ``model``)
"""
from repro_torch.dist.mesh import (make_host_mesh, make_production_mesh,
                                   mesh_axis_sizes, run_on_mesh)
from repro_torch.dist.robust import (DistAggResult, coordinate_phase_nd,
                                     distributed_aggregate,
                                     inject_byzantine,
                                     pairwise_sq_dists_tree,
                                     resolve_distance_backend)
from repro_torch.dist.sharding import (batch_pspec, cache_shardings,
                                       ensemble_cache_shardings,
                                       ensemble_param_shardings, gram_pspec,
                                       param_shardings)
from repro_torch.dist.train import (DistByzantineSpec, byzantine_grads,
                                    init_agg_state, make_loss_fn,
                                    make_train_step)
from repro_torch.dist.async_train import (GradientBus, delivery_mask,
                                          init_async_state, init_bus,
                                          make_async_train_step,
                                          resolve_tau, staleness_excess,
                                          update_bus)
from repro_torch.dist.serve import make_prefill_step, make_serve_step
from repro_torch.dist.serve_robust import (aggregate_logits,
                                           init_ensemble_state,
                                           make_robust_prefill_step,
                                           make_robust_serve_step,
                                           poison_replicas, replicate_cache,
                                           replicate_params, stack_replicas)

__all__ = [
    "DistAggResult", "DistByzantineSpec", "GradientBus", "aggregate_logits",
    "batch_pspec", "byzantine_grads", "cache_shardings",
    "coordinate_phase_nd", "delivery_mask", "distributed_aggregate",
    "ensemble_cache_shardings", "ensemble_param_shardings", "gram_pspec",
    "init_agg_state", "init_async_state", "init_bus", "init_ensemble_state",
    "inject_byzantine", "make_async_train_step", "make_host_mesh",
    "make_loss_fn", "make_prefill_step", "make_production_mesh",
    "make_robust_prefill_step", "make_robust_serve_step", "make_serve_step",
    "make_train_step", "mesh_axis_sizes", "pairwise_sq_dists_tree",
    "param_shardings", "poison_replicas", "replicate_cache",
    "replicate_params", "resolve_distance_backend", "resolve_tau",
    "run_on_mesh", "stack_replicas", "staleness_excess", "update_bus",
]
