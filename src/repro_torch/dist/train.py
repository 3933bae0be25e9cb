"""The Byzantine train step of the distributed runtime (counterpart of
``repro/dist/train.py``), on one device.

One function runs the paper's full protocol on a model of the zoo:
per-worker forward and backward over the leading worker axis of the
batch, Byzantine injection on the stacked gradient tree, tree-aware
robust aggregation (``repro_torch.dist.robust.distributed_aggregate``,
which runs the CUDA kernels per leaf under ``distance_backend="pallas"``
or ``"fused"``), then the optimizer update.  Gradients stay a tree of
``(n, *dims)`` leaves throughout: no flat ``(n, d)`` matrix is built.

Per-worker gradients come from ``torch.func.vmap(torch.func.grad(...))``
over the worker axis, the reference's ``jax.vmap``.  ``worker_chunk``
bounds how many workers one ``vmap`` pass holds: the passes write their
rows into preallocated ``(n, *dims)`` stacks, so the activations of only
``worker_chunk`` workers are live at once.  The semantics are the same
either way (a batched product over fewer workers may round differently
in the last bits); a model at full width (gemma3-1b's 262,144 x 1,152
embedding, 1.07 GB of logits per worker at 1,024 tokens) needs it to
stay inside the card's memory.

The sharded form of this step (``mesh=``) is ROADMAP item 6; the
single-host flat trainer lives in ``repro_torch.training.trainer``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.agg.reputation import (DEFAULT_REP_DECAY, DEFAULT_REP_LR,
                                        step_size_multiplier,
                                        tree_reputation_scores,
                                        update_reputation)
from repro_torch.agg.specs import AggSpec
from repro_torch.agg.state import init_state
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.dist.robust import distributed_aggregate, inject_byzantine
from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.obs.schema import core_metrics, global_norm, selection_weight
from repro_torch.optim import Optimizer

__all__ = ["DistByzantineSpec", "byzantine_grads", "init_agg_state",
           "make_loss_fn", "make_train_step"]

#: the reference's alias of the unified spec
DistByzantineSpec = AggSpec

#: attacks that draw random numbers (from the step's generator)
_RANDOM_ATTACKS = ("random", "colluding_majority")


def init_agg_state(spec: AggSpec, params, n_workers: int):
    """Zeroed ``AggState`` for a stateful rule on the tree path.

    Args:
      spec: the protocol spec (``gar`` / ``history_window`` select the
        rule and its window).
      params: the parameter tree; only shapes and dtypes are read.
      n_workers: worker count, the leading axis of the gradient stacks.

    Returns:
      An ``AggState`` sized for per-worker gradient stacks of
      ``params``'s shapes on their device, or ``None`` when the rule is
      stateless.
    """
    rule = spec.rule()
    if not rule.stateful:
        return None
    template = tree_map(
        lambda p: torch.empty((n_workers,) + tuple(p.shape), dtype=p.dtype,
                              device="meta"), params)
    return init_state(rule, template, flat=False,
                      device=tree_leaves(params)[0].device)


def make_loss_fn(cfg: ModelConfig, impl: str = "auto") -> Callable:
    """Token-level cross-entropy (fp32 logsumexp) plus the model's aux
    loss (MoE load balancing): ``loss_fn(params, tokens, labels,
    extra=None)``."""

    def loss_fn(params, tokens, labels, extra=None):
        logits, aux = forward(params, cfg, tokens, extra, impl=impl)
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(logz - ll) + aux

    return loss_fn


def _attack_generator(seed: int, step: int,
                      device: torch.device) -> torch.Generator:
    """A generator seeded from ``(seed, step)``: the port's form of the
    reference's ``fold_in(PRNGKey(seed), step)`` (its stream differs)."""
    return torch.Generator(device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))


def _batch_tensors(batch: dict, device: torch.device):
    """``(tokens, labels[, extra])`` as tensors on ``device``."""
    args = [torch.as_tensor(batch["tokens"], device=device),
            torch.as_tensor(batch["labels"], device=device).long()]
    if batch.get("extra") is not None:
        args.append(torch.as_tensor(batch["extra"], device=device))
    return args


def _per_worker(loss_fn: Callable, params, args, worker_chunk):
    """``(losses (n,), gradient tree of (n, *dims) leaves)``: vmap over
    the worker axis, ``worker_chunk`` workers per pass."""
    vg = torch.func.vmap(torch.func.grad_and_value(loss_fn),
                         in_dims=(None,) + (0,) * len(args))
    n = args[0].shape[0]
    chunk = n if worker_chunk is None else max(1, int(worker_chunk))
    if chunk >= n:
        grads, losses = vg(params, *args)
        return losses, grads
    stacks, losses = None, []
    for s in range(0, n, chunk):
        g, l = vg(params, *(a[s:s + chunk] for a in args))
        if stacks is None:
            stacks = tree_map(lambda x: torch.empty(
                (n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device),
                g)
        for dst, src in zip(tree_leaves(stacks), tree_leaves(g)):
            dst[s:s + chunk].copy_(src)
        losses.append(l)
        del g
    return torch.cat(losses), stacks


def byzantine_grads(loss_fn: Callable, spec: AggSpec, params, batch: dict,
                    step: int, worker_chunk: Optional[int] = None):
    """The submissions of one step: every worker's gradient, then the
    last ``f`` rows overwritten by the attack.

    Args:
      loss_fn: ``loss_fn(params, tokens, labels[, extra]) -> scalar``.
      spec: the protocol spec (``attack``, ``attack_kwargs``, ``f``,
        ``seed``).
      params: the parameter tree.
      batch: ``{"tokens", "labels"[, "extra"]}`` with a leading worker
        axis on every entry (numpy arrays or tensors).
      step: the optimizer's step (the attacks that read it, and the
        seed of a random attack's generator).
      worker_chunk: workers per ``vmap`` pass (``None``: all at once).

    Returns:
      ``(losses (n,), gradient tree)`` on the parameters' device.
    """
    dev = tree_leaves(params)[0].device
    args = _batch_tensors(batch, dev)
    losses, grads = _per_worker(loss_fn, params, args, worker_chunk)
    if spec.attack != "none" and spec.f > 0:
        akw = dict(spec.attack_kwargs)
        akw.setdefault("gar_name", spec.gar)
        gen = (_attack_generator(spec.seed, step, dev)
               if spec.attack in _RANDOM_ATTACKS else None)
        grads = inject_byzantine(grads, spec.f, spec.attack, gen,
                                 step=step, **akw)
    return losses, grads


def make_train_step(cfg: ModelConfig, spec: DistByzantineSpec,
                    optimizer: Optimizer, impl: str = "auto", mesh=None,
                    worker_chunk: Optional[int] = None) -> Callable:
    """Build the Byzantine train step.

    Stateless rules get ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; a stateful rule (``buffered-*``,
    ``centered_clip_momentum``, ``stale-*``, ``reputation-*``) gets
    ``step(params, opt_state, batch, agg_state) -> (params, opt_state,
    metrics, agg_state)`` with the ``AggState`` carried by the caller
    (see :func:`init_agg_state`).  ``reputation-*`` runs also honor
    ``spec.aux_batch`` (a clean ``(tokens, labels[, extra])`` batch whose
    gradient scores the raw submissions, overriding the rule's own
    agreement update) and a set ``spec.rep_lr`` (the aggregate is scaled
    by ``step_size_multiplier``, reported as ``metrics["step_scale"]``).

    Args:
      cfg: the model configuration.
      spec: the protocol spec.
      optimizer: the port's optimizer (nested trees).
      impl: attention path of the forward.
      mesh: must be ``None``; the sharded step is ROADMAP item 6.
      worker_chunk: workers per ``vmap`` pass of the per-worker
        gradients (``None``: all at once; see the module docstring).

    Returns:
      The step.  ``batch`` is ``{"tokens", "labels"[, "extra"]}`` with a
      leading worker axis ``(n_workers, per_worker_batch, ...)``; every
      worker computes a real gradient, and under an attack the last
      ``f`` rows are overwritten by the omniscient adversary, which reads
      the honest gradients first.  Metrics are 0-d tensors with the
      reference's names.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= needs the sharded runtime, which is not ported yet "
            "(ROADMAP item 6)")
    loss_fn = make_loss_fn(cfg, impl)
    rule = spec.rule()
    stateful = rule.stateful
    reputed = "reputation" in rule.state_fields

    def run_step(params, opt_state, batch, agg_state):
        n = batch["tokens"].shape[0]
        spec.validate(n, distributed=True)
        n_h = n - spec.f
        losses, grads = byzantine_grads(loss_fn, spec, params, batch,
                                        opt_state["step"], worker_chunk)
        out = distributed_aggregate(
            grads, spec.f_declared, spec.effective_gar,
            agg_dtype=spec.agg_dtype,
            distance_backend=spec.distance_backend,
            state=agg_state, history_window=spec.history_window,
            rep_lr=spec.rep_lr, rep_decay=spec.rep_decay)
        agg, res = out[0], out[1]
        new_agg_state = out[2] if stateful else None

        step_scale = None
        if reputed:
            if spec.aux_batch is not None:
                # ByGARS proper: score the raw submissions against the
                # clean auxiliary gradient, the one signal a colluding
                # majority cannot vote on
                dev = tree_leaves(params)[0].device
                aux = [torch.as_tensor(a, device=dev)
                       for a in spec.aux_batch]
                aux[1] = aux[1].long()
                clean = torch.func.grad(loss_fn)(params, *aux)
                scores = tree_reputation_scores(tree_leaves(grads),
                                                tree_leaves(clean))
                lr = DEFAULT_REP_LR if spec.rep_lr is None else spec.rep_lr
                decay = (DEFAULT_REP_DECAY if spec.rep_decay is None
                         else spec.rep_decay)
                new_agg_state = new_agg_state._replace(
                    reputation=update_reputation(
                        agg_state.reputation, scores, lr, decay))
            step_scale = torch.ones((), dtype=torch.float32,
                                    device=res.selected.device)
            if spec.rep_lr:
                # the same carried trust scales the update magnitude
                step_scale = step_size_multiplier(new_agg_state)
                agg = tree_map(lambda a: (a.to(torch.float32) * step_scale)
                               .to(a.dtype), agg)
        new_params, new_opt = optimizer.update(agg, opt_state, params)

        honest_mean = tree_map(
            lambda g: torch.mean(g[:n_h].to(torch.float32), dim=0), grads)
        dev_tree = tree_map(lambda a, m: a.to(torch.float32) - m, agg,
                            honest_mean)
        metrics = core_metrics(
            loss=torch.mean(losses[:n_h]),
            grad_norm=global_norm(agg),
            agg_dev=global_norm(dev_tree),
            byz_weight=selection_weight(res.selected, n_h),
            step_scale=step_scale)
        return new_params, new_opt, metrics, new_agg_state

    if stateful:
        return run_step

    def step(params, opt_state, batch):
        return run_step(params, opt_state, batch, None)[:3]

    return step
