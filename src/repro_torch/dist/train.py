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

With ``mesh=`` the step runs on every rank of a
``repro_torch.dist.mesh.Mesh`` (explicit SPMD: one process per mesh
position, where the reference partitions one program with GSPMD):

  * parameters and optimizer state are stored as each rank's slices in
    the ``param_shardings`` layout of ``template`` (the global parameter
    tree); each step all-gathers them over ``model`` for the forward and
    backward (a tensor-parallel forward is not ported);
  * rank ``(i, j)`` computes the gradients of its ``data`` slice's
    workers (every worker when the axis does not divide n, the
    reference's replicate rule) and keeps only its ``model`` slice of
    each, in the ``gram_pspec`` layout, after each ``worker_chunk``
    pass; the slices are then all-gathered over ``data``, so every rank
    holds all n rows of its coordinates;
  * the attack, the aggregation (K1 per local slice under ``pallas``)
    and the metrics' reductions over coordinates are all-reduced over
    ``model`` (``repro_torch.dist.robust``); the aggregate goes back to
    the parameter layout and the optimizer updates each rank's slices.

Apart from the summation order of those reductions the step computes
the single-device step's values.  The single-host flat trainer lives in
``repro_torch.training.trainer``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.agg.reputation import (DEFAULT_REP_DECAY, DEFAULT_REP_LR,
                                        step_size_multiplier,
                                        tree_reputation_scores,
                                        update_reputation)
from repro_torch.agg.specs import AggSpec
from repro_torch.agg.state import init_state
from repro_torch.core.pytree import (sum_in_order, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.dist.robust import (_shards, distributed_aggregate,
                                     inject_byzantine)
from repro_torch.dist.sharding import (_spec_leaves, gather_tree,
                                       gram_shardings, local_shard,
                                       local_shape, model_dim,
                                       param_shardings, replica_rows)
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


def init_agg_state(spec: AggSpec, params, n_workers: int, mesh=None):
    """Zeroed ``AggState`` for a stateful rule on the tree path.

    Args:
      spec: the protocol spec (``gar`` / ``history_window`` select the
        rule and its window).
      params: the parameter tree; only shapes and dtypes are read (under
        a mesh, the global tree: ``"meta"`` tensors work).
      n_workers: worker count, the leading axis of the gradient stacks.
      mesh: the step's mesh, or ``None``.

    Returns:
      An ``AggState`` sized for per-worker gradient stacks of
      ``params``'s shapes on their device (under a mesh, this rank's
      ``gram_pspec`` slices on the mesh's device), or ``None`` when the
      rule is stateless.
    """
    rule = spec.rule()
    if not rule.stateful:
        return None
    template, dev = _state_template(params, n_workers, mesh)
    return init_state(rule, template, flat=False, device=dev)


def _state_template(params, n_workers: int, mesh):
    """Meta tensors shaped like one rank's gradient stacks, and where the
    state lives."""
    if mesh is None:
        template = tree_map(
            lambda p: torch.empty((n_workers,) + tuple(p.shape),
                                  dtype=p.dtype, device="meta"), params)
        return template, tree_leaves(params)[0].device
    leaves = tree_leaves(params)
    specs = _spec_leaves(gram_shardings(params, mesh))
    return tree_unflatten(params, [
        torch.empty(local_shape((n_workers,) + tuple(p.shape), s, mesh),
                    dtype=p.dtype, device="meta")
        for p, s in zip(leaves, specs)]), mesh.device


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
    reference's ``fold_in(PRNGKey(seed), step)`` (its stream differs);
    ``None`` on the ``meta`` device, where a trace draws without one."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))


def _batch_tensors(batch: dict, device: torch.device):
    """``(tokens, labels[, extra])`` as tensors on ``device``."""
    args = [torch.as_tensor(batch["tokens"], device=device),
            torch.as_tensor(batch["labels"], device=device).long()]
    if batch.get("extra") is not None:
        args.append(torch.as_tensor(batch["extra"], device=device))
    return args


def _per_worker(loss_fn: Callable, params, args, worker_chunk, keep=None):
    """``(losses (n,), gradient tree of (n, *dims) leaves)``: vmap over
    the worker axis, ``worker_chunk`` workers per pass; ``keep(k, g)``
    (under a mesh) cuts each pass's leaf ``k`` to the slice kept."""
    vg = torch.func.vmap(torch.func.grad_and_value(loss_fn),
                         in_dims=(None,) + (0,) * len(args))
    n = args[0].shape[0]
    chunk = n if worker_chunk is None else max(1, int(worker_chunk))
    if chunk >= n:
        grads, losses = vg(params, *args)
        if keep is not None:
            grads = tree_unflatten(grads, [
                keep(k, g).clone(memory_format=torch.contiguous_format)
                for k, g in enumerate(tree_leaves(grads))])
        return losses, grads
    stacks, losses = None, []
    for s in range(0, n, chunk):
        g, l = vg(params, *(a[s:s + chunk] for a in args))
        if keep is not None:
            g = tree_unflatten(g, [keep(k, x) for k, x in
                                   enumerate(tree_leaves(g))])
        if stacks is None:
            stacks = tree_map(lambda x: torch.empty(
                (n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device),
                g)
        for dst, src in zip(tree_leaves(stacks), tree_leaves(g)):
            dst[s:s + chunk].copy_(src)
        losses.append(l)
        del g
    return torch.cat(losses), stacks


class _MeshLayout:
    """One rank's layout of the sharded step: the parameters' and the
    gradients' specs (from the global ``template``) and the moves between
    them."""

    def __init__(self, mesh, template):
        if template is None:
            raise ValueError(
                "mesh= needs template=: the global parameter tree (only "
                "shapes are read), whose param_shardings / gram_pspec "
                "layouts the ranks' slices follow")
        self.mesh = mesh
        self.param_specs = param_shardings(template, mesh)
        self.gram_specs = gram_shardings(template, mesh)
        self.pspecs = _spec_leaves(self.param_specs)
        self.gspecs = _spec_leaves(self.gram_specs)
        self.shards = _shards(mesh, self.gram_specs, len(self.gspecs))

    def whole(self, params):
        """The whole parameter tree from this rank's slices."""
        return gather_tree(params, self.param_specs, self.mesh)

    def keep(self, k: int, g: torch.Tensor) -> torch.Tensor:
        """This rank's ``gram_pspec`` slice of a pass's gradient leaf."""
        return local_shard(g, self.gspecs[k], self.mesh)

    def rows(self, n: int) -> Tuple[slice, bool]:
        """This rank's workers and whether ``data`` splits them (the
        rule that places replicas, ``sharding.replica_rows``)."""
        return replica_rows(n, self.mesh)

    def total(self, parts):
        """Per-leaf partial reductions -> their total over every rank's
        slices (replicated leaves once)."""
        return sum_in_order(parts) if self.shards is None else (
            self.shards.total(parts))

    def norm(self, tree) -> torch.Tensor:
        """``global_norm`` over every rank's slices."""
        return torch.sqrt(self.total([
            torch.sum(x.to(torch.float32) * x.to(torch.float32))
            for x in tree_leaves(tree)]))

    def grads_like(self, tree):
        """A per-worker-shaped tree (no worker axis) cut to this rank's
        ``gram_pspec`` slices."""
        return tree_unflatten(tree, [
            self.keep(k, x[None])[0] for k, x in
            enumerate(tree_leaves(tree))])

    def to_params(self, agg):
        """The aggregate (``gram_pspec`` slices without the worker axis)
        in the parameters' layout: gathered over ``model`` and cut again
        where the two rules split different dims."""
        out = []
        for a, gs, ps in zip(tree_leaves(agg), self.gspecs, self.pspecs):
            gd = model_dim(gs)
            gd = None if gd is None else gd - 1
            pd = model_dim(ps)
            if gd != pd:
                if gd is not None:
                    a = self.mesh.all_gather(a, "model", gd)
                if pd is not None:
                    w = a.shape[pd] // self.mesh.size("model")
                    a = a.narrow(pd, self.mesh.index("model") * w, w)
            out.append(a)
        return tree_unflatten(agg, out)

    def submissions(self, loss_fn, full, args, worker_chunk):
        """``(losses (n,), gradient slices (n, *local))``: this rank's
        workers' gradients cut to its ``model`` slices pass by pass, then
        gathered over ``data``; replicated leaves are sent from the
        rank at ``model`` index 0, so they are the same on every rank."""
        mesh = self.mesh
        rows, split = self.rows(args[0].shape[0])
        losses, grads = _per_worker(loss_fn, full,
                                    [a[rows] for a in args], worker_chunk,
                                    keep=self.keep)
        if split:
            losses = mesh.all_gather(losses, "data", 0)
            grads = tree_map(lambda g: mesh.all_gather(g, "data", 0), grads)
        if self.shards is not None:
            grads = tree_unflatten(grads, [
                g if d is not None else mesh.broadcast(g, "model", 0)
                for g, d in zip(tree_leaves(grads), self.shards.dims)])
        return losses, grads


def _submissions(loss_fn: Callable, spec: AggSpec, params, batch: dict,
                 gen_step: int, attack_step: int, worker_chunk,
                 layout: Optional[_MeshLayout], prev=None):
    """``(losses, submissions, whole parameters)`` of one step: every
    worker's gradient, then the attack on the last ``f`` rows (its
    generator from ``gen_step``, its ``step`` ``attack_step``; ``prev``
    for the delay attacks)."""
    if layout is None:
        full = params
        dev = tree_leaves(params)[0].device
    else:
        full = layout.whole(params)
        dev = layout.mesh.device
    args = _batch_tensors(batch, dev)
    if layout is None:
        losses, grads = _per_worker(loss_fn, full, args, worker_chunk)
    else:
        losses, grads = layout.submissions(loss_fn, full, args,
                                           worker_chunk)
    if spec.attack != "none" and spec.f > 0:
        akw = dict(spec.attack_kwargs)
        akw.setdefault("gar_name", spec.gar)
        if prev is not None:
            akw.setdefault("prev", prev)
        if layout is not None:
            akw.update(mesh=layout.mesh, specs=layout.gram_specs)
        gen = (_attack_generator(spec.seed, gen_step, dev)
               if spec.attack in _RANDOM_ATTACKS else None)
        grads = inject_byzantine(grads, spec.f, spec.attack, gen,
                                 step=attack_step, **akw)
    return losses, grads, full


def byzantine_grads(loss_fn: Callable, spec: AggSpec, params, batch: dict,
                    step: int, worker_chunk: Optional[int] = None, *,
                    mesh=None, template=None):
    """The submissions of one step: every worker's gradient, then the
    last ``f`` rows overwritten by the attack.

    Args:
      loss_fn: ``loss_fn(params, tokens, labels[, extra]) -> scalar``.
      spec: the protocol spec (``attack``, ``attack_kwargs``, ``f``,
        ``seed``).
      params: the parameter tree (under a mesh, this rank's
        ``param_shardings`` slices of ``template``).
      batch: ``{"tokens", "labels"[, "extra"]}`` with a leading worker
        axis on every entry (numpy arrays or tensors; under a mesh the
        whole batch, on every rank).
      step: the optimizer's step (the attacks that read it, and the
        seed of a random attack's generator).
      worker_chunk: workers per ``vmap`` pass (``None``: all at once).
      mesh: the mesh of the sharded step, or ``None``.
      template: under a mesh, the global parameter tree (shapes only).

    Returns:
      ``(losses (n,), gradient tree)`` on the parameters' device; under
      a mesh every worker's row of this rank's ``gram_pspec`` slices.
    """
    layout = None if mesh is None else _MeshLayout(mesh, template)
    losses, grads, _ = _submissions(loss_fn, spec, params, batch, step,
                                    step, worker_chunk, layout)
    return losses, grads


def make_train_step(cfg: ModelConfig, spec: DistByzantineSpec,
                    optimizer: Optimizer, impl: str = "auto", mesh=None,
                    worker_chunk: Optional[int] = None,
                    template=None, observe: Optional[Callable] = None
                    ) -> Callable:
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
      mesh: ``None`` for one device, or this rank's
        ``repro_torch.dist.mesh.Mesh`` (see the module docstring): then
        ``params`` and ``opt_state`` are this rank's ``param_shardings``
        slices (``repro_torch.dist.sharding.shard_tree``), ``batch`` the
        whole batch on every rank, and a stateful ``agg_state`` this
        rank's slices (``init_agg_state(..., mesh=mesh)``).
      worker_chunk: workers per ``vmap`` pass of the per-worker
        gradients (``None``: all at once; see the module docstring).
      template: with a mesh, the global parameter tree whose layouts the
        slices follow (only shapes are read: ``"meta"`` tensors work).
      observe: ``None``, or ``observe(submissions, result)``, called in
        each step right after the aggregation with the worker-stacked
        submissions (this rank's slices under a mesh) and the rule's
        result (``selected``): a check's view of what the step
        aggregated, without a second forward and backward.

    Returns:
      The step.  ``batch`` is ``{"tokens", "labels"[, "extra"]}`` with a
      leading worker axis ``(n_workers, per_worker_batch, ...)``; every
      worker computes a real gradient, and under an attack the last
      ``f`` rows are overwritten by the omniscient adversary, which reads
      the honest gradients first.  Metrics are 0-d tensors with the
      reference's names (under a mesh the same on every rank, up to the
      order of the reductions over ``model``).
    """
    loss_fn = make_loss_fn(cfg, impl)
    rule = spec.rule()
    stateful = rule.stateful
    reputed = "reputation" in rule.state_fields
    layout = None if mesh is None else _MeshLayout(mesh, template)

    def run_step(params, opt_state, batch, agg_state):
        n = batch["tokens"].shape[0]
        spec.validate(n, distributed=True)
        n_h = n - spec.f
        t = opt_state["step"]
        losses, grads, full = _submissions(loss_fn, spec, params, batch, t,
                                           t, worker_chunk, layout)
        out = distributed_aggregate(
            grads, spec.f_declared, spec.effective_gar,
            agg_dtype=spec.agg_dtype,
            distance_backend=spec.distance_backend, mesh=mesh,
            state=agg_state, history_window=spec.history_window,
            rep_lr=spec.rep_lr, rep_decay=spec.rep_decay,
            specs=None if layout is None else layout.gram_specs)
        agg, res = out[0], out[1]
        if observe is not None:
            observe(grads, res)
        new_agg_state = out[2] if stateful else None
        step_scale = None
        if reputed:
            new_agg_state, agg, step_scale = _reputation_tail(
                spec, loss_fn, full, grads, agg, res, agg_state,
                new_agg_state, layout)
        return _finish(optimizer, params, opt_state, agg, grads, losses,
                       res, n_h, step_scale, layout) + (new_agg_state,)

    if stateful:
        return run_step

    def step(params, opt_state, batch):
        return run_step(params, opt_state, batch, None)[:3]

    return step


def _reputation_tail(spec: AggSpec, loss_fn, full, grads, agg, res,
                     agg_state, new_agg_state, layout):
    """``reputation-*``'s step tail: the clean-batch scores (with
    ``spec.aux_batch``) and the trust-scaled aggregate (with
    ``spec.rep_lr``).  Returns ``(state, aggregate, step_scale)``."""
    if spec.aux_batch is not None:
        # ByGARS proper: score the raw submissions against the clean
        # auxiliary gradient, the one signal a colluding majority cannot
        # vote on
        dev = tree_leaves(grads)[0].device
        aux = [torch.as_tensor(a, device=dev) for a in spec.aux_batch]
        aux[1] = aux[1].long()
        clean = torch.func.grad(loss_fn)(full, *aux)
        total = None
        if layout is not None:
            clean = layout.grads_like(clean)
            total = layout.total
        scores = tree_reputation_scores(tree_leaves(grads),
                                        tree_leaves(clean), total=total)
        lr = DEFAULT_REP_LR if spec.rep_lr is None else spec.rep_lr
        decay = (DEFAULT_REP_DECAY if spec.rep_decay is None
                 else spec.rep_decay)
        new_agg_state = new_agg_state._replace(
            reputation=update_reputation(agg_state.reputation, scores, lr,
                                         decay))
    step_scale = torch.ones((), dtype=torch.float32,
                            device=res.selected.device)
    if spec.rep_lr:
        # the same carried trust scales the update magnitude
        step_scale = step_size_multiplier(new_agg_state)
        agg = tree_map(lambda a: (a.to(torch.float32) * step_scale)
                       .to(a.dtype), agg)
    return new_agg_state, agg, step_scale


def _finish(optimizer: Optimizer, params, opt_state, agg, grads, losses,
            res, n_h: int, step_scale, layout, extra=None):
    """The optimizer update and the metrics: ``(params, opt_state,
    metrics)``."""
    new_params, new_opt = optimizer.update(
        agg if layout is None else layout.to_params(agg), opt_state, params)
    honest_mean = tree_map(
        lambda g: torch.mean(g[:n_h].to(torch.float32), dim=0), grads)
    dev_tree = tree_map(lambda a, m: a.to(torch.float32) - m, agg,
                        honest_mean)
    norm = global_norm if layout is None else layout.norm
    metrics = core_metrics(
        loss=torch.mean(losses[:n_h]),
        grad_norm=norm(agg),
        agg_dev=norm(dev_tree),
        byz_weight=selection_weight(res.selected, n_h),
        step_scale=step_scale)
    if extra:
        metrics.update(extra)
    return new_params, new_opt, metrics
