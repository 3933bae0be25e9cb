"""Byzantine-resilient ensemble serving: robust aggregation at decode
time (counterpart of ``repro/dist/serve_robust.py``).

The paper's claim, that one Byzantine participant exploits the
``Omega(sqrt(d))`` leeway of convergent aggregation rules, holds for an
inference-time ensemble as it does for training: ``n`` replica
parameter sets each produce per-token logits, and a master that
averages them hands one poisoned replica every greedy decode.  This
module is the serving side of ``repro_torch.dist.robust``:

* replicas are a stacked parameter tree, every leaf with a leading
  ``(n_replicas,)`` axis (:func:`stack_replicas` /
  :func:`replicate_params`); the steps run the replicas through
  ``torch.func.vmap`` over that axis, and the decode and verify steps
  write the replica-stacked cache (:func:`replicate_cache`) in place;
* poisoning reuses the training side's attacks:
  :func:`poison_replicas` rewrites the last ``f`` replicas' parameters
  through ``inject_byzantine``, and ``spec.attack`` poisons the stacked
  logits at decode time;
* aggregation is the registry applied to the ``(n, B, V)`` logits stack
  of each decode step (:func:`aggregate_logits`, a one-leaf tree into
  ``distributed_aggregate``), so under ``distance_backend="fused"`` every
  step runs K5 (the selection kernel between K1 and K4) on ``(n, B V)``;
  stateful rules carry an ``AggState`` across tokens.

The continuous-batching engine is ``repro_torch.serving.engine``
(``ServingEngine(..., ensemble=spec)``).

With ``mesh=`` (a ``repro_torch.dist.mesh.Mesh``; explicit SPMD, every
rank runs the same steps on the same requests) a rank holds its share of
the ensemble as ``ensemble_param_shardings`` lays it out: its replicas
(``data`` splits the ensemble where it divides, else every replica on
every rank), each cut to its ``model`` slices, in the serving layout
(``dist.serve.serve_specs``: the few leaves a layer reads whole, norm
scales, biases, the router and the SSM's conv and decay leaves, kept
whole, so no step gathers a parameter); :func:`ensemble_share` cuts it
from the whole ensemble.  The steps run the rank's replicas through
``vmap`` on the split forward (``models.decode`` with ``shard=``); each
collective of ``repro_torch.dist.tensor_parallel`` has a ``vmap`` rule,
so it runs once on the rank's ``(n / data, ...)`` stack, and a step's
collectives do not grow in number with the replicas a rank holds.  The
caches keep the reference's layout: the replicas' rows, whole along
``model``.

The rank's ``(n / data, B, V)`` logits are all-gathered over ``data``
in replica order.  Where the output table splits on the vocabulary they
leave the forward as the rank's vocabulary columns, which is
``sharding.logits_pspec``'s split of the stack: without a logits attack
the rank aggregates that slice as it is, with no gather over ``model``;
a logits attack sees the whole stack, gathered over ``model`` first (a
random attack draws every replica's whole noise and the rank keeps its
slice, as one device draws).  The aggregation then splits the
vocabulary over ``model``: each rank aggregates its slice through
``distributed_aggregate(mesh=, specs=)`` (K1 per slice with the ``(n,
n)`` partials all-reduced; ``fused`` becomes ``pallas`` there, as in the
reference) and the aggregate is gathered back to the ``(B, V)`` logits
every rank samples from.  A vocabulary that ``model`` does not divide
leaves the logits whole and the stack whole on every rank.  With
``model = 1`` ``fused`` stays fused: K5 on the gathered stack on every
rank.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.agg.specs import AggSpec
from repro_torch.agg.state import AggState, init_state
from repro_torch.core.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.device import host_index, resolve_device
from repro_torch.dist.mesh import mesh_axis_sizes
from repro_torch.dist.robust import (distributed_aggregate, inject_byzantine,
                                     resolve_distance_backend)
from repro_torch.dist.serve import serve_shard, serve_specs
from repro_torch.dist.sharding import (P, gather_replicas, gather_shard,
                                       local_ensemble, local_shape,
                                       local_shard, logits_pspec, model_dim)
from repro_torch.dist.train import _RANDOM_ATTACKS, _attack_generator
from repro_torch.models import prefill
from repro_torch.models.decode import decode_step_, logits_split, verify_step_
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import named_span

__all__ = ["aggregate_logits", "ensemble_share", "gathered_logits",
           "init_ensemble_state", "make_robust_prefill_step",
           "make_robust_serve_step", "make_robust_verify_step",
           "poison_replicas", "replicate_cache", "replicate_params",
           "reset_slot_state", "stack_replicas"]


# ---------------------------------------------------------------------------
# replica parameter stacks
# ---------------------------------------------------------------------------

def stack_replicas(replicas: Sequence[Any]) -> Any:
    """Stack per-replica parameter trees along a new leading axis.

    Args:
      replicas: structurally identical parameter trees, one per member.

    Returns:
      One tree whose every leaf is the ``(n_replicas, *dims)`` stack of
      the replicas' leaves.
    """
    if not replicas:
        raise ValueError("need at least one replica")
    return tree_map(lambda *leaves: torch.stack(leaves), *replicas)


def replicate_params(params: Any, n_replicas: int, *, jitter: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> Any:
    """Broadcast one parameter set into an ``n_replicas``-stacked
    ensemble.

    Args:
      params: one model's parameter tree.
      n_replicas: ensemble size (the leading axis of every output leaf).
      jitter: per-replica Gaussian perturbation, relative to each
        stacked leaf's RMS value (``0.0``: exact copies); it models
        independently fine-tuned replicas and gives distance-based rules
        an honest cluster.
      generator: the ``torch.Generator`` of the jitter, drawn on its own
        device and moved to the parameters' (``None``: a CPU generator
        seeded with 0, the reference's ``PRNGKey(0)``; its stream
        differs from ``jax.random``'s).  Ignored when ``jitter == 0``.

    Returns:
      A tree of ``(n_replicas, *dims)`` leaves in the input dtypes.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    lead = (n_replicas,)
    if jitter <= 0.0:
        return tree_map(lambda p: p[None].expand(lead + tuple(p.shape))
                        .clone(), params)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    out = []
    for leaf in tree_leaves(params):
        lf = leaf.to(torch.float32)
        # the stacked leaf's RMS: it holds n copies of this one
        rms = torch.sqrt(torch.mean(torch.square(lf)) + 1e-12)
        noise = torch.randn(lead + tuple(leaf.shape), generator=generator,
                            device=generator.device, dtype=torch.float32)
        out.append((lf[None] + jitter * rms * noise.to(leaf.device))
                   .to(leaf.dtype))
        del lf, noise
    return tree_unflatten(params, out)


def replicate_cache(cache: Any, n_replicas: int) -> Any:
    """Give a decode cache a leading replica axis (every replica starts
    from the same empty cache, so a broadcast is exact).

    Args:
      cache: a cache tree from ``repro_torch.models.init_cache``.
      n_replicas: ensemble size.

    Returns:
      The tree with every leaf copied to ``(n_replicas, *leaf.shape)``.
    """
    return tree_map(lambda x: x[None].expand(
        (n_replicas,) + tuple(x.shape)).clone(), cache)


def poison_replicas(stacked_params: Any, f: int, attack: str = "signflip",
                    generator: Optional[torch.Generator] = None,
                    **attack_kwargs) -> Any:
    """Rewrite the last ``f`` replicas' parameters with a Byzantine
    attack: ``inject_byzantine`` on parameters instead of gradients
    (``"signflip"`` with a large scale makes a replica whose logits are
    confidently wrong).

    Args:
      stacked_params: ``(n_replicas, *dims)``-stacked parameter tree.
      f: replicas to poison, the trailing rows (``f <= 0``: a no-op).
      attack: any attack ``inject_byzantine`` accepts.
      generator: the ``torch.Generator`` of a random attack.
      **attack_kwargs: per-attack parameters (``scale``, ``eps``, ...).

    Returns:
      The stacked tree with the last ``f`` replicas replaced; shapes and
      dtypes kept.
    """
    return inject_byzantine(stacked_params, f, attack, generator,
                            **attack_kwargs)


# ---------------------------------------------------------------------------
# logits aggregation (the one entry point every serving path shares)
# ---------------------------------------------------------------------------

def _mesh_of(mesh):
    """``mesh`` checked: ``None`` or a rank's ``Mesh`` (anything with
    the axis names, the device grid and the collectives)."""
    if mesh is not None and not all(hasattr(mesh, a) for a in (
            "axis_names", "devices", "index", "all_gather")):
        raise TypeError(f"mesh= takes a repro_torch.dist.mesh.Mesh (a "
                        f"rank's view of its mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def _split_model(mesh) -> bool:
    return mesh is not None and mesh_axis_sizes(mesh).get("model", 1) > 1


def aggregate_logits(logits: torch.Tensor, f: int, gar: str, *,
                     agg_dtype: str = "native",
                     distance_backend: str = "auto", mesh=None,
                     state: Optional[AggState] = None,
                     history_window: Optional[int] = None,
                     rep_lr: Optional[float] = None,
                     rep_decay: Optional[float] = None,
                     vocab_slice: bool = False):
    """Aggregate a replica-stacked logits tensor through the registry.

    The stack goes into ``distributed_aggregate`` as a one-leaf tree, so
    the result is the flat rule on ``logits.reshape(n, -1)``: no rule is
    forked for serving.  Under ``distance_backend="fused"`` the one leaf
    runs through K5.

    Args:
      logits: ``(n_replicas, batch, vocab)`` (or ``(n_replicas, vocab)``)
        logits of one decode position; under a mesh the whole stack, the
        same on every rank.
      f: Byzantine bound (quorum-checked).
      gar: any rule with a tree implementation.
      agg_dtype: accumulation dtype (see ``repro_torch.dist.robust``).
      distance_backend: ``"xla"`` | ``"pallas"`` | ``"fused"`` |
        ``"auto"``.
      mesh: a rank's ``Mesh``, or ``None``.  With a ``model`` axis
        larger than 1 the rank aggregates its vocabulary slice
        (``sharding.logits_pspec``; the whole stack when the vocabulary
        does not divide) through ``distributed_aggregate(mesh=, specs=)``
        and the aggregate is gathered over ``model``; ``"fused"``
        resolves to ``"pallas"`` there.  Without one, every rank
        aggregates the whole stack.
      state: carried ``AggState`` of a stateful rule (``None``: zeros);
        under a ``model`` axis its buffers hold the rank's slice
        (:func:`init_ensemble_state` with the mesh).
      history_window: ``buffered-*`` window (``None``: the default).
      rep_lr: ``reputation-*`` EMA rate (``None``: the default).
      rep_decay: ``reputation-*`` forgetting factor (``None``: the
        default).
      vocab_slice: under a ``model`` axis, ``logits`` is already this
        rank's slice of the stack, ``logits_pspec``'s split of its last
        dim (what the tensor-parallel forward gives), aggregated as it
        is.

    Returns:
      ``(aggregate, DistAggResult)``, plus the new state for a stateful
      rule; the aggregate drops the replica axis and keeps the dtype
      (under a mesh, whole and the same on every rank).
    """
    mesh = _mesh_of(mesh)
    kw = dict(agg_dtype=agg_dtype, distance_backend=distance_backend,
              state=state, history_window=history_window, rep_lr=rep_lr,
              rep_decay=rep_decay)
    if not _split_model(mesh):
        out = distributed_aggregate({"logits": logits}, f, gar, mesh=mesh,
                                    **kw)
        agg = out[0]["logits"]
    else:
        shape = tuple(logits.shape)
        if vocab_slice:
            shape = shape[:-1] + (shape[-1] * mesh.size("model"),)
        spec = logits_pspec(shape, mesh)
        if vocab_slice and model_dim(spec) != len(shape) - 1:
            raise ValueError(f"vocab_slice=True, but logits_pspec does not "
                             f"split the last dim of a {shape} stack")
        local = logits if vocab_slice else local_shard(logits, spec, mesh)
        out = distributed_aggregate({"logits": local}, f, gar, mesh=mesh,
                                    specs={"logits": spec}, **kw)
        agg = gather_shard(out[0]["logits"], P(*spec[1:]), mesh)
    if len(out) == 3:
        return agg, out[1], out[2]
    return agg, out[1]


def init_ensemble_state(spec: AggSpec, n_replicas: int, batch: int,
                        vocab: int, device="cuda",
                        mesh=None) -> Optional[AggState]:
    """Zeroed ``AggState`` of a stateful serving aggregator.

    The template is the ``(n_replicas, batch, vocab)`` logits stack of a
    decode step, so window buffers are ``(W, n_replicas, batch, vocab)``;
    ``reputation-*`` rules get one trust column per slot, ``(n_replicas,
    batch)``, which :func:`reset_slot_state` can reset alone.

    Args:
      spec: the serving ``AggSpec``.
      n_replicas: ensemble size.
      batch: decode batch (the engine's slots).
      vocab: vocabulary size.
      device: where the buffers live (``"cuda"`` raises without a card).
      mesh: a rank's ``Mesh``, or ``None``: under a ``model`` axis the
        template is the rank's slice of the stack
        (``sharding.logits_pspec``), so window buffers are ``(W,
        n_replicas, batch, vocab / model)``; reputation stays ``(n,
        batch)``, the same on every rank.

    Returns:
      The state, or ``None`` for a stateless rule.
    """
    rule = spec.rule()
    if not rule.stateful:
        return None
    shape = (n_replicas, batch, vocab)
    mesh = _mesh_of(mesh)
    if _split_model(mesh):
        shape = local_shape(shape, logits_pspec(shape, mesh), mesh)
    template = {"logits": torch.empty(shape, dtype=torch.float32,
                                      device="meta")}
    return init_state(rule, template, flat=False, rep_dims=(batch,),
                      device=resolve_device(device))


def reset_slot_state(state: Optional[AggState],
                     slot: int) -> Optional[AggState]:
    """Clear one batch slot's column of a serving ``AggState``.

    A request admitted into a reused slot must not inherit the previous
    occupant's window / momentum history or replica trust; the engine
    calls this at admission.  Other slots and the global ``step`` are
    untouched.

    Args:
      state: the engine's carried state (``None`` for stateless rules).
      slot: the batch slot being (re)admitted.

    Returns:
      A new state with ``history[:, :, slot]`` and ``center[slot]``
      zeroed and ``reputation[:, slot]`` back to ones, or ``None``.
    """
    if state is None:
        return None

    def cleared(t: torch.Tensor, index, value: float) -> torch.Tensor:
        t = t.clone()
        t[index] = value
        return t

    history = tuple(cleared(h, (slice(None), slice(None), slot), 0.0)
                    for h in state.history) if state.history != () else ()
    center = tuple(cleared(c, slot, 0.0)
                   for c in state.center) if state.center != () else ()
    reputation = state.reputation
    if isinstance(reputation, torch.Tensor) and reputation.ndim == 2:
        reputation = cleared(reputation, (slice(None), slot), 1.0)
    return state._replace(history=history, center=center,
                          reputation=reputation)


# ---------------------------------------------------------------------------
# the ensemble steps
# ---------------------------------------------------------------------------

def _maybe_attack_logits(stack: torch.Tensor, spec: AggSpec,
                         pos) -> torch.Tensor:
    """The decode-time omniscient adversary on the stacked logits.  A
    random attack draws from a generator seeded from ``(spec.seed,
    sum(pos))``: any active slot advancing gives fresh noise."""
    if spec.attack == "none" or spec.f <= 0:
        return stack
    akw = dict(spec.attack_kwargs)
    akw.setdefault("gar_name", spec.gar)
    gen = None
    if spec.attack in _RANDOM_ATTACKS:
        pos_sum = host_index(torch.as_tensor(pos, dtype=torch.int64).sum())
        gen = _attack_generator(spec.seed, pos_sum, stack.device)
    return inject_byzantine({"logits": stack}, spec.f, spec.attack, gen,
                            **akw)["logits"]


def _aggregate(spec: AggSpec, stack: torch.Tensor, state, stateful: bool,
               mesh=None, vocab_slice: bool = False):
    """One ``aggregate_logits`` under ``spec``: ``(agg, diag, state)``
    (the state passes through for a stateless rule)."""
    out = aggregate_logits(
        stack, spec.f_declared, spec.effective_gar,
        agg_dtype=spec.agg_dtype, distance_backend=spec.distance_backend,
        mesh=mesh, state=state if stateful else None,
        history_window=spec.history_window, rep_lr=spec.rep_lr,
        rep_decay=spec.rep_decay, vocab_slice=vocab_slice)
    return out[0], out[1], (out[2] if stateful else state)


def _ensemble_size(mesh, n_replicas: Optional[int]) -> Optional[int]:
    """The step builders' ``mesh`` / ``n_replicas`` pair, checked: a mesh
    whose ``data`` axis may split the ensemble needs its size."""
    mesh = _mesh_of(mesh)
    if (mesh is not None and n_replicas is None
            and mesh_axis_sizes(mesh).get("data", 1) > 1):
        raise ValueError(
            "mesh= with a data axis needs n_replicas=: the ensemble's "
            "size, which says whether data splits the replicas")
    return n_replicas


def _whole_stack(local: torch.Tensor, n_replicas, mesh) -> torch.Tensor:
    """Every replica's logits from this rank's (gathered over ``data``
    when it splits the ensemble)."""
    if mesh is None or n_replicas is None:
        return local
    return gather_replicas(local, n_replicas, mesh)


def ensemble_share(stacked_params: Any, cfg: ModelConfig, mesh,
                   n_replicas: Optional[int] = None) -> Any:
    """This rank's share of a whole replica-stacked ensemble, as the
    ``mesh=`` steps take it (views; see the module docstring).

    Args:
      stacked_params: the whole ``(n, ...)``-stacked parameter tree.
      cfg: the replicas' model configuration.
      mesh: this rank's mesh.
      n_replicas: the ensemble's size (``None``: the leaves' leading
        axis).

    Returns:
      The rank's replicas, each cut to its ``model`` slices in the
      serving layout (``dist.serve.serve_specs``).
    """
    n = n_replicas or tree_leaves(stacked_params)[0].shape[0]
    return local_ensemble(stacked_params, mesh, serve_specs(cfg, mesh, n))


def gathered_logits(local: torch.Tensor, n_replicas: Optional[int], mesh,
                    split: bool) -> torch.Tensor:
    """Every replica's whole logits from this rank's: gathered over
    ``data`` when it splits the ensemble, and over ``model`` when
    ``split`` (the rank's logits are its vocabulary columns,
    ``models.decode.logits_split``).

    Args:
      local: ``(n_local, ..., V_local)`` logits of the rank's replicas.
      n_replicas: the ensemble's size.
      mesh: this rank's mesh, or ``None``.
      split: whether the last dim is the rank's vocabulary columns.

    Returns:
      ``(n, ..., V)``, the same on every rank.
    """
    stack = _whole_stack(local, n_replicas, mesh)
    return mesh.all_gather(stack, "model", stack.dim() - 1) if split else (
        stack)


class _Replicas:
    """What a robust step does with the rank's replicas: the forward under
    ``vmap`` (on the split forward under a ``model`` axis larger than 1),
    and the logits stack each aggregation takes."""

    def __init__(self, cfg: ModelConfig, spec: AggSpec, mesh, n_replicas):
        self.mesh = _mesh_of(mesh)
        self.n = _ensemble_size(mesh, n_replicas)
        self.shard = serve_shard(cfg, mesh, n_replicas or 1)
        self.split = logits_split(cfg, self.shard)
        self.attacked = spec.attack != "none" and spec.f > 0

    def forward(self, fn: Callable, *trees):
        """``fn(*replica's trees, shard)`` over the replica axis."""
        shard = self.shard
        return torch.func.vmap(lambda *a: fn(*a, shard))(*trees)

    def stack(self, local: torch.Tensor, attack: bool = False):
        """``(stack, vocab_slice)``: every replica's logits from the
        rank's (``(n_local, B, [k,] V_local)``); the rank's vocabulary
        slice where the forward gave one, ``logits_pspec`` splits the
        same dim and no attack needs the whole stack, else whole."""
        stack = _whole_stack(local, self.n, self.mesh)
        if not self.split:
            return stack, False
        whole = (stack.shape[0], stack.shape[1],
                 stack.shape[-1] * self.mesh.size("model"))
        if (attack and self.attacked) or model_dim(
                logits_pspec(whole, self.mesh)) != 2:
            return self.mesh.all_gather(stack, "model", stack.dim() - 1), (
                False)
        return stack, True


def make_robust_prefill_step(cfg: ModelConfig, spec: AggSpec,
                             cache_len: int = 0, impl: str = "auto",
                             mesh=None,
                             n_replicas: Optional[int] = None) -> Callable:
    """Build the ensemble prefill: every replica's forward, then a
    robust first token.

    Args:
      cfg: every replica's model configuration.
      spec: the serving ``AggSpec``.
      cache_len: decode-cache positions (``0``: the prompt's length).
      impl: attention path of the prefill.
      mesh: a rank's ``Mesh``, or ``None`` (see the module docstring):
        the step then takes this rank's share (:func:`ensemble_share`),
        gathers the replicas' logits over ``data`` and aggregates over
        the mesh.
      n_replicas: the ensemble's size; needed under a mesh with a
        ``data`` axis larger than 1.

    Returns:
      ``prefill_step(stacked_params, tokens[, extra]) -> (agg_logits,
      stacked_cache, diag)``: the prefill under ``vmap`` over the
      replica axis (every replica sees the same prompt), the
      last-position ``(n, B, V)`` logits aggregated through
      ``spec.gar`` (stateful rules from a zero state: the carried state
      starts on the decode stream), the caches replica-stacked (under a
      mesh, this rank's replicas', whole along ``model``).
    """
    reps = _Replicas(cfg, spec, mesh, n_replicas)
    resolve_distance_backend(spec.distance_backend)

    def prefill_step(stacked_params, tokens: torch.Tensor,
                     extra: Optional[torch.Tensor] = None):
        logits, caches = reps.forward(
            lambda p, s: prefill(p, cfg, tokens, extra, cache_len=cache_len,
                                 impl=impl, shard=s), stacked_params)
        with named_span("serve/aggregate"):
            stack, sliced = reps.stack(
                logits[:, :, -1, :].to(torch.float32))
            out = aggregate_logits(
                stack, spec.f_declared, spec.effective_gar,
                agg_dtype=spec.agg_dtype,
                distance_backend=spec.distance_backend, mesh=mesh,
                history_window=spec.history_window,
                rep_lr=spec.rep_lr, rep_decay=spec.rep_decay,
                vocab_slice=sliced)
        return out[0], caches, out[1]

    return prefill_step


def make_robust_serve_step(cfg: ModelConfig, spec: AggSpec, mesh=None,
                           n_replicas: Optional[int] = None) -> Callable:
    """Build the robust ensemble decode step.

    Args:
      cfg: every replica's model configuration.
      spec: the serving ``AggSpec``; ``spec.attack`` (``"none"`` to
        disable) poisons the last ``spec.f`` replicas' logits.
      mesh: a rank's ``Mesh``, or ``None``: the step then takes this
        rank's share (:func:`ensemble_share`) and its replicas' caches,
        gathers the logits over ``data``, attacks the whole stack (every
        rank draws the same noise) and aggregates over the mesh (see the
        module docstring).
      n_replicas: the ensemble's size; needed under a mesh with a
        ``data`` axis larger than 1.

    Returns:
      ``serve_step(stacked_params, stacked_cache, token, pos,
      agg_state=None) -> (agg_logits (B, V), stacked_cache, diag,
      new_agg_state)``: one token on every replica
      (``models.decode.decode_step_`` under ``vmap`` over the replica
      axis of parameters and caches; the same ``token`` and ``pos`` feed
      every replica), the attack, then the ``(n, B, V)`` stack through
      ``spec.gar``.  The step writes
      each replica's new keys and values into ``stacked_cache`` in place
      (the caller owns it: the engine's one persistent buffer) and
      returns that same tree.  ``pos`` is a scalar or ``(B,)`` int32;
      thread the returned state into the next call (``None`` for a
      stateless rule).
    """
    reps = _Replicas(cfg, spec, mesh, n_replicas)
    resolve_distance_backend(spec.distance_backend)
    stateful = spec.rule().stateful

    def serve_step(stacked_params, stacked_cache, token: torch.Tensor, pos,
                   agg_state: Optional[AggState] = None):
        logits = reps.forward(
            lambda p, c, s: decode_step_(p, cfg, c, token, pos, shard=s),
            stacked_params, stacked_cache)
        with named_span("serve/aggregate"):
            stack, sliced = reps.stack(
                logits[:, :, 0, :].to(torch.float32), attack=True)
            stack = _maybe_attack_logits(stack, spec, pos)
            agg, diag, new_state = _aggregate(spec, stack, agg_state,
                                              stateful, mesh, sliced)
        return agg, stacked_cache, diag, (new_state if stateful else None)

    return serve_step


def make_robust_verify_step(cfg: ModelConfig, spec: AggSpec, mesh=None,
                            n_replicas: Optional[int] = None) -> Callable:
    """Build the batched speculative-verify step.

    Aggregation runs per position in stream order: a loop over the
    block's ``k`` positions applies :func:`aggregate_logits` to each
    ``(n, B, V)`` slice and threads the carried ``AggState`` from
    position to position, so every rule keeps the per-token path's
    semantics and state evolution, and a ``k = 1`` block is that path.

    Args:
      cfg: every replica's model configuration (``verify_supported``
        must hold).
      spec: the serving ``AggSpec`` (``spec.attack`` poisons every block
        position).
      mesh: a rank's ``Mesh``, or ``None``: as
        :func:`make_robust_serve_step`'s, each of the ``k`` aggregations
        over the mesh.
      n_replicas: the ensemble's size; needed under a mesh with a
        ``data`` axis larger than 1.

    Returns:
      ``verify(stacked_params, stacked_cache, tokens, pos,
      agg_state=None) -> (agg_logits (B, k, V), stacked_cache, diag,
      new_agg_state)``: one ``models.decode.verify_step_`` pass per replica
      over the ``(B, k)`` block, which writes the block's keys and
      values into ``stacked_cache`` in place (the caller owns it) and
      returns that same tree; ``diag`` is a ``DistAggResult`` whose
      fields lead with a ``(k,)`` axis.
    """
    from repro_torch.dist.robust import DistAggResult
    from repro_torch.models import verify_supported
    reps = _Replicas(cfg, spec, mesh, n_replicas)
    resolve_distance_backend(spec.distance_backend)
    ok, reason = verify_supported(cfg)
    if not ok:
        raise ValueError(
            f"speculative verify unsupported for {cfg.name!r} — {reason}")
    stateful = spec.rule().stateful

    def verify(stacked_params, stacked_cache, tokens: torch.Tensor, pos,
               agg_state: Optional[AggState] = None):
        logits = reps.forward(
            lambda p, c, s: verify_step_(p, cfg, c, tokens, pos, shard=s),
            stacked_params, stacked_cache)
        with named_span("serve/aggregate"):
            stack, sliced = reps.stack(logits.to(torch.float32),
                                       attack=True)     # (n, B, k, V)
            stack = _maybe_attack_logits(stack, spec, pos)
            aggs, diags = [], []
            for j in range(stack.shape[2]):             # stream order
                agg, diag, agg_state = _aggregate(spec, stack[:, :, j],
                                                  agg_state, stateful, mesh,
                                                  sliced)
                aggs.append(agg)
                diags.append(diag)
        diag = DistAggResult(*(torch.stack(fs) for fs in zip(*diags)))
        return (torch.stack(aggs, dim=1), stacked_cache, diag,
                agg_state if stateful else None)

    return verify
