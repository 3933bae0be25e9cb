"""Batched serving engine: fixed-slot continuous batching over the
decode path, with an optional Byzantine-resilient ensemble mode
(counterpart of ``repro/serving/engine.py``).

Slots hold independent sequences; each :meth:`ServingEngine.step`
decodes one token for every active slot.  Requests queue through
:meth:`ServingEngine.submit` and each step first admits queued requests
into free slots (prefill of the prompt, spliced into the batched
cache), so a slot freed by a finished request is refilled mid-stream.
Each slot carries its own position.  Greedy sampling; no paged KV.
The engine owns its batched cache (and the draft's) as one persistent
buffer: every decode step, verify block and admission writes it in
place (``models.decode.decode_step_`` / ``verify_step_``,
:meth:`_splice`).

**Ensemble mode** (``ensemble=AggSpec(...)``): ``params`` is a
replica-stacked tree (``repro_torch.dist.serve_robust``), caches are
kept per replica, and every step aggregates the ``(n_replicas,
n_slots, vocab)`` logits stack through the registry before sampling
(under ``distance_backend="fused"``: one K5 per step, one per
admission); stateful rules carry ``self.agg_state`` across tokens.

**Speculative mode** (``ensemble.speculative_k >= 1``): each step
drafts a ``k``-token block on replica ``ensemble.draft_replica``,
verifies all ``k`` positions in one robust step and emits the longest
draft prefix that survives the aggregate plus one corrected token
(``repro_torch.serving.speculative.accept_block``).  ``speculative_k =
1`` runs no draft and gives the per-token stream bit for bit.

The engine runs where its parameters live; host counters
(``positions``, ``last_token``) are int32 numpy, as in the reference.

**Sharded mode** (``mesh=`` a rank's ``repro_torch.dist.mesh.Mesh``,
ensemble mode only): every rank of the mesh runs the same engine on the
same requests, so slots, positions, admissions and sampling are
replicated host state.  A rank keeps its share of the ensemble as
``ensemble_param_shardings`` lays it out (``serve_robust.ensemble_share``):
its replicas (``data`` splits the ensemble where it divides,
``sharding.replica_rows``), each cut to its ``model`` slices, with the
few leaves a layer reads whole kept whole; their caches (whole along
``model``, as the reference's ``cache_shardings``); the ``AggState`` of
its vocabulary slice; and in speculative mode the draft replica's
``model`` slices.  The steps run the tensor-parallel forward and gather
and aggregate over the mesh (``repro_torch.dist.serve_robust``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.models import init_cache, prefill
from repro_torch.models.decode import decode_step_
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import named_span

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus generation bookkeeping.

    ``generated`` collects the sampled token ids (filled by the engine);
    ``done`` flips when ``max_new_tokens`` have been produced.
    """

    rid: int
    prompt: np.ndarray           # (S0,) int32
    max_new_tokens: int
    generated: Optional[List[int]] = None
    done: bool = False


class ServingEngine:
    """Fixed-slot continuous-batching engine (optionally ensemble-robust).

    Plain mode: ``params`` is one parameter tree and each step is one
    ``decode_step_`` over all slots.  Ensemble mode (``ensemble=`` a
    ``repro_torch.agg.AggSpec``): ``params`` is a replica-stacked tree
    (or a list of per-replica trees, stacked on entry), each step
    decodes every replica and aggregates the logits stack before greedy
    sampling.

    Args:
      params: the parameters, on the device the engine runs on.
      cfg: the model configuration.
      n_slots: concurrent sequences.
      cache_len: positions of a full attention cache.
      sampler: ``"greedy"`` (the only sampler, as in the reference).
      ensemble: the serving ``AggSpec`` (``None``: plain mode).
      mesh: the ensemble's mesh (a rank's ``Mesh``; see the module
        docstring), or ``None``; unused in plain mode, as in the
        reference.  Under a mesh ``params`` is the whole ensemble (a
        stacked tree or a list, on any device) and the engine keeps
        copies of this rank's share and of the draft's slices on the
        mesh's device, so the caller may free the whole ensemble: a rank
        then holds ``n / data`` replicas' ``model`` slices.  The whole
        ensemble exists wherever the caller built it until then (a
        rank that builds it on its card holds the whole and its share
        at once while the engine copies).
    """

    def __init__(self, params, cfg: ModelConfig, n_slots: int = 4,
                 cache_len: int = 512, sampler: str = "greedy",
                 ensemble=None, mesh=None):
        why = cfg.unsupported("serving")
        if why:
            raise NotImplementedError(why)
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.ensemble = ensemble
        self.positions = np.zeros((n_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * n_slots
        self.pending: List[Request] = []
        self.last_token = np.zeros((n_slots,), np.int32)
        self.sampler = sampler
        self.agg_state = None
        self.spec_k = 0
        self.accept_counts: List[np.ndarray] = []
        self.mesh = None
        self.shard = None
        if ensemble is None:
            self.params = params
            self.device = tree_leaves(params)[0].device
            self.cache = init_cache(cfg, n_slots, cache_len,
                                    device=self.device)
            self._decode = lambda p, c, t, pos: (
                decode_step_(p, cfg, c, t, pos), c)
            return
        # -- ensemble mode ----------------------------------------------------
        from repro_torch.dist.serve_robust import (_mesh_of,
                                                   init_ensemble_state,
                                                   make_robust_prefill_step,
                                                   make_robust_serve_step,
                                                   replicate_cache,
                                                   stack_replicas)
        if isinstance(params, (list, tuple)):
            params = stack_replicas(params)
        self.mesh = _mesh_of(mesh)
        self.n_replicas = tree_leaves(params)[0].shape[0]
        whole = params
        if mesh is None:
            self.params = params
            self.device = tree_leaves(params)[0].device
        else:
            from repro_torch.dist.mesh import mesh_axis_sizes
            from repro_torch.dist.serve import serve_shard
            from repro_torch.dist.serve_robust import ensemble_share
            from repro_torch.dist.sharding import replica_rows
            sliced = (replica_rows(self.n_replicas, mesh)[1]
                      or mesh_axis_sizes(mesh).get("model", 1) > 1)
            self.device = mesh.device
            # copies when sliced, so the caller's whole ensemble can go
            self.params = tree_map(
                lambda x: x.to(self.device, copy=sliced).contiguous(),
                ensemble_share(params, cfg, mesh, self.n_replicas))
            # the draft's shard: the replicas' inner layout, unstacked
            self.shard = serve_shard(cfg, mesh)
        n_local = tree_leaves(self.params)[0].shape[0]
        kw = dict(mesh=mesh, n_replicas=self.n_replicas)
        self._decode = make_robust_serve_step(cfg, ensemble, **kw)
        self._ens_prefill = make_robust_prefill_step(
            cfg, ensemble, cache_len=cache_len, **kw)
        self.cache = replicate_cache(
            init_cache(cfg, n_slots, cache_len, device=self.device),
            n_local)
        self.agg_state = init_ensemble_state(
            ensemble, self.n_replicas, n_slots, cfg.vocab_size,
            device=self.device, mesh=mesh)
        # -- speculative mode -------------------------------------------------
        k = int(getattr(ensemble, "speculative_k", 0) or 0)
        if k < 1:
            return
        from repro_torch.dist.serve_robust import make_robust_verify_step
        from repro_torch.serving.speculative import (accept_block,
                                                     make_draft_propose)
        self.spec_k = k
        self.draft_replica = int(ensemble.draft_replica)
        if not 0 <= self.draft_replica < self.n_replicas:
            raise ValueError(
                f"draft_replica {self.draft_replica} out of range for "
                f"{self.n_replicas} replicas")
        draft = tree_map(lambda x: x[self.draft_replica], whole)
        if mesh is not None:
            from repro_torch.dist.serve import serve_specs
            from repro_torch.dist.sharding import shard_tree
            draft = shard_tree(draft, serve_specs(cfg, mesh), mesh)
        self.draft_params = tree_map(
            lambda x: x.to(self.device, copy=mesh is not None).contiguous(),
            draft)
        self.draft_cache = init_cache(cfg, n_slots, cache_len,
                                      device=self.device)
        self._propose = make_draft_propose(cfg, k, shard=self.shard)
        self._verify = make_robust_verify_step(cfg, ensemble, **kw)
        self._accept = accept_block

    # -- admission -----------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    @staticmethod
    def _splice(cache, slot: int, slot_cache, replicated: bool) -> None:
        """Write one slot's freshly prefilled cache into row ``slot`` of
        a batched cache, in place (``copy_``): the batched cache is the
        engine's own persistent buffer, and no leaf of it is copied
        whole.

        Period caches are ``(n_periods, B, ...)``, tail caches ``(B,
        ...)``; with ``replicated`` both carry a leading replica axis.
        """
        def write(axis: int):
            def fn(full, one):
                lead = (slice(None),) * axis
                full[lead + (slot,)].copy_(one[lead + (0,)])
            return fn

        lead = 1 if replicated else 0
        tree_map(write(lead + 1), cache["periods"], slot_cache["periods"])
        tree_map(write(lead), cache["tail"], slot_cache["tail"])

    def _splice_cache(self, slot: int, slot_cache) -> None:
        self._splice(self.cache, slot, slot_cache,
                     self.ensemble is not None)

    def admit(self, req: Request) -> bool:
        """Admit one request into a free slot (False when full).

        Runs the prompt through prefill and splices the slot's cache into
        the batched cache.  In ensemble mode the first token is already
        robust: the replicas' last-position logits are aggregated through
        the configured rule (statelessly: the carried state starts on the
        decode stream), and the slot's columns of a carried state are
        reset.
        """
        slot = self._free_slot()
        if slot is None:
            return False
        with named_span("serve/admit", rid=req.rid,
                        prompt_len=len(req.prompt), slot=slot):
            self._admit(req, slot)
        return True

    def _admit(self, req: Request, slot: int) -> None:
        req.generated = []
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None, :]
        with named_span("serve/prefill", rid=req.rid):
            if self.ensemble is None:
                logits, slot_cache = prefill(self.params, self.cfg, tokens,
                                             cache_len=self.cache_len)
                last = logits[0, -1]
            else:
                agg_logits, slot_cache, _ = self._ens_prefill(self.params,
                                                              tokens)
                last = agg_logits[0]
        first = int(torch.argmax(last))
        with named_span("serve/splice", rid=req.rid):
            self._splice_cache(slot, slot_cache)
            if self.ensemble is not None:
                # a reused slot must not inherit the previous occupant's
                # window / momentum history or replica trust
                from repro_torch.dist.serve_robust import reset_slot_state
                self.agg_state = reset_slot_state(self.agg_state, slot)
            if self.spec_k:
                from repro_torch.serving.speculative import draft_cache_view
                self._splice(self.draft_cache, slot,
                             draft_cache_view(slot_cache, self.draft_replica,
                                              self.mesh, self.n_replicas),
                             replicated=False)
        self.active[slot] = req
        self.positions[slot] = len(req.prompt)
        self.last_token[slot] = first
        req.generated.append(first)

    def submit(self, req: Request) -> None:
        """Queue a request for admission at the next :meth:`step`."""
        self.pending.append(req)

    def _admit_pending(self) -> int:
        admitted = 0
        while self.pending and self._free_slot() is not None:
            admitted += bool(self.admit(self.pending.pop(0)))
        return admitted

    # -- one decode step across all slots -------------------------------------

    def step(self) -> None:
        """Admit queued requests into free slots, then decode the batch
        (one token per active slot; 1 to k in speculative mode).  A
        no-op when nothing is active or queued."""
        with named_span("serve/step") as span:
            admitted = self._admit_pending()
            active = sum(r is not None for r in self.active)
            span.note(active=active, admitted=admitted)
            if not active:
                return
            if self.spec_k:
                self._step_speculative()
            else:
                self._step_tokens()

    def _step_tokens(self) -> None:
        tokens = torch.as_tensor(self.last_token,
                                 device=self.device)[:, None]
        # per-slot positions: each sequence ropes and writes at its own
        # index; the host copy also seeds a random logits attack
        pos = self.positions.copy()
        with named_span("serve/decode"):
            if self.ensemble is None:
                logits, self.cache = self._decode(self.params, self.cache,
                                                  tokens, pos)
                step_logits = logits[:, 0]
            else:
                step_logits, self.cache, _res, self.agg_state = \
                    self._decode(self.params, self.cache, tokens, pos,
                                 self.agg_state)
        with named_span("serve/sample"):
            nxt = torch.argmax(step_logits, dim=-1).to(torch.int32).cpu() \
                .numpy()
            for i, req in enumerate(self.active):
                if req is None:
                    continue
                self.last_token[i] = nxt[i]
                req.generated.append(int(nxt[i]))
                self.positions[i] += 1
                if len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    self.active[i] = None

    def _step_speculative(self) -> None:
        """Draft ``k - 1``, verify ``k``, emit 1 to ``k`` per slot; the
        slots accept different prefix lengths, so their positions part."""
        tokens = torch.as_tensor(self.last_token, device=self.device)
        pos = self.positions.copy()
        block, self.draft_cache = self._propose(
            self.draft_params, self.draft_cache, tokens, pos)
        with named_span("serve/decode"):
            agg_logits, self.cache, _diag, self.agg_state = self._verify(
                self.params, self.cache, block, pos, self.agg_state)
        with named_span("serve/sample"):
            emitted, count, _v = self._accept(block, agg_logits)
            emitted = emitted.to(torch.int32).cpu().numpy()
            count = count.to(torch.int32).cpu().numpy()
            self.accept_counts.append(count.copy())
            for i, req in enumerate(self.active):
                if req is None:
                    continue
                c = min(int(count[i]),
                        req.max_new_tokens - len(req.generated))
                req.generated.extend(int(t) for t in emitted[i, :c])
                self.positions[i] += c
                self.last_token[i] = int(emitted[i, c - 1])
                if len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    self.active[i] = None

    def telemetry(self) -> Dict:
        """The aggregation forensics, drained to host numpy.

        Returns:
          ``repro_torch.obs.buffer.drain`` of the carried state's ring
          (empty unless the spec sets ``telemetry=True``), plus
          ``accept_counts``, the ``(steps, n_slots)`` accepted-prefix
          lengths of the speculative steps, and ``accept_mean``, their
          mean (0.0 before any speculative step).
        """
        from repro_torch.obs.buffer import drain
        obs = self.agg_state.obs if self.agg_state is not None else ()
        report = drain(obs)
        counts = (np.stack(self.accept_counts)
                  if self.accept_counts else np.zeros((0, self.n_slots),
                                                      np.int32))
        report["accept_counts"] = counts
        report["accept_mean"] = float(counts.mean()) if counts.size else 0.0
        return report

    def run(self, requests: List[Request], max_steps: int = 1000
            ) -> Dict[int, List[int]]:
        """Serve requests to completion (continuous batching).

        Queues everything through :meth:`submit`, steps until all are
        done or ``max_steps`` is reached, and returns ``{rid: generated
        tokens}``.
        """
        for req in requests:
            self.submit(req)
        results: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if not self.pending and not any(self.active):
                break
            self.step()
            for req in requests:
                if req.done and req.rid not in results:
                    results[req.rid] = req.generated
        for req in requests:
            results.setdefault(req.rid, req.generated or [])
        return results
