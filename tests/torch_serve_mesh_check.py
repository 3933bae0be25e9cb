"""Rank functions that drive the sharded serving engine on a mesh and
report what the run measured, for ``chip_smoke.py``'s phases 9d and 9e
and the card tests (``tests/test_torch_cuda.py``).

``run_on_mesh`` spawns its ranks, and a spawned rank imports the
function it runs: the caller puts this directory on ``sys.path``, which
the ranks inherit.  Each rank builds the poisoned ensemble from a seed
(one rank at a time, so the card holds one whole ensemble at most while
they build), hands it to ``ServingEngine(mesh=)``, which keeps the
rank's share (its replicas' ``model`` slices), frees the whole, and
serves the requests.  Around every robust step the
rank reads the kernels' launch counters (per process), the host clock,
its collectives (``Mesh.comm``) and the poisoned replica's selection
weight; it records the top-2 gap of every emitted token's aggregated
logits, so a caller can tell a near-tie from a fault where two runs'
streams part.  A run's launch totals are the engine's alone: the
probe counts the launches of its own decode steps (the captured stack,
the float64 witnesses) apart, and the run's totals leave them out.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.agg.specs import AggSpec
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.dist import serve_robust as sr
from repro_torch.dist.mesh import comm_since, comm_snapshot, make_host_mesh
from repro_torch.dist.robust import resolve_distance_backend
from repro_torch.dist.mesh import mesh_axis_sizes
from repro_torch.dist.sharding import replica_rows
from repro_torch.kernels import _build
from repro_torch.kernels.fused_agg import (fused_aggregate,
                                           fused_aggregate_plain)
from repro_torch.kernels.pairwise_gram import (pairwise_gram_partial,
                                               pairwise_gram_partial_plain)
from repro_torch.models import decode_step, init_model
from repro_torch.models.decode import logits_split
from repro_torch.obs.buffer import AggDiagnostics
from repro_torch.obs.forensics import sketch_spans, tree_diagnostics
from repro_torch.serving import Request, ServingEngine
from torch_mesh_check import _event_ms, _setup, _sync
from torch_serving_compare import top2_gap

__all__ = ["RUNS", "serve_rank", "serve_settings"]

#: the engine runs a rank can make: name -> the spec's extra fields
RUNS = {"token": {}, "spec": {"speculative_k": 4, "draft_replica": 0},
        "telemetry": {"telemetry": True}}


def _config(arch: str, layers: Optional[int]):
    return (get_reduced(arch) if layers is None
            else dataclasses.replace(get_config(arch), n_layers=layers))


def _world_in_turn(fn):
    """``fn()`` on one rank of the world at a time (the others wait in a
    barrier): the card holds one rank's work at a time."""
    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            out = fn()
        dist.barrier()
    return out


def ensemble(cfg, n: int, f: int, seed: int, device) -> Any:
    """``n`` replicas of ``init_model(seed)`` jittered at 1e-3 (a
    generator on ``device`` seeded with ``seed``, so every process draws
    the same ensemble), the last ``f`` sign-flipped at scale 10."""
    params = init_model(seed, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    honest = sr.replicate_params(params, n, jitter=1e-3, generator=gen)
    del params
    stacked = sr.poison_replicas(honest, f, "signflip", scale=10.0)
    del honest
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return stacked


class _Probe:
    """Wraps an engine's robust steps: per call the launches (counter
    differences), host ms ending in a synchronize, the collectives' time
    and bytes and their calls and bytes per kind (``comm_kinds``: the
    call's own, taken between two snapshots of ``Mesh.comm`` around it,
    so the probe's own gather of the stack before the call is not in
    it), and the poisoned replicas' selection weight; per request
    the emitted tokens' top-2 gaps.  ``capture`` keeps the first decode
    step's gathered stack (computed before the call, from the same
    replicas, outside its window) and the aggregate, selection and
    scores the step returned, ``witness``, how far the poisoned
    replicas' rows of that stack lie from the same replica's step in
    float64 on the same cache (:meth:`_exact`), and on one device
    ``inputs``, the step's token, positions and the poisoned replicas'
    caches (on the CPU); given such ``shared`` inputs of another run,
    ``on_shared`` holds the poisoned replicas this rank holds on them
    (:meth:`_on_shared`).  ``record`` keeps every decode step's
    stack, aggregate and the telemetry row it pushed.  ``extra_s`` is
    the host time the probe spent outside the steps' windows, which a
    run's wall time leaves out, and ``own`` the kernel launches of the
    probe's own decode steps, which a run's launch totals leave out."""

    def __init__(self, eng, mesh, n: int, f: int, capture: bool,
                 record: bool = False, shared: Optional[dict] = None):
        self.eng, self.mesh, self.n, self.f = eng, mesh, n, f
        self.calls = {"admit": [], "decode": [], "verify": []}
        self.gaps: Dict[int, List] = {}
        self.capture, self.record, self.shared = capture, record, shared
        self.records: List = []
        self.stack = self.first = self.inputs = None
        self.witness, self.on_shared = [], []
        self.pending = None
        self.extra_s = 0.0
        self.own = {k: 0 for k in _build.LAUNCHES}
        for kind, attr in (("admit", "_ens_prefill"), ("decode", "_decode"),
                           ("verify", "_verify")):
            if hasattr(eng, attr):
                setattr(eng, attr, self._wrap(getattr(eng, attr), kind))
        admit = eng.admit

        def recorded_admit(req):
            ok = admit(req)
            if ok:
                self.gaps[req.rid] = [self.pending]
            return ok

        eng.admit = recorded_admit

    def _stack_of(self, args):
        """The decode step's gathered ``(n, B, V)`` logits (the rank's
        share through the split forward under a ``model`` axis, gathered
        over ``data`` and, where they are vocabulary columns, over
        ``model``)."""
        eng, cfg = self.eng, self.eng.cfg
        p, c, tok, pos = args[:4]
        logits = torch.func.vmap(lambda pp, cc: decode_step(
            pp, cfg, cc, tok, pos, shard=eng.shard)[0])(p, c)[:, :, 0].to(
                torch.float32)
        return (logits if eng.mesh is None
                else sr.gathered_logits(logits, self.n, eng.mesh,
                                        logits_split(cfg, eng.shard)))

    def _held(self, p) -> List[tuple]:
        """``[(row, local index)]`` of the poisoned replicas this rank
        holds."""
        eng = self.eng
        lo = 0 if eng.mesh is None else replica_rows(self.n, eng.mesh)[
            0].start
        held = tree_leaves(p)[0].shape[0]
        return [(i, i - lo) for i in range(self.n - self.f, self.n)
                if 0 <= i - lo < held]

    def _row(self, p, cache, tok, pos, dtype) -> torch.Tensor:
        """One replica's decode step in ``dtype`` on ``cache`` through
        this rank's path (the split forward under a ``model`` axis,
        whose ranks hold the same replicas), gathered: ``(B, V)`` on the
        CPU.  A float64 step runs on the CPU: the card's decode attention
        takes float32 and bfloat16."""
        eng = self.eng
        exact = dtype == torch.float64
        dev = torch.device("cpu") if exact else eng.device
        p, cache = (tree_map(lambda x: x.to(dev, dtype if exact else None),
                             t) for t in (p, cache))
        e = decode_step(p, eng.cfg, cache, tok.to(dev), pos,
                        shard=eng.shard)[0][:, 0]
        if eng.mesh is not None and logits_split(eng.cfg, eng.shard):
            e = eng.mesh.all_gather(e, "model", e.dim() - 1)
        return e.to(dtype).cpu()

    def _exact(self, args) -> Dict[int, torch.Tensor]:
        """The poisoned replicas this rank holds: each one's decode step
        in float64 on this run's own cache (:meth:`_row`)."""
        p, c, tok, pos = args[:4]
        return {i: self._row(tree_map(lambda x: x[j], p),
                             tree_map(lambda x: x[j], c), tok, pos,
                             torch.float64)
                for i, j in self._held(p)}

    def _on_shared(self, args, exact: Dict[int, torch.Tensor]):
        """``[(row, {...})]`` for the poisoned replicas this rank holds, on
        ``shared``'s inputs (another run's token, positions and that
        replica's cache) in place of this run's: ``"row"``, the step in
        float32 through this rank's path (``(B, V)`` on the CPU);
        ``"off64"``, its largest distance from the same step in float64
        on the same inputs; ``"caches64"``, how far that float64 step
        lies from ``exact``'s, the step on this run's own cache (how far
        the two runs' caches part, seen through the step)."""
        p = args[0]
        sh = self.shared
        out = []
        for i, j in self._held(p):
            pi = tree_map(lambda x: x[j], p)
            row, e = (self._row(pi, sh["rows"][i], sh["tok"], sh["pos"], dt)
                      for dt in (torch.float32, torch.float64))
            out.append((i, {"row": row, "off64": float(
                (row.double() - e).abs().max()), "caches64": float(
                    (exact[i] - e).abs().max())}))
        return out

    def _inputs(self, args):
        """The step's token and positions and the poisoned replicas'
        caches, on the CPU (what :meth:`_on_shared` of another run
        takes)."""
        p, c, tok, pos = args[:4]
        return {"tok": tok.to("cpu", copy=True), "pos": np.array(pos),
                "rows": {i: tree_map(lambda x: x[j].to("cpu", copy=True), c)
                         for i, j in self._held(p)}}

    def _wrap(self, fn, kind):
        dev = self.eng.device

        def call(*args):
            t_probe = time.perf_counter()
            stack = None
            if kind == "decode" and (self.record or (
                    self.capture and self.stack is None)):
                counts = dict(_build.LAUNCHES)
                stack = self._stack_of(args)
                if self.capture and self.stack is None:
                    self.stack = stack
                    exact = self._exact(args)
                    self.witness = [(i, float((stack[i].double().cpu()
                                               - e).abs().max()))
                                    for i, e in exact.items()]
                    if self.eng.mesh is None:
                        self.inputs = self._inputs(args)
                    if self.shared is not None:
                        self.on_shared = self._on_shared(args, exact)
                for k in self.own:
                    self.own[k] += _build.LAUNCHES[k] - counts[k]
            _sync(dev)
            self.extra_s += time.perf_counter() - t_probe
            before = dict(_build.LAUNCHES)
            comm = comm_snapshot(self.mesh.comm)
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(dev)
            t_probe = time.perf_counter()
            ms = (t_probe - t0) * 1e3
            sel = out[2].selected
            self.calls[kind].append({
                "launches": {k: _build.LAUNCHES[k] - before[k]
                             for k in before},
                "ms": ms,
                "comm_s": self.mesh.comm["seconds"] - comm["seconds"],
                "comm_bytes": self.mesh.comm["bytes"] - comm["bytes"],
                "comm_kinds": comm_since(comm, self.mesh.comm),
                "byz": float(sel[..., self.n - self.f:].abs().sum())})
            agg = out[0]
            if kind == "admit":
                self.pending = top2_gap(agg[0].cpu())
            elif kind == "decode":
                if self.capture and self.first is None:
                    self.first = (agg.detach().clone(), sel.clone(),
                                  out[2].scores.clone())
                if self.record:
                    ring = out[3].obs
                    at = (int(ring.cursor) - 1) % ring.capacity
                    self.records.append((stack, agg.detach().clone(),
                                         AggDiagnostics(*(
                                             x[at].clone() for x in
                                             ring.records))))
                for i, req in enumerate(self.eng.active):
                    if req is not None:
                        self.gaps.setdefault(req.rid, []).append(
                            top2_gap(agg[i].cpu()))
            self.extra_s += time.perf_counter() - t_probe
            return out

        return call


def reachable_selections(stack: torch.Tensor, f: int) -> List[tuple]:
    """Every replica set Bulyan(krum)'s phase 1 may pick on a stack in
    fp32: each round's scores in float64 on exact distances, and every
    candidate whose score lies within the two scores' rounding bound in
    fp32's Gram form (``8 eps (sq_i + sq_j)`` per distance, ``eps =
    2^-24``) of the best one's followed.  Exact ties (two workers each
    other's nearest when one neighbour counts) are followed too: the
    first index wins them in one run, rounding in another.

    Returns:
      The sorted index tuples of the reachable selections.
    """
    n = stack.shape[0]
    x = stack.reshape(n, -1).double()
    dist = ((x[:, None] - x[None]) ** 2).sum(-1).tolist()
    sq = (x * x).sum(1).tolist()
    err = [[8 * 2.0 ** -24 * (sq[i] + sq[j]) for j in range(n)]
           for i in range(n)]
    out = set()

    def walk(rem, picked):
        if len(picked) == n - 2 * f:
            out.add(tuple(sorted(picked)))
            return
        k = max(1, len(rem) - f - 2)
        scored = {}
        for i in rem:
            near = sorted((dist[i][j], err[i][j]) for j in rem if j != i)[:k]
            scored[i] = (sum(d for d, _ in near), sum(e for _, e in near))
        best = min(scored, key=lambda i: scored[i][0])
        s0, e0 = scored[best]
        for i, (s1, e1) in scored.items():
            if s1 - s0 <= e0 + e1:
                walk([j for j in rem if j != i], picked + [i])

    walk(list(range(n)), [])
    return sorted(out)


def sketch_window(stack: torch.Tensor) -> torch.Tensor:
    """The telemetry sketch's window of a whole ``(n, ...)`` stack
    (``tree_diagnostics`` on one leaf), ``(n, S)`` on the CPU."""
    x = stack.reshape(stack.shape[0], -1)
    start, size = sketch_spans([x.shape[1]])[0]
    return x[:, start:start + size].float().cpu()


def trim_ties(window: torch.Tensor, f: int, near: float) -> int:
    """The window's coordinates at which two values next to the
    ``f``-trimmed range's bounds lie within ``near`` of each other: where
    a stack whose entries differ by ``near / 2`` may count a worker in or
    out of the range (``trimmed_frac``) differently."""
    n = window.shape[0]
    g = torch.sort(window.double(), dim=0).values
    ties = ((g[f] - g[f - 1]) <= near) | ((g[n - f] - g[n - f - 1]) <= near)
    return int(ties.sum())


def _sketch_check(records, f: int) -> Dict[str, Any]:
    """Each recorded telemetry row against ``tree_diagnostics`` on one
    device from the step's gathered stack and aggregate (the row's own
    selection, scores and snapshots): the rows that differ in any bit,
    and per row its selection (picked indices),
    :func:`reachable_selections` and :func:`sketch_window`."""
    bad = 0
    for stack, agg, row in records:
        one = tree_diagnostics([stack], [agg], row.selected, row.scores, f,
                               row.step, row.reputation, row.staleness)
        bad += not all(torch.equal(a, b) for a, b in zip(one, row))
    return {"rows": len(records), "differ": bad,
            "selected": [tuple(torch.nonzero(row.selected > 0).reshape(-1)
                               .tolist()) for _, _, row in records],
            "reachable": [reachable_selections(s, f)
                          for s, _, _ in records],
            "windows": [sketch_window(s) for s, _, _ in records]}


def _k5_times(x: torch.Tensor, f: int) -> Dict[str, float]:
    """K5 on a decode step's ``(n, B V)`` stack against its plain
    version (1e-4 of the largest entry, ``selected`` exact) and timed by
    CUDA events ("not measured" off the card)."""
    got, want = fused_aggregate(x, f, mode="bulyan-krum"), \
        fused_aggregate_plain(x, f, mode="bulyan-krum")
    err = float((got[0] - want[0]).abs().max())
    rel = err / max(float(want[0].abs().max()), 1e-30)
    if not (rel <= 1e-4 and torch.equal(got[1], want[1])):
        raise AssertionError(f"K5 on the {tuple(x.shape)} stack: {rel:.3e}")
    out = dict(shape=tuple(x.shape), max_abs_err=err, rel_err=rel,
               ms=math.nan, plain_ms=math.nan)
    if x.device.type == "cuda":
        out.update(
            ms=_event_ms(lambda: fused_aggregate(x, f, mode="bulyan-krum"),
                         x.device, reps=20, warmup=2),
            plain_ms=_event_ms(lambda: fused_aggregate_plain(
                x, f, mode="bulyan-krum"), x.device, reps=3))
    return out


def _k1_times(x: torch.Tensor) -> Dict[str, float]:
    """K1 on a rank's vocabulary slice of a stack, against its plain
    version at 1e-4 of the largest entry, timed beside ``torch.mm``."""
    raw, plain = pairwise_gram_partial(x), pairwise_gram_partial_plain(x)
    err = float((raw - plain).abs().max())
    rel = err / max(float(plain.abs().max()), 1e-30)
    if not rel <= 1e-4:
        raise AssertionError(f"K1 on the {tuple(x.shape)} slice: {rel:.3e}")
    out = dict(shape=tuple(x.shape), max_abs_err=err, rel_err=rel,
               ms=math.nan, plain_ms=math.nan, library_ms=math.nan)
    if x.device.type == "cuda":
        out.update(
            ms=_event_ms(lambda: pairwise_gram_partial(x), x.device,
                         reps=20, warmup=2),
            plain_ms=_event_ms(lambda: pairwise_gram_partial_plain(x),
                               x.device, reps=5),
            library_ms=_event_ms(lambda: torch.mm(x, x.T), x.device,
                                 reps=20, warmup=2))
    return out


def serve_rank(mesh, setting: Dict[str, Any]) -> Dict[str, Any]:
    """The ensemble engine on this rank (``setting["single"]``: on one
    device, ``mesh=None``), one run per name in ``setting["runs"]``.

    ``setting``: ``arch``, ``layers`` (``None``: the reduced config),
    ``n``, ``f``, ``seed``, ``reqs`` (``(rid, prompt, max_new)``),
    ``slots``, ``cache_len``, ``runs`` (names of :data:`RUNS`),
    ``single``, ``shape`` (a mesh of that shape over the same ranks in
    place of ``mesh``), ``shared`` (a single-device run's ``"inputs"``,
    for the first run's probe: :meth:`_Probe._on_shared`), ``time_k5``
    (time K5 on the first run's captured stack, each rank with the card
    alone), ``time_k1`` (time K1 on the rank's vocabulary slice of it).

    Returns:
      Per run ``{"streams", "gaps", "calls", "wall_s" (the run less the
      probe's own host time), "launches" (the run's counts from 0, the
      probe's own decode steps left out), "probe_launches" (theirs),
      "comm", "telemetry", "peak_gib"}`` (the peak from the end of the
      build); the first run also ``"stack"`` and ``"agg"``, the first
      decode step's gathered stack and aggregate, ``"on_stack"``: whether
      ``aggregate_logits`` on one device on that stack, under the backend
      the engine's mesh resolves, gives the step's selection and its
      aggregate bit for bit, and ``"on_stack_scores"``: its scores'
      largest difference over their largest |entry|, ``"witness"`` (the
      probe's: the poisoned rows this rank holds against float64),
      ``"on_shared"`` (given ``shared``) and on one device ``"inputs"``
      (the probe's); the ``telemetry``
      run also ``"sketch"``, :func:`_sketch_check` of its rows.  Besides:
      ``"n_local"``, ``"share_bytes"`` (the first engine's parameters),
      ``"whole_bytes"`` (the whole ensemble the rank built first),
      ``"layout"`` (under a mesh, ``launch.dryrun.serve_layout_bytes``:
      what the rank's share should take), ``"resident_gib"``
      (allocated after the build), ``"build_peak_gib"`` (the peak while
      the ranks built in turn, the whole ensemble and the share at
      once), ``"peak_gib"``, ``"build_s"``, ``"k5"`` / ``"k1"`` and
      ``"coords"``.
    """
    dev = mesh.device
    _setup(dev)
    if setting.get("shape"):
        mesh = make_host_mesh(setting["shape"], device=dev,
                              backend=mesh.backend)
    cfg = _config(setting["arch"], setting["layers"])
    n, f = setting["n"], setting["f"]
    engine_mesh = None if setting.get("single") else mesh
    out: Dict[str, Any] = {"coords": dict(mesh.coords)}
    base = AggSpec(f=f, gar="bulyan-krum", distance_backend="fused")
    engines = {}
    t0 = time.perf_counter()

    def build():
        params = ensemble(cfg, n, f, setting["seed"], dev)
        out["whole_bytes"] = sum(x.numel() * x.element_size()
                                 for x in tree_leaves(params))
        for name in setting["runs"]:
            engines[name] = ServingEngine(
                params, cfg, n_slots=setting["slots"],
                cache_len=setting["cache_len"],
                ensemble=dataclasses.replace(base, **RUNS[name]),
                mesh=engine_mesh)
        # the engines keep copies of the rank's share when it is a slice
        if engine_mesh is not None and (
                replica_rows(n, mesh)[1]
                or mesh_axis_sizes(mesh).get("model", 1) > 1):
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _world_in_turn(build)
    out["build_s"] = time.perf_counter() - t0
    out["build_peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if dev.type == "cuda" else math.nan)
    out["resident_gib"] = (torch.cuda.memory_allocated(dev) / 2 ** 30
                           if dev.type == "cuda" else math.nan)
    share = engines[setting["runs"][0]].params
    out["n_local"] = tree_leaves(share)[0].shape[0]
    out["share_bytes"] = sum(x.numel() * x.element_size()
                             for x in tree_leaves(share))
    if engine_mesh is not None:
        from repro_torch.launch.dryrun import serve_layout_bytes
        out["layout"] = serve_layout_bytes(cfg, mesh, n)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first = setting["runs"][0]
    for name in setting["runs"]:
        eng = engines.pop(name)
        probe = _Probe(eng, mesh, n, f, capture=name == first,
                       record=name == "telemetry",
                       shared=setting.get("shared") if name == first
                       else None)
        reqs = [Request(rid, np.asarray(p, np.int32), m)
                for rid, p, m in setting["reqs"]]
        mesh.reset_comm()
        _sync(dev)
        # the run's launch counts from 0, read just after it
        _build.reset_launches()
        t0 = time.perf_counter()
        streams = eng.run(reqs, max_steps=400)
        _sync(dev)
        run = {"streams": streams, "gaps": probe.gaps, "calls": probe.calls,
               "wall_s": time.perf_counter() - t0 - probe.extra_s,
               "launches": {k: _build.LAUNCHES[k] - probe.own[k]
                            for k in probe.own},
               "probe_launches": dict(probe.own),
               "comm": comm_snapshot(mesh.comm),
               "telemetry": eng.telemetry()}
        run["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                           if dev.type == "cuda" else math.nan)
        if probe.records:
            run["sketch"] = _sketch_check(probe.records, f)
        if name == first:
            stack = probe.stack
            agg, sel, scores = probe.first
            backend = resolve_distance_backend(base.distance_backend,
                                               engine_mesh)
            on_stack, res = sr.aggregate_logits(stack, f, base.gar,
                                                distance_backend=backend)[:2]
            run.update(stack=stack.cpu(), agg=agg.cpu(),
                       witness=probe.witness, on_shared=probe.on_shared,
                       inputs=probe.inputs,
                       on_stack=bool(torch.equal(on_stack, agg)
                                     and torch.equal(res.selected, sel)),
                       on_stack_scores=float(
                           (res.scores - scores).abs().max()
                           / res.scores.abs().max().clamp_min(1e-30)))
            flat = stack.reshape(n, -1).contiguous()
            if setting.get("time_k5"):
                out["k5"] = _world_in_turn(lambda: _k5_times(flat, f))
            if setting.get("time_k1"):
                from repro_torch.dist.sharding import (local_shard,
                                                       logits_pspec)
                sl = local_shard(stack, logits_pspec(tuple(stack.shape),
                                                     mesh), mesh)
                sl = sl.reshape(n, -1).contiguous()
                out["k1"] = _world_in_turn(lambda: _k1_times(sl))
            del stack, flat, on_stack
        out[name] = run
        del eng, probe
    out["peak_gib"] = math.nan
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        # a probe and its engine hold each other: free the last run's
        # replicas now, before a next setting builds its own
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_settings(mesh, settings) -> List[Dict[str, Any]]:
    """:func:`serve_rank` for each setting in turn (one process for the
    single-device runs of several phases)."""
    return [serve_rank(mesh, s) for s in settings]
