"""Rank functions that drive the sharded train step on a mesh and report
what the run measured, for ``chip_smoke.py``'s phase 10 and the card
tests (``tests/test_torch_cuda.py``).

``run_on_mesh`` spawns its ranks, and a spawned rank imports the
function it runs: the caller puts this directory on ``sys.path``, which
the ranks inherit.  Each rank counts the kernels' launches around every
step of the main path (counters are per process), times the steps on the
host clock and the collectives, keeps the Bulyan window codes of each
step's own submissions (read through the step's ``observe`` hook, where
two runs' roundings may choose different windows), and returns its
parameter slices for the caller to hold against a single-device run by
the rule of ``torch_llm_compare``.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.agg.specs import AggSpec
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.dist import robust
from repro_torch.dist.async_train import (init_async_state,
                                          make_async_train_step)
from repro_torch.dist.mesh import comm_snapshot
from repro_torch.dist.sharding import (_spec_leaves, gather_tree,
                                       gram_shardings, model_dim,
                                       param_shardings, shard_tree)
from repro_torch.dist.train import (byzantine_grads, make_loss_fn,
                                    make_train_step)
from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_gram import (pairwise_gram_partial,
                                               pairwise_gram_partial_plain)
from repro_torch.models import init_model
from repro_torch.optim import get_optimizer
from torch_llm_compare import SLICE, leaf_windows

__all__ = ["gather_slices", "llm_rank", "pod_rank", "reduced_rank",
           "single_rank", "whole_windows"]

#: tile width of K1's plain version when timed on a wide shard
PLAIN_TILE = 2 ** 20


def _setup(device: torch.device) -> None:
    """The parity settings of the single-device runs: no TF32, cuDNN's
    deterministic algorithms, one intra-op thread on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if device.type == "cpu":
        torch.set_num_threads(1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cpu(tree):
    return tree_map(lambda x: x.detach().cpu().clone(), tree)


def _windows(sub, selected: torch.Tensor, f: int):
    """Per leaf of a worker-stacked tree, ``leaf_windows`` on the picks
    ``selected`` marks, in each leaf's per-worker shape (CPU)."""
    picks = torch.nonzero(selected > 0).reshape(-1)
    return [leaf_windows(leaf[picks].reshape(picks.numel(), -1), f)
            .reshape(leaf.shape[1:]).cpu() for leaf in tree_leaves(sub)]


class _Observer:
    """The counted steps' ``observe`` hook: each step's selection and its
    leaves' window codes, the seconds they took (to be taken out of the
    step's time) and the card's peak allocation before them (their own
    is reset away, so a step's peak is the step's)."""

    def __init__(self, f: int, device: torch.device):
        self.f, self.device = f, device
        self.windows, self.selected, self.seconds = [], [], []
        self.peak = 0

    def __call__(self, sub, res) -> None:
        _sync(self.device)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            self.peak = torch.cuda.max_memory_allocated(self.device)
        self.windows.append(_windows(sub, res.selected, self.f))
        self.selected.append(res.selected.tolist())
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.seconds.append(time.perf_counter() - t0)

    def step_peak_gib(self) -> float:
        """The peak allocation of the step that just ended, in GiB."""
        if self.device.type != "cuda":
            return 0.0
        return max(self.peak,
                   torch.cuda.max_memory_allocated(self.device)) / 2 ** 30


def _event_ms(fn, device, reps: int = 5, warmup: int = 1) -> float:
    """CUDA-event time per call, the L2 cache flushed before each (a
    96 MB write evicts the H100's 50 MB)."""
    flush = torch.empty(24 * 2 ** 20, dtype=torch.float32, device=device)
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _f64_raw(x: torch.Tensor) -> torch.Tensor:
    """K1's function, ``sq_i + sq_j - 2 <x_i, x_j>`` over all columns, in
    float64 over column slices."""
    out = 0.0
    for c0 in range(0, x.shape[1], SLICE):
        blk = x[:, c0:c0 + SLICE].double()
        sq = torch.sum(blk * blk, dim=1)
        out = out + (sq[:, None] + sq[None, :] - 2.0 * (blk @ blk.T))
    return out


def _in_turn(mesh, fn):
    """``fn()`` on one rank of the ``model`` axis at a time (the others
    wait in a host collective), so a rank's timing has the card alone."""
    out = None
    for r in range(mesh.size("model")):
        if mesh.index("model") == r:
            out = fn()
        mesh.all_reduce(torch.zeros(1, device=mesh.device), "model")
    return out


def _shard_k1(mesh, x: torch.Tensor) -> Dict[str, Any]:
    """K1 on one rank's embedding slice against its float64 function at
    1e-4 of the largest entry, and its time beside the plain version's
    and ``torch.mm``'s (each rank in turn)."""
    n = x.shape[0]
    raw = pairwise_gram_partial(x)
    exact = _f64_raw(x)
    scale = float(exact.abs().max())
    err = float((raw.double() - exact).abs().max())
    plain_err = float((pairwise_gram_partial_plain(
        x, block_d=PLAIN_TILE).double() - exact).abs().max())
    del exact
    if not err <= 1e-4 * scale:
        raise AssertionError(f"K1 on the {tuple(x.shape)} shard: {err:.3e} "
                             f"of {scale:.3e}")
    # times are taken on the card only ("not measured" elsewhere)
    times = dict(ms=math.nan, plain_ms=math.nan, library_ms=math.nan)
    if x.device.type == "cuda":
        times = _in_turn(mesh, lambda: dict(
            ms=_event_ms(lambda: pairwise_gram_partial(x), x.device),
            plain_ms=_event_ms(lambda: pairwise_gram_partial_plain(
                x, block_d=PLAIN_TILE), x.device, reps=2),
            library_ms=_event_ms(lambda: torch.mm(x, x.T), x.device)))
    return dict(shape=(n, x.shape[1]), max_abs_err=err, rel_err=err / scale,
                plain_rel_err=plain_err / scale, **times)


def _step0_gate(mesh, sub, gspecs, dists, f: int,
                window: int) -> Dict[str, Any]:
    """Step 0's sharded aggregation (``distributed_aggregate`` under the
    mesh) against the single-device ``xla`` backend on the same
    submissions, gathered leaf by leaf to the rank at index 0 of
    ``model``: the all-reduced ``(n, n)`` matrix and each aggregate leaf
    at 1e-4 of its largest entry, ``selected`` equal."""
    agg, res = robust.distributed_aggregate(
        sub, f, "bulyan-krum", distance_backend="fused", mesh=mesh,
        specs=gspecs)
    keep = mesh.index("model") == 0
    whole, aggs = [], []
    specs = _spec_leaves(gspecs)
    for leaf, a, s in zip(tree_leaves(sub), tree_leaves(agg), specs):
        d = model_dim(s)
        whole.append(leaf if d is None else mesh.gather(leaf, "model", d))
        aggs.append(a if d is None else mesh.gather(a, "model", d - 1))
    out = {}
    if keep:
        tree = tree_unflatten(sub, whole)
        wd = robust.pairwise_sq_dists_tree(tree, distance_backend="xla")
        want, wres = robust.distributed_aggregate(
            tree, f, "bulyan-krum", distance_backend="xla", window=window)
        if not torch.equal(res.selected, wres.selected):
            raise AssertionError(f"step 0: selected {res.selected.tolist()}"
                                 f" vs xla {wres.selected.tolist()}")
        d_rel = float((dists - wd).abs().max() / wd.abs().max())
        worst = 0.0
        for k, (a, b) in enumerate(zip(aggs, tree_leaves(want))):
            rel = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            worst = max(worst, rel)
            if not rel <= 1e-4:
                raise AssertionError(f"step 0: aggregate leaf {k} differs "
                                     f"from xla by {rel:.3e}")
        if not d_rel <= 1e-4:
            raise AssertionError(f"step 0: distances {d_rel:.3e} off xla")
        out = dict(dists_rel=d_rel, agg_rel=worst,
                   selected=res.selected.tolist())
        del tree, want, whole, aggs
        if _on_card(sub):
            torch.cuda.empty_cache()
    mesh.all_reduce(torch.zeros(1, device=mesh.device), "model")
    return out


def _on_card(tree) -> bool:
    """Whether a tree's leaves live on a card."""
    return tree_leaves(tree)[0].device.type == "cuda"


def _llm_setting(arch: str, layers: Optional[int], f: int):
    """``(cfg, spec)`` of :func:`llm_rank` and :func:`single_rank`."""
    cfg = (get_reduced(arch) if layers is None
           else dataclasses.replace(get_config(arch), n_layers=layers))
    spec = AggSpec(f=f, gar="bulyan-krum", attack="omniscient_linf",
                   distance_backend="fused")
    return cfg, spec


def single_rank(mesh, arch: str, layers: Optional[int], n: int, f: int,
                batches, steps: int, lr: float, seed: int,
                worker_chunk: Optional[int]) -> Dict[str, Any]:
    """:func:`llm_rank`'s setting through the single-device step, on a
    one-position mesh's device (a process of its own, so its memory is
    gone when it returns).

    Returns:
      ``{"after": the parameter leaves after the last step (CPU),
      "losses", "step_ms", "peak_gib", "windows": per step and leaf
      ``leaf_windows`` on the step's own submissions, "selected": per
      step, "seconds": {"windows": per step}}``.
    """
    dev = mesh.device
    _setup(dev)
    cfg, spec = _llm_setting(arch, layers, f)
    params = init_model(seed, cfg, device=dev)
    opt = get_optimizer("momentum", lr)
    state = opt.init(params)
    seen = _Observer(f, dev)
    step = make_train_step(cfg, spec, opt, worker_chunk=worker_chunk,
                           observe=seen)
    out: Dict[str, Any] = {"losses": [], "step_ms": [], "peak_gib": 0.0}
    for t in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[t])
        _sync(dev)
        out["step_ms"].append((time.perf_counter() - t0 - seen.seconds[-1])
                              * 1e3)
        out["losses"].append(float(m["loss"]))
        out["peak_gib"] = max(out["peak_gib"], seen.step_peak_gib())
    out["after"] = [p.detach().cpu() for p in tree_leaves(params)]
    out.update(windows=seen.windows, selected=seen.selected,
               seconds={"windows": seen.seconds})
    return out


def llm_rank(mesh, arch: str, layers: Optional[int], n: int, f: int,
             batches, steps: int, lr: float, seed: int,
             worker_chunk: Optional[int]) -> Dict[str, Any]:
    """The zoo's sharded train step at full width on this rank.

    ``arch`` at its published widths with ``layers`` layers (``None``:
    its ``reduced()`` config), random weights from ``seed``;
    ``bulyan-krum`` over ``fused`` (``pallas`` under a ``model`` axis),
    ``omniscient_linf``, momentum SGD ``lr``; ``batches[t]`` is step t's
    whole worker batch.  Before the counted steps one uncounted pass
    takes step 0's submissions, holds the sharded aggregation of them to
    the single-device ``xla`` backend and K1 on this rank's embedding
    slice to its float64 function (and times it); each counted step
    hands its own submissions and selection to an :class:`_Observer`.

    Returns:
      ``{"params": this rank's parameter slices (CPU), "windows": per
      step and leaf ``leaf_windows`` on this rank's slices of the step's
      submissions (CPU), "selected": per step, "launches": per step,
      "seconds": where the rank's time went, "step_ms" (the observer's
      time taken out), "comm_s", "comm_bytes", "comm_kinds" (per step,
      ``Mesh.comm["by_kind"]``: the calls and result bytes of each kind
      of collective), "losses", "step_peak_gib" (the card's peak
      allocation during each counted step), "k1", "step0", "coords"}``.
      The collectives counted are the step call's own: the counters are
      zeroed just before it, the step-0 gate's gathers and the K1 probe
      ran before the counted steps, and the observer moves nothing
      between ranks.
    """
    dev = mesh.device
    _setup(dev)
    cfg, spec = _llm_setting(arch, layers, f)
    params = init_model(seed, cfg, device=dev)
    template = tree_map(lambda p: p.to("meta"), params)
    pspecs = param_shardings(params, mesh)
    gspecs = gram_shardings(params, mesh)
    local = tree_map(lambda x: x.clone(), shard_tree(params, pspecs, mesh))
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    opt = get_optimizer("momentum", lr)
    state = opt.init(local)
    seen = _Observer(f, dev)
    step = make_train_step(cfg, spec, opt, mesh=mesh,
                           worker_chunk=worker_chunk, template=template,
                           observe=seen)
    out: Dict[str, Any] = {"launches": [], "step_ms": [], "comm_s": [],
                           "comm_bytes": [], "comm_kinds": [], "losses": [],
                           "step_peak_gib": [], "seconds": {}}
    t0 = time.perf_counter()
    _, sub = byzantine_grads(make_loss_fn(cfg), spec, local, batches[0],
                             state["step"], worker_chunk, mesh=mesh,
                             template=template)
    dists = robust.pairwise_sq_dists_tree(
        sub, distance_backend="fused", mesh=mesh, specs=gspecs)
    _sync(dev)
    t1 = time.perf_counter()
    table = sub["embed"]["table"]
    out["k1"] = _shard_k1(mesh, table.reshape(table.shape[0], -1))
    del table
    t2 = time.perf_counter()
    out["step0"] = _step0_gate(mesh, sub, gspecs, dists, f, SLICE)
    out["seconds"].update(gate_pass=t1 - t0, k1=t2 - t1,
                          gate=time.perf_counter() - t2)
    del sub, dists
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for t in range(steps):
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        mesh.reset_comm()
        t0 = time.perf_counter()
        local, state, m = step(local, state, batches[t])
        _sync(dev)
        out["step_ms"].append((time.perf_counter() - t0 - seen.seconds[-1])
                              * 1e3)
        out["step_peak_gib"].append(seen.step_peak_gib())
        out["launches"].append(dict(_build.LAUNCHES))
        out["comm_s"].append(mesh.comm["seconds"])
        out["comm_bytes"].append(mesh.comm["bytes"])
        out["comm_kinds"].append(comm_snapshot(mesh.comm)["by_kind"])
        out["losses"].append(float(m["loss"]))
    out["params"] = _cpu(local)
    out["coords"] = dict(mesh.coords)
    out["median_step_ms"] = statistics.median(out["step_ms"])
    out.update(windows=seen.windows, selected=seen.selected)
    out["seconds"]["windows"] = seen.seconds
    return out


def reduced_rank(mesh, arch: str, n: int, f: int, batches, steps: int,
                 lr: float, params_seed: int,
                 attn_shard: str = "none") -> Dict[str, Any]:
    """A reduced config's sharded steps on this rank: ``bulyan-krum``
    (synchronous), the asynchronous step at tau = 2 with
    ``stale-bulyan-krum`` and at tau = 0, all over ``fused`` under
    ``omniscient_linf`` with momentum SGD, from the same weights, with
    the config's ``attn_shard`` set to ``attn_shard``.

    Returns:
      Per run the parameters after each step (whole, CPU), the launches
      per step, the metrics, the step's collectives per kind and its
      time; for the synchronous run each step's submissions (whole,
      through the step's ``observe`` hook, gathered after the step) and
      for the tau = 2 run each step's bus and versions; and whether
      tau = 0 equals the synchronous run bit for bit.
    """
    dev = mesh.device
    _setup(dev)
    cfg = dataclasses.replace(get_reduced(arch), attn_shard=attn_shard)
    params = init_model(params_seed, cfg, device=dev)
    template = tree_map(lambda p: p.to("meta"), params)
    pspecs = param_shardings(params, mesh)
    gspecs = gram_shardings(params, mesh)
    out: Dict[str, Any] = {"coords": dict(mesh.coords)}

    def run(name, **kw):
        spec = AggSpec(f=f, attack="omniscient_linf",
                       distance_backend="fused", **kw)
        opt = get_optimizer("momentum", lr)
        local = tree_map(lambda x: x.clone(),
                         shard_tree(params, pspecs, mesh))
        state = opt.init(local)
        asynchronous = "async_tau" in kw
        subs = []
        if asynchronous:
            step = make_async_train_step(cfg, spec, opt, mesh=mesh,
                                         template=template)
            agg_state = init_async_state(spec, template, n, mesh=mesh)
        else:
            step = make_train_step(
                cfg, spec, opt, mesh=mesh, template=template,
                observe=lambda sub, res: subs.append(_cpu(sub)))
        rows = []
        for t in range(steps):
            row = {}
            _sync(dev)
            _build.reset_launches()
            mesh.reset_comm()
            t0 = time.perf_counter()
            if asynchronous:
                local, state, m, agg_state = step(local, state, batches[t],
                                                  agg_state)
            else:
                local, state, m = step(local, state, batches[t])
            _sync(dev)
            row["ms"] = (time.perf_counter() - t0) * 1e3
            row["launches"] = dict(_build.LAUNCHES)
            row["comm_kinds"] = comm_snapshot(mesh.comm)["by_kind"]
            if asynchronous:
                row["bus"] = _cpu(gather_tree(agg_state.bus.grads, gspecs,
                                              mesh))
                row["versions"] = agg_state.bus.versions.cpu()
            else:
                row["sub"] = _cpu(gather_tree(subs[-1], gspecs, mesh))
            row["params"] = _cpu(gather_tree(local, pspecs, mesh))
            row["metrics"] = {k: float(v) for k, v in m.items()}
            rows.append(row)
        out[name] = rows

    run("sync", gar="bulyan-krum")
    run("async", gar="stale-bulyan-krum", async_tau=2)
    run("async0", gar="bulyan-krum", async_tau=0)
    out["tau0_is_sync"] = all(
        torch.equal(a, b)
        for ra, rb in zip(out["async0"], out["sync"])
        for a, b in zip(tree_leaves(ra["params"]), tree_leaves(rb["params"])))
    return out


def pod_rank(mesh, arch: str, n: int, f: int, batch, lr: float,
             params_seed: int) -> Dict[str, Any]:
    """One synchronous sharded step of a reduced config on a mesh with a
    ``pod`` axis (``attn_shard="batch"``): ``bulyan-krum`` over ``fused``
    under ``omniscient_linf`` with momentum SGD.

    Returns:
      ``{"coords", "params" (whole, CPU), "sub" (the step's submissions,
      whole), "launches", "comm_kinds", "ms", "metrics"}``.
    """
    dev = mesh.device
    _setup(dev)
    cfg = dataclasses.replace(get_reduced(arch), attn_shard="batch")
    params = init_model(params_seed, cfg, device=dev)
    template = tree_map(lambda p: p.to("meta"), params)
    pspecs = param_shardings(params, mesh)
    gspecs = gram_shardings(params, mesh)
    local = tree_map(lambda x: x.clone(), shard_tree(params, pspecs, mesh))
    opt = get_optimizer("momentum", lr)
    state = opt.init(local)
    subs = []
    spec = AggSpec(f=f, gar="bulyan-krum", attack="omniscient_linf",
                   distance_backend="fused")
    step = make_train_step(cfg, spec, opt, mesh=mesh, template=template,
                           observe=lambda sub, res: subs.append(_cpu(sub)))
    _sync(dev)
    _build.reset_launches()
    mesh.reset_comm()
    t0 = time.perf_counter()
    local, state, m = step(local, state, batch)
    _sync(dev)
    out = {"coords": dict(mesh.coords),
           "ms": (time.perf_counter() - t0) * 1e3,
           "launches": dict(_build.LAUNCHES),
           "comm_kinds": comm_snapshot(mesh.comm)["by_kind"],
           "metrics": {k: float(v) for k, v in m.items()}}
    out["params"] = _cpu(gather_tree(local, pspecs, mesh))
    out["sub"] = _cpu(gather_tree(subs[-1], gspecs, mesh))
    return out


def whole_windows(ranks: Sequence[Any], specs: Any) -> List[Any]:
    """The ranks' per-step ``windows`` (each a list over leaves of this
    rank's slices), as whole leaves per step."""
    return [gather_slices([r[t] for r in ranks], specs)
            for t in range(len(ranks[0]))]


def gather_slices(slices: Sequence[Any], specs: Any) -> List[torch.Tensor]:
    """Whole leaves from the ranks' slices along one mesh axis (in the
    axis' order): each leaf concatenated along the dim its spec splits
    over ``model`` (a replicated leaf is taken from the first)."""
    out = []
    for k, s in enumerate(_spec_leaves(specs)):
        parts = [tree_leaves(t)[k] for t in slices]
        d = model_dim(s)
        out.append(parts[0] if d is None else torch.cat(parts, dim=d))
    return out
