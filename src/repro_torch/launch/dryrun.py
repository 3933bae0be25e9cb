"""Production-mesh dry-run: trace one rank's step of every (arch x input
shape) on ``meta`` tensors at the production mesh's shapes, and write
the reference's artifact (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles one GSPMD program over 512 host
devices.  The port is explicit SPMD (one process per mesh position), and
torch has no way to compile over 512 ranks, so the dry-run takes rank 0
of the production mesh (16 x 16 ``("data", "model")``, or 2 x 16 x 16
with ``--multi-pod``) and runs its step on ``meta`` tensors: every
argument at that rank's local shape (``repro_torch.launch.specs``), the
mesh a :class:`RecordingMesh` of the production shape that records each
collective instead of running it.  Nothing is allocated and no process
group is started, so it runs anywhere, in seconds.

The artifact keeps the reference's keys; where a value means something
else in the port it says so here:

  memory_analysis   ``argument_size_in_bytes`` (the rank's step inputs),
                    ``output_size_in_bytes`` (its outputs) and
                    ``temp_size_in_bytes``: the peak of the live non-view
                    tensors the step creates (the outputs while they are
                    live included), as the trace's allocations run
  cost_analysis     ``flops`` (``torch.utils.flop_counter``) and ``bytes
                    accessed``: every traced ATen op's inputs and outputs
                    summed, views and allocations left out (an unfused
                    upper count; a kernel's own reads are not ATen ops,
                    so they are not in it: ``kernel_launches`` lists them)
  collectives       per kind, ``{bytes, count}`` of the rank's collectives
                    by the convention of ``Mesh.comm`` (a result's bytes;
                    a ``gather`` counts no bytes on a rank it leaves
                    without a result): the reference's five kinds (the
                    port runs no reduce-scatter, all-to-all or permute)
                    plus the port's ``broadcast`` and ``gather``
  hlo_lines         the number of ATen ops traced
  lower_s/compile_s the seconds to build the step and its arguments, and
                    to trace it
  kernel_launches   what the step would launch on the card
                    (``repro_torch.kernels._build.LAUNCHES``' difference;
                    the kernel wrappers count a launch on ``meta`` where
                    they launch on the card)
  roofline          the three terms against the H100's data-sheet figures
                    (below), the dominant one, and ``model_flops`` per
                    rank over the traced FLOPs
  no_effect         the flags the port accepts and records but has nothing
                    to switch: ``--expert-gather`` (the port's MoE has no
                    expert-weight gather), ``--unroll`` (the port loops
                    over periods; there is no scan to unroll) and
                    ``--attn-shard`` (no GSPMD constraint to pin)

The roofline's constants are data-sheet figures of an H100 SXM5 80GB at
its 700 W power limit: HBM3 at 3.35e12 B/s; 67e12 FLOP/s for an fp32 step
(the port runs with TF32 off) or 989.4e12 for bf16 (dense tensor cores),
recorded as ``peak_flops``; and 50e9 B/s per GPU for collectives, one
400 Gb/s NDR InfiniBand port per GPU, since every axis of 16 ranks spans
more than one 8-GPU node.  They are an estimate for one rank's step, not
a measurement.

A step's host reads (a Bulyan pick, the attack's ``"top"`` coordinate)
take the first candidate on ``meta`` (``repro_torch.device.host_index``):
no shape, launch or collective after them depends on the pick.
``distance_backend="auto"`` resolves as on the CPU (``xla``: the device
is not a card); pass ``--distance-backend pallas`` or ``fused`` for the
kernels' route.

Run as ``python -m repro_torch.launch.dryrun --arch ... --shape ...``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.pytree import tree_leaves
from repro_torch.dist.mesh import (COMM_KINDS, _count_comm, _zero_comm,
                                   mesh_axis_sizes)

__all__ = ["HBM_BW", "NET_BW", "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32",
           "RecordingMesh", "model_flops", "run_one", "trace_serve_step",
           "trace_step", "trace_train_step"]

#: H100 SXM5 80GB data-sheet figures at 700 W (see the module docstring)
HBM_BW = 3.35e12             # bytes/s
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, CUDA cores (TF32 off)
PEAK_FLOPS_BF16 = 989.4e12   # FLOP/s, dense tensor cores
NET_BW = 50e9                # bytes/s per GPU, one NDR 400 Gb/s port

#: the artifact's collective kinds: the reference's five, then the port's
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast", "gather")


class RecordingMesh:
    """A stand-in for ``repro_torch.dist.mesh.Mesh`` that records each
    collective instead of running it: one rank's view of a mesh of any
    shape, with no process group behind it.

    It has ``Mesh``'s interface (``axis_names``, ``shape``, ``devices``,
    ``rank``, ``coords``, ``device``, ``size``, ``index``, ``comm``,
    ``reset_comm``).  Its ``all_reduce``, ``all_gather``, ``gather`` and
    ``broadcast`` return tensors of the result's shape and dtype on the
    input's device (empty on ``meta``, zeros elsewhere) and count calls
    and result bytes per kind in ``comm["by_kind"]`` exactly where a
    ``Mesh`` counts them: nothing on an axis of one rank, no bytes on a
    rank that a ``gather`` leaves without a result.

    Args:
      shape: the mesh's shape, e.g. ``(16, 16)``.
      axis_names: one name per dimension (defaults as
        ``make_host_mesh``'s).
      rank: the rank whose view this is.
    """

    backend = "recording"

    def __init__(self, shape: Tuple[int, ...],
                 axis_names: Optional[Sequence[str]] = None, rank: int = 0):
        self.shape = tuple(int(s) for s in shape)
        if axis_names is None:
            axis_names = (("pod", "data", "model") if len(self.shape) == 3
                          else ("data", "model")[:len(self.shape)])
        if len(axis_names) != len(self.shape):
            raise ValueError(f"{len(self.shape)}-d mesh needs "
                             f"{len(self.shape)} axis names, got "
                             f"{axis_names!r}")
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(math.prod(self.shape)).reshape(self.shape)
        self.rank = int(rank)
        self.coords = {name: int(i) for name, i in zip(
            self.axis_names, np.unravel_index(self.rank, self.shape))}
        self.device = torch.device("meta")
        self.comm = _zero_comm()

    def size(self, axis: str) -> int:
        return mesh_axis_sizes(self).get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def reset_comm(self) -> None:
        self.comm = _zero_comm()

    def _result(self, kind: str, x: torch.Tensor, shape) -> torch.Tensor:
        make = torch.empty if x.device.type == "meta" else torch.zeros
        out = make(tuple(shape), dtype=x.dtype, device=x.device)
        _count_comm(self.comm, kind, out.numel() * out.element_size())
        return out

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.size(axis) == 1:
            return x
        return self._result("all_reduce", x, x.shape)

    def _gathered(self, x: torch.Tensor, axis: str, dim: int):
        shape = list(x.shape)
        shape[dim] *= self.size(axis)
        return shape

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        if self.size(axis) == 1:
            return x
        return self._result("all_gather", x, self._gathered(x, axis, dim))

    def gather(self, x: torch.Tensor, axis: str, dim: int = 0,
               dst: int = 0):
        if self.size(axis) == 1:
            return x
        if self.index(axis) != dst:
            _count_comm(self.comm, "gather", 0)
            return None
        return self._result("gather", x, self._gathered(x, axis, dim))

    def broadcast(self, x: torch.Tensor, axis: str,
                  src: int = 0) -> torch.Tensor:
        if self.size(axis) == 1:
            return x
        return self._result("broadcast", x, x.shape)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

#: ops that allocate without moving data
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Traffic(TorchDispatchMode):
    """Counts every ATen op, sums the bytes of its inputs and outputs
    (views and allocations left out) and follows the live bytes of the
    storages the traced ops create, for their peak."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, list] = {}

    def _release(self, key: int) -> None:
        entry = self._held.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._held[key]

    def _hold(self, t: torch.Tensor, new: bool) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._held:
            self._held[key][1] += 1
        elif new:
            self._held[key] = [storage.nbytes(), 1]
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
        else:
            return
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        aliasing = any(r.alias_info is not None
                       for r in func._schema.returns)
        outs = _tensors(out)
        if func not in _ALLOCATIONS and not (
                aliasing and not func._schema.is_mutable):
            self.bytes += sum(_nbytes(t) for t in _tensors(args)
                              + _tensors(list(kwargs.values())))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t, new=not aliasing)
        return out


def _arg_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen, total = set(), 0
    for t in _tensors(tree_leaves(tree)):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def trace_step(fn: Callable, *args, mesh=None) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the counters of the dry-run.

    Args:
      fn: any step; its arguments (trees of tensors, usually ``meta``).
      args: the step's arguments.
      mesh: a :class:`RecordingMesh` the step closes over (its counters
        are zeroed first), or ``None``.

    Returns:
      ``{"out", "flops", "bytes_accessed", "aten_ops", "temp_bytes"
      (the peak of the live tensors the step created), "argument_bytes",
      "output_bytes", "by_kind" (the mesh's ``comm["by_kind"]``, or
      zeros), "launches" (the kernels' launch counts the step added),
      "seconds"}``.
    """
    from repro_torch.kernels import _build
    if mesh is not None:
        mesh.reset_comm()
    before = dict(_build.LAUNCHES)
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    t0 = time.perf_counter()
    with flops, traffic:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    by_kind = (mesh.comm["by_kind"] if mesh is not None
               else _zero_comm()["by_kind"])
    return {"out": out, "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(traffic.bytes),
            "aten_ops": traffic.ops, "temp_bytes": traffic.peak,
            "argument_bytes": _arg_bytes(args),
            "output_bytes": _arg_bytes(out),
            "by_kind": {k: dict(v) for k, v in by_kind.items()},
            "launches": {k: _build.LAUNCHES[k] - before[k] for k in before},
            "seconds": seconds}


def collectives_record(by_kind: Dict[str, Dict[str, int]]
                       ) -> Dict[str, Dict[str, int]]:
    """``comm["by_kind"]`` in the artifact's form: every kind of
    :data:`COLLECTIVES` with ``{bytes, count}``."""
    out = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}
    for kind in COMM_KINDS:
        rec = by_kind.get(kind, {"calls": 0, "bytes": 0})
        name = kind.replace("_", "-")
        out[name] = {"bytes": int(rec["bytes"]), "count": int(rec["calls"])}
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D for training, 2 N_active D for inference."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def peak_flops(cfg) -> float:
    """The roofline's FLOP rate: bf16 tensor cores for a bf16 model, the
    CUDA cores' fp32 rate otherwise."""
    return PEAK_FLOPS_BF16 if cfg.param_dtype == "bfloat16" else (
        PEAK_FLOPS_FP32)


def roofline(flops: float, bytes_accessed: float, coll_bytes: float,
             mf: float, n_chips: int, peak: float) -> Dict[str, Any]:
    """The three roofline terms (seconds), the dominant one and the
    useful-FLOPs ratio, as the reference's artifact has them."""
    terms = {"compute_s": flops / peak, "memory_s": bytes_accessed / HBM_BW,
             "collective_s": coll_bytes / NET_BW}
    return {**terms, "dominant": max(terms, key=terms.get),
            "model_flops_total": mf, "model_flops_per_chip": mf / n_chips,
            "hlo_flops_per_chip": flops,
            "useful_flops_ratio": (mf / n_chips) / flops if flops else None,
            "collective_bytes_per_chip": coll_bytes, "peak_flops": peak,
            "hbm_bytes_per_s": HBM_BW, "net_bytes_per_s": NET_BW}


# ---------------------------------------------------------------------------
# one (arch x shape)
# ---------------------------------------------------------------------------

def _local_replicas(tree, n: int, mesh):
    """A replica-stacked ``meta`` tree cut to this rank's replicas (each
    replica whole: the port has no tensor-parallel forward)."""
    from repro_torch.core.pytree import tree_map
    from repro_torch.dist.sharding import replica_rows
    rows, _ = replica_rows(n, mesh)
    count = len(range(n)[rows])
    return tree_map(lambda x: torch.empty((count,) + tuple(x.shape[1:]),
                                          dtype=x.dtype, device="meta"),
                    tree)


def _meta(x) -> torch.Tensor:
    """A ``meta`` tensor of ``x``'s shape and dtype (``x``: a tensor or
    a numpy array)."""
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    return torch.empty(tuple(x.shape), device="meta",
                       dtype=torch.from_numpy(np.zeros((), x.dtype)).dtype)


def trace_train_step(cfg, spec, optimizer, mesh, batch, *,
                     worker_chunk: Optional[int] = None,
                     asynchronous: bool = False, impl: str = "auto"
                     ) -> Dict[str, Any]:
    """:func:`trace_step` of one rank's sharded train step.

    Builds what ``make_train_step(mesh=)`` (or ``make_async_train_step``
    with ``asynchronous``) takes on the rank ``mesh`` names: the global
    parameter template on ``meta``, the rank's ``param_shardings``
    slices, ``optimizer.init`` of them, a stateful rule's (or the bus's)
    ``AggState`` for the rank, and ``batch`` (the whole worker batch,
    arrays or tensors of any device) as ``meta`` tensors.

    Args:
      cfg: the model configuration.
      spec: the ``AggSpec``.
      optimizer: the port's optimizer.
      mesh: a :class:`RecordingMesh` (its rank is the one traced).
      batch: ``{"tokens", "labels"[, "extra"]}`` with a leading worker
        axis.
      worker_chunk: workers per ``vmap`` pass.
      asynchronous: trace the asynchronous step.
      impl: attention path.

    Returns:
      :func:`trace_step`'s dict.
    """
    from repro_torch.dist.async_train import (init_async_state,
                                              make_async_train_step)
    from repro_torch.dist.train import init_agg_state, make_train_step
    from repro_torch.launch import specs as S
    params, param_sh = S.param_specs(cfg, mesh)
    local = S.local_tree(params, param_sh, mesh)
    opt_state = optimizer.init(local)
    inputs = {k: _meta(v) for k, v in batch.items() if v is not None}
    n_workers = inputs["tokens"].shape[0]
    if asynchronous:
        step = make_async_train_step(cfg, spec, optimizer, impl=impl,
                                     mesh=mesh, template=params,
                                     worker_chunk=worker_chunk)
        args = (local, opt_state, inputs,
                init_async_state(spec, params, n_workers, mesh=mesh))
    else:
        step = make_train_step(cfg, spec, optimizer, impl=impl, mesh=mesh,
                               template=params, worker_chunk=worker_chunk)
        args = (local, opt_state, inputs)
        if spec.rule().stateful:
            args += (init_agg_state(spec, params, n_workers, mesh=mesh),)
    return trace_step(step, *args, mesh=mesh)


def trace_serve_step(cfg, spec, mesh, n_replicas: int, batch: int,
                     cache_len: int, pos=None) -> Dict[str, Any]:
    """:func:`trace_step` of one rank's robust decode step (or verify
    step, with ``spec.speculative_k >= 1``), as ``ServingEngine(mesh=)``
    runs it: the rank's replicas (``sharding.replica_rows``, each whole),
    their ``batch``-slot caches, every slot's token.

    Args:
      cfg: every replica's model configuration.
      spec: the serving ``AggSpec``.
      mesh: a :class:`RecordingMesh`.
      n_replicas: the ensemble's size.
      batch: decode slots.
      cache_len: cache positions.
      pos: the positions as the caller passes them (``None``: a 0-d
        ``meta`` int32, as the reference's dry-run; the engine passes a
        ``(batch,)`` int32 numpy array).

    Returns:
      :func:`trace_step`'s dict.
    """
    from repro_torch.dist.serve_robust import (init_ensemble_state,
                                               make_robust_serve_step,
                                               make_robust_verify_step)
    from repro_torch.launch import specs as S
    eparams, _ = S.ensemble_param_specs(cfg, mesh, n_replicas)
    cache, _ = S.ensemble_cache_specs(cfg, n_replicas, batch, cache_len,
                                      mesh)
    eparams = _local_replicas(eparams, n_replicas, mesh)
    cache = _local_replicas(cache, n_replicas, mesh)
    agg_state = init_ensemble_state(spec, n_replicas, batch, cfg.vocab_size,
                                    device="meta", mesh=mesh)
    k = int(spec.speculative_k or 0)
    if k >= 1:
        step = make_robust_verify_step(cfg, spec, mesh=mesh,
                                       n_replicas=n_replicas)
        tokens = torch.empty((batch, k), dtype=torch.int32, device="meta")
        if pos is None:
            pos = torch.empty((batch,), dtype=torch.int32, device="meta")
    else:
        step = make_robust_serve_step(cfg, spec, mesh=mesh,
                                      n_replicas=n_replicas)
        tokens = torch.empty((batch, 1), dtype=torch.int32, device="meta")
        if pos is None:
            pos = torch.empty((), dtype=torch.int32, device="meta")
    return trace_step(step, eparams, cache, tokens, pos, agg_state,
                      mesh=mesh)


def _write(rec: Dict[str, Any], out_path: Optional[str]) -> None:
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(rec, fh, indent=1)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            gar: str = "bulyan-krum", attack: str = "none",
            reduced: bool = False, impl: str = "auto",
            optimizer_name: str = "momentum", moe_impl: Optional[str] = None,
            param_dtype: Optional[str] = None, agg_dtype: str = "native",
            distance_backend: str = "auto", unroll: bool = False,
            rep_lr: Optional[float] = None,
            async_tau: Optional[int] = None, async_schedule: str = "fixed",
            attn_shard: Optional[str] = None,
            logits_dtype: Optional[str] = None,
            serve_gar: Optional[str] = None, serve_f: int = 2,
            serve_replicas: int = 0, serve_speculative_k: int = 0,
            telemetry: bool = False, expert_gather: bool = False,
            legacy_sharding: bool = False,
            out_path: Optional[str] = None) -> Dict[str, Any]:
    """Trace rank 0's step of one (arch x shape) on the production mesh
    and return (and with ``out_path``, write) the artifact.

    The arguments are the reference's (``--arch`` ids, the same
    defaults), plus ``expert_gather`` / ``legacy_sharding`` (the
    reference's process-wide flags, here per call: the latter sets
    ``repro_torch.dist.sharding.LEGACY_RULES`` for the call).

    Returns:
      The artifact (see the module docstring), or the reference's skip
      record for a shape the arch does not run.
    """
    from repro_torch.agg import quorum
    from repro_torch.configs import get_config, get_reduced, shape_applicable
    from repro_torch.dist import sharding
    from repro_torch.dist.serve import make_prefill_step, make_serve_step
    from repro_torch.dist.train import DistByzantineSpec
    from repro_torch.launch import specs as S
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.optim import get_optimizer

    if not shape_applicable(arch, shape_name):
        rec = {"arch": arch, "shape": shape_name, "skipped": True,
               "reason": "long_500k not applicable (see DESIGN.md §6)"}
        _write(rec, out_path)
        return rec

    cfg = get_reduced(arch) if reduced else get_config(arch)
    overrides: Dict[str, Any] = {}
    if moe_impl:
        overrides["moe_impl"] = moe_impl
    if param_dtype:
        overrides["param_dtype"] = param_dtype
    if unroll:
        overrides["unroll_scan"] = True
    if attn_shard:
        overrides["attn_shard"] = attn_shard
    if logits_dtype:
        overrides["logits_dtype"] = logits_dtype
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    no_effect = [name for name, on in (
        ("expert_gather", expert_gather), ("unroll_scan", unroll),
        ("attn_shard", attn_shard)) if on]
    shape = INPUT_SHAPES[shape_name]
    mesh = RecordingMesh((2, 16, 16) if multi_pod else (16, 16))
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "multi_pod": multi_pod, "gar": gar, "attack": attack,
        "reduced": reduced, "impl": impl, "overrides": overrides,
        "agg_dtype": agg_dtype, "distance_backend": distance_backend,
        "telemetry": telemetry, "rank": mesh.rank,
        "legacy_sharding": legacy_sharding, "no_effect": no_effect,
    }
    n_chips = mesh.devices.size
    t0 = time.perf_counter()
    legacy_before = sharding.LEGACY_RULES
    sharding.LEGACY_RULES = legacy_before or legacy_sharding
    try:
        params, _ = S.param_specs(cfg, mesh)
        inputs, in_sh = S.input_specs(cfg, shape_name, mesh)
        if shape.kind == "train":
            common = dict(f=3, gar=gar, attack=attack, agg_dtype=agg_dtype,
                          distance_backend=distance_backend, rep_lr=rep_lr,
                          telemetry=telemetry)
            if rep_lr is not None:
                record.update(rep_lr=rep_lr)
            if async_tau is not None:
                common.update(async_tau=async_tau,
                              async_schedule=async_schedule)
                record.update(async_tau=async_tau,
                              async_schedule=async_schedule)
            opt = get_optimizer(optimizer_name, 1e-3)
            record["lower_s"] = round(time.perf_counter() - t0, 1)
            traced = trace_train_step(
                cfg, DistByzantineSpec(**common), opt, mesh, inputs,
                asynchronous=async_tau is not None, impl=impl)
        elif shape.kind == "decode" and serve_gar:
            # robust ensemble decode: the rank's replicas (whole), their
            # caches, every slot's token; the logits gathered over data
            n_rep = serve_replicas or quorum(serve_gar, serve_f)
            sspec = DistByzantineSpec(f=serve_f, gar=serve_gar,
                                      agg_dtype=agg_dtype,
                                      distance_backend=distance_backend,
                                      speculative_k=serve_speculative_k,
                                      telemetry=telemetry)
            record.update(serve_gar=serve_gar, serve_f=serve_f,
                          serve_replicas=n_rep,
                          serve_speculative_k=serve_speculative_k)
            record["lower_s"] = round(time.perf_counter() - t0, 1)
            traced = trace_serve_step(cfg, sspec, mesh, n_rep,
                                      shape.global_batch, shape.seq_len)
        else:
            if shape.kind == "prefill":
                # no mesh= here, as in the reference: each rank runs the
                # prefill on its slice of the batch, whole parameters
                step = make_prefill_step(cfg, impl=impl)
                args = tuple(S.local_tree(inputs[k], in_sh[k], mesh)
                             for k in ("tokens", "extra") if k in inputs)
                args = (params,) + args
            else:  # decode: each rank decodes its slice of the batch
                cache, cache_sh = S.cache_specs(cfg, shape.global_batch,
                                                shape.seq_len, mesh)
                step = make_serve_step(cfg)
                args = (params, S.local_tree(cache, cache_sh, mesh),
                        S.local_tree(inputs["token"], in_sh["token"], mesh),
                        inputs["pos"])
            record["lower_s"] = round(time.perf_counter() - t0, 1)
            traced = trace_step(step, *args, mesh=mesh)
        record["compile_s"] = round(traced["seconds"], 1)
    finally:
        sharding.LEGACY_RULES = legacy_before

    coll = collectives_record(traced["by_kind"])
    record["memory_analysis"] = {
        "argument_size_in_bytes": traced["argument_bytes"],
        "output_size_in_bytes": traced["output_bytes"],
        "temp_size_in_bytes": traced["temp_bytes"]}
    record["cost_analysis"] = {"flops": traced["flops"],
                               "bytes accessed": traced["bytes_accessed"]}
    record["collectives"] = coll
    record["top_collective_ops"] = sorted(
        ({"kind": k, "bytes": v["bytes"], "count": v["count"]}
         for k, v in coll.items() if v["count"]),
        key=lambda r: -r["bytes"])
    record["hlo_lines"] = traced["aten_ops"]
    record["kernel_launches"] = {k: v for k, v in traced["launches"].items()
                                 if v}
    coll_bytes = sum(v["bytes"] for v in coll.values())
    record["roofline"] = roofline(
        traced["flops"], traced["bytes_accessed"], coll_bytes,
        model_flops(cfg, shape), n_chips, peak_flops(cfg))
    _write(record, out_path)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    choices=["train_4k", "prefill_32k", "decode_32k",
                             "long_500k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--gar", default="bulyan-krum")
    ap.add_argument("--attack", default="none")
    ap.add_argument("--impl", default="auto",
                    help="attention impl: auto|naive|blockwise")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (fast sanity check)")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "einsum", "scatter"],
                    help="override cfg.moe_impl")
    ap.add_argument("--param-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--agg-dtype", default="native",
                    choices=["native", "bfloat16", "float32"],
                    help="gradient dtype for the robust aggregation")
    ap.add_argument("--distance-backend", default="auto",
                    choices=["auto", "xla", "pallas", "fused"],
                    help="pairwise-distance implementation (pallas = K1 "
                         "per local slice; fused = the fused composites, "
                         "pallas under a model axis; auto = xla on a "
                         "meta trace)")
    ap.add_argument("--rep-lr", type=float, default=None,
                    help="reputation EMA rate for --gar reputation-<base>")
    ap.add_argument("--async-tau", type=int, default=None,
                    help="trace the asynchronous bounded-staleness train "
                         "step (train shapes only)")
    ap.add_argument("--async-schedule", default="fixed",
                    choices=["fixed", "random"])
    ap.add_argument("--expert-gather", action="store_true",
                    help="accepted and recorded under no_effect: the "
                         "port's MoE has no expert-weight gather")
    ap.add_argument("--legacy-sharding", action="store_true",
                    help="pre-iteration param sharding rules (A/B baseline)")
    ap.add_argument("--logits-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--serve-gar", default=None,
                    help="robust ensemble decode with this GAR (decode "
                         "shapes only)")
    ap.add_argument("--serve-f", type=int, default=2)
    ap.add_argument("--serve-speculative-k", type=int, default=0)
    ap.add_argument("--serve-replicas", type=int, default=0,
                    help="ensemble size (0 = the rule's minimal quorum)")
    ap.add_argument("--attn-shard", default=None,
                    choices=[None, "none", "batch"],
                    help="recorded under no_effect: no GSPMD constraint "
                         "to pin in the port")
    ap.add_argument("--unroll", action="store_true",
                    help="recorded under no_effect: the port loops over "
                         "periods, there is no scan to unroll")
    ap.add_argument("--telemetry", action="store_true",
                    help="aggregate through the obs-* composite")
    ap.add_argument("--out", default=None, help="JSON artifact path")
    args = ap.parse_args(argv)
    rec = run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                  gar=args.gar, attack=args.attack, reduced=args.reduced,
                  impl=args.impl, moe_impl=args.moe_impl,
                  param_dtype=args.param_dtype, agg_dtype=args.agg_dtype,
                  distance_backend=args.distance_backend,
                  rep_lr=args.rep_lr, async_tau=args.async_tau,
                  async_schedule=args.async_schedule, unroll=args.unroll,
                  attn_shard=args.attn_shard,
                  logits_dtype=args.logits_dtype,
                  serve_gar=args.serve_gar, serve_f=args.serve_f,
                  serve_replicas=args.serve_replicas,
                  serve_speculative_k=args.serve_speculative_k,
                  telemetry=args.telemetry,
                  expert_gather=args.expert_gather,
                  legacy_sharding=args.legacy_sharding, out_path=args.out)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
