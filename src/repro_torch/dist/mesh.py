"""Device meshes over ``torch.distributed`` ranks (counterpart of
``repro/dist/mesh.py``), and a launcher that runs one function on every
rank of a mesh.

The reference builds one ``jax.sharding.Mesh`` and lets GSPMD partition
a single program over it.  The port is explicit SPMD: one process per
mesh position, each holding a :class:`Mesh`, this rank's view of the
grid (axis names, shape, this rank's coordinates, one process group per
axis) with the collectives the sharded runtime needs.  Axis convention
(the reference's):

  data   Byzantine workers: each data slice computes its workers'
         gradients; robust aggregation reduces over this axis
  model  the coordinates of every gradient and parameter leaf
  pod    optional outermost axis (3-d meshes); the port's ranks along
         it compute the same thing (the reference splits each worker's
         batch over it)

The backend is explicit.  ``gloo`` carries CPU tensors, and CUDA tensors
by staging them through host memory (the only way several ranks can
share one card); ``nccl`` needs one card per rank.  :func:`run_on_mesh`
spawns the ranks, meets them over a ``FileStore`` in a temporary
directory and re-raises the first rank's failure in the caller.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import pathlib
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["COMM_KINDS", "Mesh", "comm_since", "comm_snapshot",
           "make_host_mesh", "make_production_mesh", "mesh_axis_sizes",
           "run_on_mesh"]

_DEFAULT_NAMES = ("data", "model")


def _device_for(device, rank: int) -> torch.device:
    """The card (or the CPU) a rank computes on: ranks take the cards in
    turn, so several ranks share a card when there are fewer cards.
    Raises as ``resolve_device`` does for a card that is not there."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _resolve_backend(backend: Optional[str], device, world: int) -> str:
    """The process-group backend: ``gloo`` for CPU tensors, ``nccl`` for
    CUDA tensors when every rank has its own card.  Ranks that share a
    card must ask for ``gloo`` themselves; nothing switches silently."""
    dev = torch.device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend carries CUDA tensors only; "
                             "use backend='gloo' on the CPU")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards:
            raise ValueError(
                f"{world} ranks on {cards} card(s): nccl needs one card per "
                f"rank; pass backend='gloo' to share a card")
    return backend


class Mesh:
    """One rank's view of a device mesh.

    Attributes:
      axis_names: one name per mesh dimension.
      shape: the grid's shape.
      devices: the grid of ranks, ``np.arange(world).reshape(shape)``
        (``mesh_axis_sizes`` reads its ``shape``, as the reference reads
        a ``jax.sharding.Mesh``'s device grid).
      rank: this process's rank (0 in a single-process mesh).
      coords: ``{axis name: this rank's index along it}``.
      device: where this rank's tensors live.
      backend: ``"gloo"`` or ``"nccl"``.
      comm: ``{"calls", "seconds", "bytes", "by_kind"}`` accumulated
        over this rank's collectives: their count, their host-clock time
        (a CUDA tensor's collective waits for the stream first, so its
        time is the collective's own), the bytes of their results (none
        on a rank that a ``gather`` leaves without one) and, per kind
        (``"all_reduce"``, ``"all_gather"``, ``"gather"``,
        ``"broadcast"``), ``{"calls", "bytes"}``: the yardstick the
        launch harness's predictions are held to
        (``repro_torch.launch.dryrun.RecordingMesh`` counts the same).
    """

    def __init__(self, shape: Tuple[int, ...], axis_names: Sequence[str],
                 rank: int, device, backend: str, groups=None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.devices = np.arange(math.prod(self.shape)).reshape(self.shape)
        self.rank = int(rank)
        self.coords = {name: int(i) for name, i in zip(
            self.axis_names, np.unravel_index(self.rank, self.shape))}
        self.device = torch.device(device)
        self.backend = backend
        self._groups = groups or {}
        self.comm = _zero_comm()

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"rank={self.rank}, device={self.device}, "
                f"backend={self.backend!r})")

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh does not have)."""
        return mesh_axis_sizes(self).get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        return self.coords.get(axis, 0)

    def reset_comm(self) -> None:
        """Zero the collective counters of :attr:`comm`."""
        self.comm = _zero_comm()

    def _count(self, kind: str, t0: float, nbytes: int) -> None:
        """Count one collective of ``kind`` whose result has ``nbytes``."""
        _count_comm(self.comm, kind, nbytes)
        self.comm["seconds"] += time.perf_counter() - t0

    # -- collectives over one axis ---------------------------------------

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer a collective runs on: a contiguous copy, in host
        memory when gloo carries a CUDA tensor (gloo has no path through
        a card shared by several ranks; the compute stays on the card)."""
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
            if self.backend == "gloo":
                return x.detach().to("cpu").contiguous()
        return x.detach().clone().contiguous()

    def _done(self, kind: str, t0: float, parts, like: torch.Tensor,
              dim: int = 0):
        """The result on ``like``'s device (staged parts concatenated
        there, not in host memory), with the call counted."""
        out = (parts[0].to(like.device) if len(parts) == 1 else
               torch.cat([p.to(like.device) for p in parts], dim=dim))
        if like.device.type == "cuda":
            torch.cuda.synchronize(like.device)
        self._count(kind, t0, out.numel() * out.element_size())
        return out

    def _rank_at(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` from this rank."""
        pos = [self.coords[a] for a in self.axis_names]
        pos[self.axis_names.index(axis)] = index
        return int(self.devices[tuple(pos)])

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over the ranks along ``axis``, the same on each.

        Args:
          x: a tensor of the same shape on every rank of the axis.
          axis: mesh axis name.

        Returns:
          A new tensor (``x`` itself when the axis has one rank).
        """
        if self.size(axis) == 1:
            return x
        t0 = time.perf_counter()
        buf = self._stage(x)
        dist.all_reduce(buf, group=self._groups[axis])
        return self._done("all_reduce", t0, [buf], x)

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """Concatenation along ``dim`` of ``x`` from every rank of
        ``axis``, in the axis' index order.

        Args:
          x: a tensor of the same shape on every rank of the axis.
          axis: mesh axis name.
          dim: the dimension to concatenate along.

        Returns:
          A new tensor (``x`` itself when the axis has one rank).
        """
        size = self.size(axis)
        if size == 1:
            return x
        t0 = time.perf_counter()
        buf = self._stage(x)
        parts = [torch.empty_like(buf) for _ in range(size)]
        dist.all_gather(parts, buf, group=self._groups[axis])
        return self._done("all_gather", t0, parts, x, dim)

    def gather(self, x: torch.Tensor, axis: str, dim: int = 0,
               dst: int = 0):
        """:meth:`all_gather`'s concatenation on the rank at index ``dst``
        along ``axis`` only (half the traffic of an all-gather).

        Args:
          x: a tensor of the same shape on every rank of the axis.
          axis: mesh axis name.
          dim: the dimension to concatenate along.
          dst: the receiving rank's index along ``axis``.

        Returns:
          The concatenation on that rank, ``None`` on the others (``x``
          itself when the axis has one rank).
        """
        size = self.size(axis)
        if size == 1:
            return x
        t0 = time.perf_counter()
        buf = self._stage(x)
        mine = self.index(axis) == dst
        parts = [torch.empty_like(buf) for _ in range(size)] if mine else None
        dist.gather(buf, gather_list=parts, dst=self._rank_at(axis, dst),
                    group=self._groups[axis])
        if not mine:
            self._count("gather", t0, 0)
            return None
        return self._done("gather", t0, parts, x, dim)

    def broadcast(self, x: torch.Tensor, axis: str,
                  src: int = 0) -> torch.Tensor:
        """``x`` of the rank at index ``src`` along ``axis``, on every
        rank of the axis.

        Args:
          x: a tensor of the same shape on every rank of the axis.
          axis: mesh axis name.
          src: the sending rank's index along ``axis``.

        Returns:
          A new tensor (``x`` itself when the axis has one rank).
        """
        if self.size(axis) == 1:
            return x
        t0 = time.perf_counter()
        buf = self._stage(x)
        dist.broadcast(buf, src=self._rank_at(axis, src),
                       group=self._groups[axis])
        return self._done("broadcast", t0, [buf], x)


#: the collectives a :class:`Mesh` runs, the keys of ``comm["by_kind"]``
COMM_KINDS = ("all_reduce", "all_gather", "gather", "broadcast")


def _zero_comm() -> Dict[str, Any]:
    return {"calls": 0, "seconds": 0.0, "bytes": 0,
            "by_kind": {k: {"calls": 0, "bytes": 0} for k in COMM_KINDS}}


def _count_comm(comm: Dict[str, Any], kind: str, nbytes: int) -> None:
    """Add one collective of ``kind`` with a result of ``nbytes`` to a
    ``comm`` record (totals and the kind's entry)."""
    comm["calls"] += 1
    comm["bytes"] += nbytes
    comm["by_kind"][kind]["calls"] += 1
    comm["by_kind"][kind]["bytes"] += nbytes


def comm_since(before: Dict[str, Any], after: Dict[str, Any]
               ) -> Dict[str, Dict[str, int]]:
    """``comm["by_kind"]`` of the collectives between two snapshots of a
    mesh's :attr:`Mesh.comm` (take them with :func:`comm_snapshot`).

    Returns:
      ``{kind: {"calls", "bytes"}}`` for every kind of
      :data:`COMM_KINDS`.
    """
    return {k: {f: after["by_kind"][k][f] - before["by_kind"][k][f]
                for f in ("calls", "bytes")} for k in COMM_KINDS}


def comm_snapshot(comm: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a ``comm`` record that later collectives leave as it
    is (its ``by_kind`` entries are copied too)."""
    out = dict(comm)
    out["by_kind"] = {k: dict(v) for k, v in comm["by_kind"].items()}
    return out


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None,
                   axis_names: Optional[Sequence[str]] = None, *,
                   device="cuda", backend: Optional[str] = None) -> Mesh:
    """This rank's view of a mesh over the ranks of the process group.

    Args:
      shape: grid shape, e.g. ``(4, 2)``; ``None`` puts every rank on
        the ``data`` axis with a trivial ``model`` axis.
      axis_names: one name per dimension; defaults to ``("data",
        "model")`` (2-d) or ``("pod", "data", "model")`` (3-d).
      device: ``"cuda"`` (the default: a rank takes card ``rank %
        cards``; raises without a card) or ``"cpu"``.
      backend: ``"gloo"`` or ``"nccl"``; ``None``: gloo for the CPU,
        nccl for CUDA (which needs one card per rank: ranks sharing a
        card must pass ``"gloo"``).  It must be the process group's.

    Returns:
      A :class:`Mesh` with one process group per axis (from
      ``init_device_mesh``).  Without an initialized process group the
      world is this one process, so only a one-position mesh builds.
      Raises ``ValueError`` with the reference's texts for a name count
      that differs from the shape's and for a shape larger than the
      world, and for a mesh smaller than the world.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world, 1)
    shape = tuple(shape)
    if axis_names is None:
        if len(shape) == 3:
            axis_names = ("pod",) + _DEFAULT_NAMES
        else:
            axis_names = _DEFAULT_NAMES[:len(shape)]
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(shape)}-d mesh needs {len(shape)} axis "
                         f"names, got {axis_names!r}")
    n = math.prod(shape)
    if n > world:
        raise ValueError(
            f"mesh shape {shape} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh shape {shape} covers {n} of {world} ranks; "
                         f"run one rank per mesh position")
    dev = _device_for(device, rank)
    backend = _resolve_backend(backend, dev, world)
    groups = {}
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}"
                             f", not {backend!r}")
        from torch.distributed.device_mesh import init_device_mesh
        # gloo's groups carry CPU buffers (CUDA tensors are staged), so
        # the device mesh is a CPU one; nccl's is a CUDA one
        dm = init_device_mesh("cpu" if backend == "gloo" else "cuda",
                              shape, mesh_dim_names=tuple(axis_names))
        groups = {name: dm.get_group(name) for name in axis_names}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(shape, axis_names, rank, dev, backend, groups)


def make_production_mesh(multi_pod: bool = False, *, device="cuda",
                         backend: Optional[str] = None) -> Mesh:
    """The reference's production meshes: ``(16, 16)`` ``("data",
    "model")`` over 256 ranks, or ``(2, 16, 16)`` ``("pod", "data",
    "model")`` over 512.  Raises the reference's ``ValueError`` ("needs
    256 devices") on a smaller world."""
    if multi_pod:
        return make_host_mesh((2, 16, 16), ("pod", "data", "model"),
                              device=device, backend=backend)
    return make_host_mesh((16, 16), ("data", "model"), device=device,
                          backend=backend)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh (a :class:`Mesh`, or anything with
    ``axis_names`` and a ``devices`` grid).

    Returns:
      ``{axis name: size}``, e.g. ``{"data": 16, "model": 16}``.
    """
    return dict(zip(mesh.axis_names, mesh.devices.shape))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, workdir: str, shape, device,
               backend: str, fn: Callable, args: tuple, timeout: float,
               num_threads: Optional[int]) -> None:
    """One spawned rank: join the group, build the mesh, run ``fn``,
    save its result (or the traceback) for the launcher."""
    out = pathlib.Path(workdir)
    code = 0
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        # every rank of a launched world is on this host: gloo's pairs
        # meet on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        store = dist.FileStore(str(out / "store"), world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        mesh = make_host_mesh(shape, device=device, backend=backend)
        result = fn(mesh, *args)
        torch.save(result, out / f"rank{rank}.pt")
    except Exception:  # the launcher re-raises it in the caller
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        code = 1
    finally:
        if dist.is_initialized() and code == 0:
            dist.destroy_process_group()
    # skip interpreter teardown: a failed rank's peers may still hold its
    # sockets, and the launcher reads only the files written above
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _stop(procs) -> None:
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.terminate()
    for p in started:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def run_on_mesh(fn: Callable, shape: Tuple[int, ...], *,
                args: tuple = (), device="cuda",
                backend: Optional[str] = None, timeout: float = 600.0,
                num_threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a fresh mesh.

    Args:
      fn: a function importable by name (the ranks are spawned, so they
        import it); ``args`` must pickle.  What it returns must go
        through ``torch.save`` (move CUDA tensors to the CPU first).
      shape: the mesh's shape (axis names as :func:`make_host_mesh`'s
        defaults); one process per position.
      args: extra positional arguments of ``fn``.
      device: ``"cuda"`` (the default; raises without a card) or
        ``"cpu"``.
      backend: as :func:`make_host_mesh` (ranks sharing a card: gloo).
      timeout: seconds for the whole run, and the process group's
        timeout.
      num_threads: ``torch.set_num_threads`` in every rank (``None``:
        torch's default).

    Returns:
      The ranks' results in rank order.  Raises ``RuntimeError`` with
      the failing rank's traceback as soon as any rank fails (the others
      are stopped), and ``TimeoutError`` past ``timeout``; every process
      it started has ended when it returns or raises.
    """
    world = math.prod(shape)
    device = resolve_device(device)
    backend = _resolve_backend(backend, device, world)
    workdir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, workdir, tuple(shape), device,
                               backend, fn, tuple(args), timeout,
                               num_threads))
             for r in range(world)]
    out = pathlib.Path(workdir)
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                _stop(procs)
                # a rank whose peer died fails too: every traceback
                # shows, and the first written names the failure
                texts, first = [], []
                for r, p in enumerate(procs):
                    err = out / f"rank{r}.err"
                    if err.exists():
                        first.append((err.stat().st_mtime_ns, r))
                        texts.append(f"rank {r}:\n{err.read_text()}")
                    elif r in failed:
                        texts.append(f"rank {r}: exit code {p.exitcode}, "
                                     f"no traceback")
                r = min(first)[1] if first else failed[0]
                raise RuntimeError(f"rank {r} of mesh {tuple(shape)} "
                                   f"failed:\n" + "\n".join(texts))
            if all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                _stop(procs)
                raise TimeoutError(f"mesh {tuple(shape)} ran past "
                                   f"{timeout} s")
            procs[0].join(0.02)
        return [torch.load(out / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        _stop(procs)
        shutil.rmtree(workdir, ignore_errors=True)
