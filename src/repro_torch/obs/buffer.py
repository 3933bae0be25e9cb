"""The metrics ring of aggregation forensics (counterpart of
``repro/obs/buffer.py``).

The telemetry layer (``obs-<base>`` rules, see
``repro_torch.obs.forensics``) records one :class:`AggDiagnostics` row
per aggregation call into a fixed-size :class:`MetricsBuffer` ring that
is carried in ``AggState.obs`` from step to step.  Every leaf is a
tensor on the stack's device, and a push writes its row by tensor
indexing at ``cursor % capacity`` with a 0-d device cursor, so recording
never waits for the device.  The host reads the ring between steps (or
at the end of a run) with :func:`drain`.

Every field is fp32 (int32 for the cursor), so the ring never perturbs
the wrapped rule's numerics: the wrapper only *reads* the rule's
outputs.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "AggDiagnostics",
    "DEFAULT_OBS_CAPACITY",
    "MetricsBuffer",
    "drain",
    "init_metrics_buffer",
    "push_record",
]

DEFAULT_OBS_CAPACITY = 64
"""Ring rows allocated when an ``obs-<base>`` rule does not override
``AggregatorRule.obs_capacity``.  64 rows x a handful of (n,) fp32
vectors is a few KiB, negligible beside the gradient stack."""


class AggDiagnostics(NamedTuple):
    """One forensics row emitted per aggregation call.

    Per-worker vectors are fp32 ``(n,)`` (the worker axis of the stack
    that was aggregated); scalars are fp32 ``()``.

    Fields:
      step: aggregation step counter at record time.
      selected: per-worker selection mask / weight as reported by the
        wrapped rule (``res.selected``), as fp32.
      scores: per-worker rule scores (``res.scores``).
      dist_to_agg: per-worker L2 distance from each submitted gradient
        to the emitted aggregate (the suspicion primitive).
      trimmed_frac: fraction of coordinates where the worker falls
        outside the per-coordinate ``f``-trimmed range.
      reputation: per-worker reputation snapshot after the call (ones
        when the wrapped rule carries no reputation state).
      staleness: per-worker staleness ``step - version`` read from the
        gradient bus (zeros on synchronous paths).
      agg_dev: L2 distance between the aggregate and the plain mean of
        the stack (the leeway proxy's numerator).
      spread: mean of ``dist_to_agg`` (the proxy's denominator).
    """

    step: torch.Tensor
    selected: torch.Tensor
    scores: torch.Tensor
    dist_to_agg: torch.Tensor
    trimmed_frac: torch.Tensor
    reputation: torch.Tensor
    staleness: torch.Tensor
    agg_dev: torch.Tensor
    spread: torch.Tensor


class MetricsBuffer(NamedTuple):
    """Fixed-size ring of :class:`AggDiagnostics` rows.

    Fields:
      cursor: int32 ``()`` device tensor, the total records pushed since
        init (not wrapped: ``cursor % capacity`` is the next write slot,
        so the host can tell how many rows are valid and whether any
        were overwritten).
      records: an :class:`AggDiagnostics` whose every leaf carries a
        leading ``(capacity,)`` axis, the ring storage.
      sel_total: fp32 ``(n,)``, the cumulative per-worker selection
        weight over *all* pushes, so selection frequency survives ring
        wraparound.
    """

    cursor: torch.Tensor
    records: AggDiagnostics
    sel_total: torch.Tensor

    @property
    def capacity(self) -> int:
        """Ring size (the leading axis of every record leaf)."""
        return int(self.records.step.shape[0])


def init_metrics_buffer(capacity: int, n: int,
                        device="cuda") -> MetricsBuffer:
    """Allocate an empty ring for ``n``-worker diagnostics.

    Args:
      capacity: number of ring rows (see ``DEFAULT_OBS_CAPACITY``).
      n: worker-axis length of the stacks this buffer will observe.
      device: where the ring lives (``"cuda"`` raises when no card is
        present; pass the stack's device).

    Returns:
      A zero-initialised :class:`MetricsBuffer` with ``cursor == 0``.
    """
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    vec, scalar = zeros(capacity, n), zeros(capacity)
    records = AggDiagnostics(
        step=scalar, selected=vec, scores=vec, dist_to_agg=vec,
        trimmed_frac=vec, reputation=vec, staleness=vec,
        agg_dev=scalar, spread=scalar)
    return MetricsBuffer(
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        records=records, sel_total=zeros(n))


def push_record(buf: MetricsBuffer, rec: AggDiagnostics) -> MetricsBuffer:
    """Append one diagnostics row, overwriting the oldest on overflow.

    Pure (the input ring is not modified) and free of host syncs: the
    write slot ``cursor % capacity`` stays a device tensor and the row
    lands through ``index_copy``.

    Args:
      buf: ring to append to.
      rec: row to write; every leaf a tensor on the ring's device whose
        shape matches the per-row shape of ``buf.records`` (fp32
        ``(n,)`` vectors / ``()`` scalars).

    Returns:
      The updated :class:`MetricsBuffer`.
    """
    idx = torch.remainder(buf.cursor, buf.capacity).reshape(1).long()
    records = AggDiagnostics(*(
        store.index_copy(0, idx, row.to(store.dtype).reshape(
            (1,) + tuple(store.shape[1:])))
        for store, row in zip(buf.records, rec)))
    return MetricsBuffer(cursor=buf.cursor + 1, records=records,
                         sel_total=buf.sel_total
                         + rec.selected.to(torch.float32))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def drain(buf: Any) -> Dict[str, Any]:
    """Read a :class:`MetricsBuffer` out to host numpy, oldest first.

    Host-side: call it between steps.

    Args:
      buf: a :class:`MetricsBuffer`, or the empty ``()`` that an
        uninstrumented ``AggState.obs`` carries.

    Returns:
      A dict with ``"pushed"`` (total rows ever written), ``"records"``
      (list of per-row dicts of numpy values in chronological order, at
      most ``capacity`` long), and ``"selection_frequency"`` (``(n,)``
      numpy array of per-worker selection shares over the whole run;
      empty when nothing was recorded).  For ``buf=()`` all fields are
      empty / zero.
    """
    if buf is None or (isinstance(buf, tuple) and not
                       isinstance(buf, MetricsBuffer) and len(buf) == 0):
        return {"pushed": 0, "records": [],
                "selection_frequency": np.zeros((0,), np.float32)}
    cursor = int(_host(buf.cursor))
    records = AggDiagnostics(*(_host(leaf) for leaf in buf.records))
    cap = int(records.step.shape[0])
    valid = min(cursor, cap)
    # chronological order: on wraparound the oldest row sits at
    # cursor % cap, otherwise rows 0..valid-1 are already ordered
    if cursor > cap:
        order = (np.arange(cap) + cursor % cap) % cap
    else:
        order = np.arange(valid)
    rows = []
    for i in order[:valid]:
        rows.append({f: np.asarray(getattr(records, f)[i])
                     for f in AggDiagnostics._fields})
    sel_total = np.asarray(_host(buf.sel_total), np.float32)
    total = float(sel_total.sum())
    freq = sel_total / total if total > 0 else np.zeros_like(sel_total)
    return {"pushed": cursor, "records": rows,
            "selection_frequency": freq}
