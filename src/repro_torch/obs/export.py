"""JSONL / CSV exporters for drained telemetry and metric histories
(counterpart of ``repro/obs/export.py``).

Thin, dependency-free writers shared by the trainers' ``telemetry()``
drains and ``scripts/torch_obs_report.py``.  Tensors, numpy scalars and
arrays become plain Python (lists) before serialization, so every
artifact is readable without numpy or torch.
"""
from __future__ import annotations

import csv
import json
from typing import Any, Dict, Iterable, List, Sequence

import numpy as np
import torch

__all__ = ["read_jsonl", "to_jsonable", "write_csv", "write_jsonl"]


def to_jsonable(obj: Any) -> Any:
    """Recursively convert tensor / numpy containers to JSON-native types.

    Args:
      obj: any nesting of dict/list/tuple over scalars, numpy scalars
        and arrays, and ``torch.Tensor`` (on any device: copied to the
        host, then through numpy).

    Returns:
      The same structure with arrays as lists and numpy scalars as
      python ints/floats/bools.
    """
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.generic,)):
        return obj.item()
    if hasattr(obj, "__array__") and not isinstance(obj, (str, bytes)):
        return np.asarray(obj).tolist()
    return obj


def write_jsonl(path, rows: Iterable[Dict[str, Any]]) -> int:
    """Write rows as one JSON object per line.

    Args:
      path: destination file path (overwritten).
      rows: iterable of dict rows (tensor / numpy content allowed).

    Returns:
      Number of rows written.
    """
    count = 0
    with open(path, "w") as fh:
        for row in rows:
            fh.write(json.dumps(to_jsonable(row)) + "\n")
            count += 1
    return count


def read_jsonl(path) -> List[Dict[str, Any]]:
    """Read back a JSONL file written by :func:`write_jsonl`.

    Args:
      path: source file path.

    Returns:
      List of dict rows (blank lines skipped).
    """
    rows: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def write_csv(path, rows: Sequence[Dict[str, Any]],
              fieldnames: "Sequence[str] | None" = None) -> int:
    """Write dict rows as CSV with a header line.

    Args:
      path: destination file path (overwritten).
      rows: dict rows; nested values are JSON-encoded into their cell.
      fieldnames: explicit column order (default: keys of the first
        row, in insertion order; extra keys in later rows error).

    Returns:
      Number of data rows written.
    """
    rows = list(rows)
    if fieldnames is None:
        fieldnames = list(rows[0].keys()) if rows else []
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(fieldnames))
        writer.writeheader()
        for row in rows:
            flat = {}
            for k in fieldnames:
                v = to_jsonable(row.get(k))
                flat[k] = (json.dumps(v)
                           if isinstance(v, (dict, list)) else v)
            writer.writerow(flat)
    return len(rows)
