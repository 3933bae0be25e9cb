"""One run of one cell: ``python3 bench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``.

The cell names a configuration and a traffic mix in ``BENCHMARK.json``;
each is found by name: ``bench/configs/<config>.json`` (its sizes) with
``bench/configs/<config>.py`` (its weights' draw, its plain reference and
its work formulas), ``bench/traffic/<traffic>.json`` (whose ``kind``
names the driver, ``bench/kinds/<kind>.py``), ``bench/limits/<cell>.json``
(the limits of the numbers its check compares) and, for each per-layer
metric, ``bench/metrics/<metric>.py``.  A new cell, configuration, mix
or metric is new files and entries; nothing here needs an edit.

The last line of standard output is the result's JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error and the last key of the result.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
#: modules whose presence after the window refuses the run (top-level
#: names, compared whole: the port's own name begins with the JAX
#: package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_module(path: pathlib.Path, name: str):
    """Import the file at ``path`` under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> Dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_of(man: Dict, workload: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in man['workloads']]}")


def metrics_of(man: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


class Cell:
    """What one cell's files say: ``config`` (the sizes), ``model`` (the
    configuration's module), ``traffic`` (the mix), ``kind`` (its
    driver), ``limits`` and the run's arguments."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda"):
        self.man = manifest()
        self.cell = cell_of(self.man, workload)
        self.name, self.seed, self.seconds = workload, seed, seconds
        self.trace, self.device = trace, device
        cname, tname = self.cell["config"], self.cell["traffic"]
        with open(BENCH / "configs" / f"{cname}.json") as fh:
            self.config = json.load(fh)
        self.model = load_module(BENCH / "configs" / f"{cname}.py",
                                 f"bench_config_{_ident(cname)}")
        with open(BENCH / "traffic" / f"{tname}.json") as fh:
            self.traffic = json.load(fh)
        kind = self.traffic["kind"]
        self.kind = load_module(BENCH / "kinds" / f"{kind}.py",
                                f"bench_kind_{_ident(kind)}")
        path = BENCH / "limits" / f"{workload}.json"
        self.limits = json.loads(path.read_text()) if path.exists() else {}


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def read_metric(name: str, measured: Dict) -> Optional[float]:
    """The per-layer metric's reader, ``bench/metrics/<name>.py``:
    ``read(measured)`` gives a number or ``None`` (nothing to read)."""
    mod = load_module(BENCH / "metrics" / f"{name}.py",
                      f"bench_metric_{_ident(name)}")
    return mod.read(measured)


def check(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [(name, value, limit)])`` over the numbers the cell's
    limits name: correct when each is finite and at most its limit (a
    number the run did not give fails, and so does a cell without
    limits)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        ok = ok and math.isfinite(value) and value <= limit
        rows.append((name, value, limit))
    return ok and bool(rows), rows


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
        return out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, t_start: float, device: str = "cuda",
        need_chip: bool = True) -> int:
    """One run; returns the exit code.  ``need_chip=False`` (the tests)
    skips the look for a card and runs on ``device``."""
    args = parse(argv)
    import torch
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace),
                device)
    chips = int(cell.cell.get("chips", 1))
    if need_chip and (not torch.cuda.is_available()
                      or torch.cuda.device_count() < chips):
        print(f"bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if need_chip:
        torch.set_num_threads(2)
    out = cell.kind.run(cell, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 3
    correct, rows = check(out["numbers"], cell.limits)
    metrics = {}
    for m in metrics_of(cell.man, cell.name, cell.trace):
        value = (read_metric(m["name"], out["measured"]) if cell.trace
                 else out["end_to_end"].get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if cell.trace:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
        result["breakdown"] = out["breakdown"]
    result["power"] = out.get("power", "unknown")
    result["setup_parts"] = out.get("setup_parts", {})
    result["reference_s"] = out.get("reference_s")
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
