"""Render the dry-run artifact directory as tables (counterpart of
``repro/launch/summarize.py``, whose code this is: the port's artifacts
keep the reference's keys, so they render in the same tables; "compile
s" is the trace's seconds and the roofline is the H100's, see
``repro_torch.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.summarize [--dir artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(art_dir: str) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(p) as fh:
            recs.append(json.load(fh))
    return recs


def _gb(x) -> str:
    return f"{x / 2**30:.2f}"


def dryrun_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | compile s | HLO flops/chip | bytes/chip"
            " | temp GiB/chip | AG GiB | AR GiB | PERM GiB | A2A GiB |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("skipped") or "error" in r:
            continue
        c = r["collectives"]
        mem = r.get("memory_analysis", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r.get('compile_s', '?')} "
            f"| {r['cost_analysis'].get('flops', 0):.3g} "
            f"| {r['cost_analysis'].get('bytes accessed', 0):.3g} "
            f"| {_gb(mem.get('temp_size_in_bytes', 0))} "
            f"| {_gb(c['all-gather']['bytes'])} "
            f"| {_gb(c['all-reduce']['bytes'])} "
            f"| {_gb(c['collective-permute']['bytes'])} "
            f"| {_gb(c['all-to-all']['bytes'])} |")
    return "\n".join(rows)


def roofline_table(recs: List[Dict], pod: str = "16x16") -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | useful flops ratio | note |",
            "|---|---|---|---|---|---|---|---|"]
    seen_skips = set()
    for r in recs:
        if r.get("skipped"):
            key = (r["arch"], r["shape"])
            if key in seen_skips:
                continue
            seen_skips.add(key)
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                        f"| skipped: sub-quadratic n/a |")
            continue
        if "error" in r or r.get("mesh") != pod:
            continue
        ro = r["roofline"]
        ur = ro.get("useful_flops_ratio")
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {ro['compute_s']:.4f} | {ro['memory_s']:.4f} "
            f"| {ro['collective_s']:.4f} "
            f"| **{ro['dominant'].replace('_s', '')}** "
            f"| {ur:.3f} | |" if ur else
            f"| {r['arch']} | {r['shape']} "
            f"| {ro['compute_s']:.4f} | {ro['memory_s']:.4f} "
            f"| {ro['collective_s']:.4f} "
            f"| **{ro['dominant'].replace('_s', '')}** | n/a | |")
    return "\n".join(rows)


def interesting(recs: List[Dict]) -> str:
    """Rank candidates for the perf hillclimb."""
    out = []
    for r in recs:
        if r.get("skipped") or "error" in r or r.get("mesh") != "16x16":
            continue
        ro = r["roofline"]
        tot = ro["compute_s"] + ro["memory_s"] + ro["collective_s"]
        out.append((r["arch"], r["shape"], ro["dominant"],
                    ro["compute_s"] / max(tot, 1e-12),
                    ro.get("useful_flops_ratio") or 0.0, tot))
    out.sort(key=lambda t: t[3])  # worst compute fraction first
    lines = ["arch shape dominant compute_frac useful_ratio total_s"]
    for t in out:
        lines.append(f"{t[0]:24s} {t[1]:12s} {t[2]:13s} {t[3]:.3f} "
                     f"{t[4]:.3f} {t[5]:.3f}")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--mode", default="all",
                    choices=["all", "dryrun", "roofline", "interesting"])
    args = ap.parse_args()
    recs = load(args.dir)
    if args.mode in ("all", "dryrun"):
        print("## Dry-run table\n")
        print(dryrun_table(recs))
    if args.mode in ("all", "roofline"):
        print("\n## Roofline (single-pod 16x16)\n")
        print(roofline_table(recs))
    if args.mode in ("all", "interesting"):
        print("\n## Hillclimb candidates (sorted by compute fraction)\n")
        print(interesting(recs))


if __name__ == "__main__":
    main()
