"""Shared set-up of the benchmark's CPU tests: a checkout in a temporary
folder holding a copy of ``bench/`` and tiny cells of the real
configurations' families, run through the harness on the CPU.

Run from the repository root: ``python -m pytest -q bench/tests``.
"""
from __future__ import annotations

import copy
import json
import pathlib
import shutil
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: the tiny dense twin keeps RoPE base 1e4: over its 16-position
#: sequences the published 5e6 barely turns most of a head's 16
#: dimensions, so most of the key bias's coordinates (shift-invariant
#: under softmax where unrotated) get gradients nought to rounding, which
#: AdamW then scales into full steps of either sign
TINY_DENSE = {"hidden_size": 64, "intermediate_size": 96,
              "num_attention_heads": 4, "num_key_value_heads": 4,
              "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 97,
              "rope_theta": 10000.0}
TINY_DENSE_PORT = {"n_layers": 2, "d_model": 64, "n_heads": 4,
                   "n_kv_heads": 4, "d_ff": 96, "vocab_size": 97,
                   "head_dim": 16, "rope_theta": 10000.0}
TINY_MAMBA = {"d_model": 32, "n_layer": 2, "vocab_size": 61, "d_state": 8,
              "headdim": 8}
TINY_MAMBA_PORT = {"n_layers": 2, "d_model": 32, "vocab_size": 61,
                   "ssm_state": 8, "ssm_head_dim": 8}
TINY_TRAIN = {"seq": 16, "per_worker": 2, "worker_chunk": 3, "batches": 4,
              "trace_steps": 1}
TINY_CHAT = {"clients": 4, "slots": 4, "cache_len": 64,
             "prompt": {"median": 8, "sigma": 0.8, "min": 4, "max": 24},
             "output": {"median": 6, "sigma": 0.8, "min": 3, "max": 16},
             "pool": 64, "warmup_steps": 5, "trace_steps": 3,
             "check_requests": 3, "readings_seconds": 1,
             # at a width of 64 a replica's distances are noisy enough that
             # jitters 1.25 times apart can trade places in Krum's picks
             "jitters": [0.001, 0.002, 0.004, 0.008, 0.016, 0.032]}
#: the tiny cells' limits, set as the real cells' are: above what sound
#: runs read on the CPU (loss < 1e-7, grad1 < 1e-7, change < 7e-5 on
#: seeds 5-7) and below the emulated-TF32 control (loss > 3e-6, grad1 >
#: 8e-4) and the faults
TINY_TRAIN_LIMITS = {"loss": 1e-6, "grad1": 1e-5, "change": 3e-4}
TINY_SERVE_LIMITS = {"gap": 1e-5}


def _load(path: pathlib.Path):
    return json.loads(path.read_text())


class Checkout:
    """A temporary checkout: ``bench/`` copied, tiny cells added as new
    files, the harness pointed at it."""

    def __init__(self, root: pathlib.Path, monkeypatch):
        self.root = root
        shutil.copytree(ROOT / "bench", root / "bench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        self.man = copy.deepcopy(_load(ROOT / "BENCHMARK.json"))
        from bench import harness
        monkeypatch.setattr(harness, "ROOT", root)
        monkeypatch.setattr(harness, "BENCH", root / "bench")
        self.harness = harness

    def add_config(self, name: str, base: str, sizes: dict, port: dict):
        cfg = _load(ROOT / "bench" / "configs" / f"{base}.json")
        cfg.update(sizes, name=name)
        cfg["port"].update(port)
        d = self.root / "bench" / "configs"
        (d / f"{name}.json").write_text(json.dumps(cfg))
        shutil.copy(ROOT / "bench" / "configs" / f"{base}.py",
                    d / f"{name}.py")

    def add_traffic(self, name: str, base: str, changes: dict):
        tr = _load(ROOT / "bench" / "traffic" / f"{base}.json")
        tr.update(changes)
        (self.root / "bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(tr))

    def add_cell(self, name: str, config: str, traffic: str,
                 limits_of: str = None, limits: dict = None):
        """A cell as new files and entries; it reports every metric its
        twin ``limits_of`` reports, and takes its limits."""
        self.man["workloads"].append(
            {"name": name, "config": config, "traffic": traffic,
             "chips": 1, "why": "a tiny cell for the CPU tests"})
        if limits_of is not None:
            for m in self.man["end_to_end"] + self.man["per_layer"]:
                if limits_of in m.get("workloads", [limits_of]):
                    if "workloads" in m:
                        m["workloads"].append(name)
            if limits is None:
                limits = _load(ROOT / "bench" / "limits"
                               / f"{limits_of}.json")
        if limits is not None:
            (self.root / "bench" / "limits" / f"{name}.json").write_text(
                json.dumps(limits))

    def write(self):
        (self.root / "BENCHMARK.json").write_text(json.dumps(self.man))

    def run(self, workload: str, capsys, trace: int = 0, seed: int = 2 ** 31 + 5,
            seconds: float = 1.0):
        """One run on the CPU: ``(exit code, result or None)``."""
        self.write()
        rc = self.harness.run(
            ["--workload", workload, "--seed", str(seed), "--seconds",
             str(seconds), "--trace", str(trace)], time.perf_counter(),
            device="cpu", need_chip=False)
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


def tiny_checkout(tmp_path, monkeypatch) -> Checkout:
    """The tiny twins of the real cells, named ``tiny.<cell>``."""
    import torch
    torch.set_num_threads(2)
    co = Checkout(tmp_path, monkeypatch)
    co.add_config("tiny-dense", "qwen1.5-4b-l4", TINY_DENSE, TINY_DENSE_PORT)
    co.add_config("tiny-mamba", "mamba2-130m", TINY_MAMBA, TINY_MAMBA_PORT)
    co.add_traffic("tiny-train", "train-n7-1x1024", TINY_TRAIN)
    co.add_traffic("tiny-chat", "azure-conv-closed-12", TINY_CHAT)
    for w in co.man["workloads"][:]:
        cfg = "tiny-mamba" if w["config"].startswith("mamba") else "tiny-dense"
        kind = _load(ROOT / "bench" / "traffic" / f"{w['traffic']}.json")
        traffic = "tiny-chat" if kind["kind"] == "serve" else "tiny-train"
        co.add_cell(f"tiny.{w['name']}", cfg, traffic, limits_of=w["name"],
                    limits=(TINY_SERVE_LIMITS if traffic == "tiny-chat"
                            else TINY_TRAIN_LIMITS))
    # no cell of the manifest runs the mamba2-130m files now (PERF.md,
    # Open questions); their tiny twin keeps them tested
    co.add_cell("tiny.mamba2-130m.train-long", "tiny-mamba", "tiny-train",
                limits_of="qwen1.5-4b-l4.train-long",
                limits=TINY_TRAIN_LIMITS)
    co.write()
    return co


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    return tiny_checkout(tmp_path, monkeypatch)
