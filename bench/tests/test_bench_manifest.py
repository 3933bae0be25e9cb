"""``BENCHMARK.json`` against the contract's form, and the harness's
finding of every cell's files by name."""
from __future__ import annotations

import json
import math
import re

import pytest

from conftest import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WIDTH = re.compile(r"(_dim|_rank)$|^(hidden|intermediate|head)_size$|latent|"
                   r"state|proj|headdim|expand|experts_per_tok|^d_")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_form():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert all(_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               and not p.endswith("_torch") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_and_units():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics_form():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        got = [m for m in MAN["end_to_end"] if w in m.get("workloads", [w])]
        assert len(got) >= 2 and any(m["name"] == "setup_s" for m in got)
        assert any(w in m["workloads"] for m in MAN["per_layer"])


def test_every_cell_finds_its_files():
    used = set()
    for w in MAN["workloads"]:
        cfg = ROOT / "bench" / "configs"
        assert (cfg / f"{w['config']}.json").exists()
        assert (cfg / f"{w['config']}.py").exists()
        tr = json.loads((ROOT / "bench" / "traffic"
                         / f"{w['traffic']}.json").read_text())
        assert (ROOT / "bench" / "kinds" / f"{tr['kind']}.py").exists()
        limits = json.loads((ROOT / "bench" / "limits"
                             / f"{w['name']}.json").read_text())
        assert limits and all(math.isfinite(v) for v in limits.values())
        used.add(w["config"])
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"] == f"bench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert set(data["reduced"]) == set(data["published"])
        assert "assumed" in data and "deployment" in data
    for m in MAN["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()


def test_four_chip_cells_at_most_a_quarter():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)


def test_a_cell_added_as_new_files_is_picked_up(tiny, capsys):
    """A new configuration, mix, limits and per-layer metric, each a new
    file, and a new manifest entry: the harness runs the cell and reports
    the new metric, with no file that was there edited."""
    tiny.add_traffic("tiny-train-short", "train-n7-1x1024",
                     {"seq": 8, "per_worker": 1, "worker_chunk": 7,
                      "batches": 4, "trace_steps": 1})
    (tiny.root / "bench" / "metrics" / "dummy_steps.train.py").write_text(
        "def read(m):\n    return float(m['steps'])\n")
    tiny.add_cell("tiny-dense.dummy", "tiny-dense", "tiny-train-short",
                  limits={"loss": 1.0, "grad1": 1.0, "change": 1.0})
    for m in tiny.man["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-dense.dummy")
    tiny.man["per_layer"].append(
        {"name": "dummy_steps.train", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "train step",
         "moves": "train_tokens_per_s", "workloads": ["tiny-dense.dummy"]})
    rc, res = tiny.run("tiny-dense.dummy", capsys, trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["dummy_steps.train"]["value"] >= 2
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}


def test_missing_program_fails_without_a_result(tmp_path):
    """A checkout that holds only the manifest and ``bench/`` exits
    non-zero and prints no result."""
    import shutil
    import subprocess
    import sys
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    w = MAN["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", w,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_metric_readers_return_nothing_on_nothing(name):
    from bench import harness
    assert harness.read_metric(name, {}) is None
