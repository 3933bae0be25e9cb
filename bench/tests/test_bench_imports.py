"""Nothing the harness runs imports JAX, the JAX package or its
benchmarks (top-level module names compared whole: the port's name
begins with the JAX package's), and the references import nothing of
the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_file_of_the_harness_names_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path
        assert "repro_torch" not in path.read_text(), path


def test_a_run_loads_no_jax(tmp_path):
    """A tiny cell's whole run, window and reference, in a fresh process:
    the harness's own check finds no forbidden module, and neither does
    a look at ``sys.modules`` afterwards."""
    code = f"""
import sys, pathlib, tempfile
sys.path[:0] = [{str(ROOT / 'bench' / 'tests')!r}, {str(ROOT)!r},
                {str(ROOT / 'src')!r}]
from _pytest.monkeypatch import MonkeyPatch
import conftest
co = conftest.tiny_checkout(pathlib.Path({str(tmp_path)!r}), MonkeyPatch())
name = [w["name"] for w in co.man["workloads"] if w["name"].startswith("tiny.")][0]
import time
rc = co.harness.run(["--workload", name, "--seed", "9", "--seconds", "1",
                     "--trace", "0"], time.perf_counter(), device="cpu",
                    need_chip=False)
bad = {{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r})
print("RC", rc, "BAD", sorted(bad))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    last = [l for l in p.stdout.splitlines() if l.startswith("RC")]
    assert last and last[-1] == "RC 0 BAD []", (p.stdout[-2000:],
                                                p.stderr[-2000:])
