"""Port parity of the adversarial self-audit (``repro_torch.audit``)
against the JAX reference (``repro.audit``).

* every invariant checker gives the reference's violation strings on the
  same numpy inputs, and ``check_quorum_contract`` the reference's result
  over the whole audit roster, which equals the reference's;
* ``measure_leeway`` on the reference's own honest stacks: margins at
  1e-4 relative per d; gamma_m of Krum at 1e-5 relative and of GeoMed at
  1e-3 (see :meth:`TestLeeway.test_gamma_per_d`); ``certify`` and
  ``slope`` give the reference's results on one report;
* the port's tiny sweep (the reference's ``tests/test_audit.py`` grid)
  has no violation and the reference's case count per section, its
  ``speculative`` section included, and the CLI's quick sweep reports
  the reference's ``speculative`` count;
* the reference's injected-bug cases are caught;
* the CLIs and scripts run on the CPU and import no JAX.
"""
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.agg import registry as jreg  # noqa: E402
from repro.agg import state as jstate  # noqa: E402
from repro.audit import invariants as jinv  # noqa: E402
from repro.audit import leeway as jlee  # noqa: E402
from repro.audit import sweep as jsweep  # noqa: E402
from repro.core.types import AggResult as JaxResult  # noqa: E402
import repro.audit as jaudit  # noqa: E402
import repro_torch.audit as taudit  # noqa: E402
from repro_torch.agg import registry as treg  # noqa: E402
from repro_torch.agg import state as tstate  # noqa: E402
from repro_torch.agg.fused import FUSED_BASES  # noqa: E402
from repro_torch.audit import invariants as tinv  # noqa: E402
from repro_torch.audit import leeway as tlee  # noqa: E402
from repro_torch.audit import sweep as tsweep  # noqa: E402
from repro_torch.core.types import AggResult  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the reference's tiny grid (``tests/test_audit.py`` ``TINY``)
TINY = dict(d=8, fs=(1,), extra_n=(0,),
            attacks=("none", "omniscient_lp", "signflip", "stale_replay"),
            steps=2, taus=(0, 2), quorum_fs=(1, 2))
#: case counts per section of the reference's ``run_sweep`` on ``TINY``,
#: read off one run of ``repro.audit.sweep.run_sweep`` with JAX on the
#: CPU (1130 cases, no violation).  Pinned here so these tests do not
#: rerun the reference's sweep (~2 min, mostly compiling).
REFERENCE_TINY_SECTIONS = {"invariants": 372, "quorum": 220,
                           "arbitrary-f": 110, "identity": 60,
                           "staleness": 48, "fp32": 14, "speculative": 306}
#: the reference's ``speculative`` section on the quick grid (``QUICK``):
#: 408 cases, no violation, read off ``repro.audit.sweep.
#: _speculative_section(QUICK, ...)`` with JAX on the CPU
REFERENCE_QUICK_SPECULATIVE = (408, 0)
#: the reference's ``speculative`` violations on ``TINY`` with the
#: attacks ``("none", "zero")``, read off the same kind of run
REFERENCE_ZERO_SPECULATIVE = [
    f"speculative/{rule}/zero/colluding: colluding draft changed the "
    f"accepted stream [3, 3, 3, 0] vs aggregate argmax [0, 0, 0, 0]"
    for rule in ("fused-geomed", "fused-krum", "geomed", "krum")
    for _ in range(2)]
#: the leeway rules of these tests: the reference's defaults, their
#: fused forms and the weakened rule
LEEWAY_RULES = tuple(jlee.DEFAULT_RULES) + (("bulyan-weak", "bulyan-krum",
                                              0),)
FUSED_LEEWAY = tuple(f"fused-{r}" for r in jlee.DEFAULT_RULES
                     if r in FUSED_BASES)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _stack(n=5, d=4, seed=3):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the checkers
# ---------------------------------------------------------------------------

def _checker_cases():
    s = _stack(7, 6)
    s5 = _stack(5, 6, seed=4)
    med = np.median(s, axis=0)
    w = np.zeros(5, np.float32)
    w[0] = 1.0
    w2 = np.full(5, 0.4, np.float32)
    w2[0] = -0.6
    nan = s[0].copy()
    nan[2] = np.nan
    nan[4] = np.inf
    return {
        "finite_ok": ("check_finite", (s[0],), {"label": "a"}),
        "finite_nan": ("check_finite", (nan,), {"label": "a/b"}),
        "hull_in": ("check_hull", (s.mean(axis=0), s), {}),
        "hull_out": ("check_hull", (s.max(axis=0) + 1.0, s),
                     {"label": "x"}),
        "hull_low": ("check_hull", (s.min(axis=0) - 0.5, s), {}),
        "trimmed_in": ("check_trimmed", (med, s, 2), {}),
        "trimmed_out": ("check_trimmed", (s.max(axis=0), s, 2),
                        {"label": "t"}),
        "trimmed_small_n": ("check_trimmed", (med, s, 4), {"label": "q"}),
        "convex_ok": ("check_convex", (s5[0], w, s5), {}),
        "convex_lying": ("check_convex", (s5[1], w, s5), {"label": "l"}),
        "convex_sum": ("check_convex", (s5[0], 2.0 * w, s5), {}),
        "convex_negative": ("check_convex", (w2 @ s5, w2, s5),
                            {"label": "n"}),
    }


CHECKERS = _checker_cases()


class TestCheckers:
    @pytest.mark.parametrize("case", sorted(CHECKERS))
    def test_violation_texts(self, case):
        fn, args, kw = CHECKERS[case]
        want = getattr(jinv, fn)(*[jnp.asarray(a) if isinstance(
            a, np.ndarray) and a.ndim == 1 else a for a in args], **kw)
        got = getattr(tinv, fn)(*[torch.from_numpy(a) if isinstance(
            a, np.ndarray) and a.ndim == 1 else a for a in args], **kw)
        assert got == want
        assert getattr(tinv, fn)(*args, **kw) == want  # numpy inputs too

    @pytest.mark.parametrize("name", ["krum", "cwmed", "trimmed_mean",
                                      "bulyan-krum", "average",
                                      "centered_clip"])
    @pytest.mark.parametrize("shift", [0.0, 10.0])
    def test_rule_output_texts(self, name, shift):
        """``check_rule_output`` on each rule's own output, honest and
        shifted off the hull (the reference's ``lying-krum``)."""
        s = _stack(11, 6, seed=5)
        jres = jreg.resolve_rule(name).dense_fn(jnp.asarray(s), 2)
        want = jinv.check_rule_output(
            jreg.resolve_rule(name), jres.gradient + shift, jres.selected,
            s, 2, f"{name}/x")
        tres = treg.resolve_rule(name).dense_fn(torch.from_numpy(s), 2)
        got = tinv.check_rule_output(
            treg.resolve_rule(name), tres.gradient + shift, tres.selected,
            s, 2, f"{name}/x")
        assert got == want
        assert bool(got) == (shift > 0)

    @pytest.mark.parametrize("name", ["stale-krum", "stale-exp-cwmed",
                                      "reputation-krum",
                                      "reputation-stale-krum",
                                      "stale-reputation-krum",
                                      "buffered-cwmed", "obs-stale-krum"])
    def test_effective_stack(self, name):
        """The reweighted stack from the same pre-call state, and the
        window mean over a caller-tracked history."""
        n, d = 9, 6
        jr, tr = jreg.resolve_rule(name), treg.resolve_rule(name)
        js = jstate.init_state(jr, jnp.zeros((n, d), jnp.float32))
        ts = tstate.init_state(tr, torch.zeros((n, d)))
        versions = np.asarray([4, 3, 2, 1, 4, 3, 2, 1, 4], np.int32)
        if "bus" in jr.state_fields:
            js = js._replace(step=jnp.int32(4), bus=js.bus._replace(
                versions=jnp.asarray(versions)))
            ts = ts._replace(step=4, bus=ts.bus._replace(
                versions=torch.from_numpy(versions)))
        if "reputation" in jr.state_fields:
            rep = np.linspace(0.2, 1.0, n).astype(np.float32)
            js = js._replace(reputation=jnp.asarray(rep))
            ts = ts._replace(reputation=torch.from_numpy(rep))
        g = _stack(n, d, seed=6)
        hist = [_stack(n, d, seed=7), _stack(n, d, seed=8)]
        want = jinv.effective_stack(jr, jnp.asarray(g), js, history=hist)
        got = tinv.effective_stack(tr, torch.from_numpy(g), ts,
                                   history=hist)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tinv.prewindow_stack(tr, torch.from_numpy(g), ts),
            jinv.prewindow_stack(jr, jnp.asarray(g), js), rtol=1e-6,
            atol=1e-6)
        assert np.array_equal(tinv.effective_stack(tr, g, None),
                              jinv.effective_stack(jr, g, None))


class TestRosterAndQuorum:
    def test_roster_equals_reference(self):
        assert tsweep.audit_roster() == jsweep.audit_roster()
        for name in tsweep.audit_roster():
            assert treg.resolve_rule(name).dense_fn is not None, name

    @pytest.mark.parametrize("name", jsweep.audit_roster())
    def test_quorum_contract(self, name):
        for f in (1, 2, 3):
            assert tinv.check_quorum_contract(name, f) == \
                jinv.check_quorum_contract(name, f)

    def test_quorum_contract_error_paths(self):
        assert tinv.check_quorum_contract("buffered-cwmed", 1,
                                          history_window=2) == \
            jinv.check_quorum_contract("buffered-cwmed", 1,
                                       history_window=2)
        for mod in (tinv, jinv):
            with pytest.raises(KeyError, match="unknown GAR"):
                mod.check_quorum_contract("no-such-rule", 1)

    def test_package_exports(self):
        assert taudit.__all__ == jaudit.__all__
        for name in taudit.__all__:
            assert hasattr(taudit, name), name


# ---------------------------------------------------------------------------
# the leeway meter
# ---------------------------------------------------------------------------

def _reference_stack(d, n_h, seed, device):
    """The reference's honest stack of one rung, as ``measure_leeway``
    draws it."""
    key = jax.random.PRNGKey(seed)
    h = jax.random.normal(jax.random.fold_in(key, d), (n_h, d)) * 0.5 + 1.0
    return torch.from_numpy(np.array(h)).to(device)


@pytest.fixture(scope="module")
def leeway_pair():
    """(port, reference) reports over ``DEFAULT_DIMS`` on the
    reference's own honest stacks."""
    want = jlee.measure_leeway(rules=LEEWAY_RULES)
    patch = pytest.MonkeyPatch()
    patch.setattr(tlee, "_honest_stack", _reference_stack)
    try:
        got = tlee.measure_leeway(rules=LEEWAY_RULES + FUSED_LEEWAY,
                                  device="cpu")
    finally:
        patch.undo()
    return got, want


class TestLeeway:
    def test_constants(self):
        assert tlee.DEFAULT_DIMS == jlee.DEFAULT_DIMS
        assert tlee.DEFAULT_RULES == jlee.DEFAULT_RULES
        assert tlee.DEFAULT_EXPECTATIONS == jlee.DEFAULT_EXPECTATIONS
        assert tlee.BASELINE_RATIO == jlee.BASELINE_RATIO

    @pytest.mark.parametrize("i", range(len(jlee.DEFAULT_DIMS)))
    def test_margins_per_d(self, leeway_pair, i):
        got, want = leeway_pair
        assert got["config"] == want["config"]
        for label, rec in want["rules"].items():
            g = got["rules"][label]
            assert (g["gar"], g["f_used"]) == (rec["gar"], rec["f_used"])
            for metric in ("margin_abs", "margin_rel"):
                assert g[metric][i] == pytest.approx(rec[metric][i],
                                                     rel=1e-4), label
        # the fused forms on the same stack
        for gar in FUSED_LEEWAY:
            base = got["rules"][gar[len("fused-"):]]
            assert got["rules"][gar]["margin_abs"][i] == pytest.approx(
                base["margin_abs"][i], rel=1e-4), gar

    @pytest.mark.parametrize("i", range(len(jlee.DEFAULT_DIMS)))
    def test_gamma_per_d(self, leeway_pair, i):
        """Krum's gamma_m at 1e-5 relative.  GeoMed's at 1e-3: its score
        sums the square roots of the Gram-form squared distances, and
        between the f identical Byzantine rows those are fp32 rounding
        noise (~1e-3 at d = 1024, a different amount in each package),
        whose roots (~0.03) move the selection boundary by ~5e-4 of
        gamma_m."""
        got, want = leeway_pair
        for gname, rel in (("krum", 1e-5), ("geomed", 1e-3)):
            assert got["gamma"][gname]["values"][i] == pytest.approx(
                want["gamma"][gname]["values"][i], rel=rel), gname

    def test_certify_and_slope_on_one_report(self, leeway_pair):
        """``certify`` of the port and of the reference on the same
        report dicts, under every expectation set of the reference's
        tests and against the checked-in baseline (read only)."""
        got, want = leeway_pair
        with open(ROOT / "benchmarks" / "artifacts" /
                  "leeway_baseline.json") as fh:
            baseline = json.load(fh)
        doctored = json.loads(json.dumps(want))
        doctored["rules"]["bulyan-krum"]["margin_abs"] = [
            10.0 * m for m in doctored["rules"]["bulyan-krum"]["margin_abs"]]
        weak = {"bulyan-weak": ("rel", None, -0.25)}
        for report in (got, want):
            for kw in ({}, {"expectations": weak}, {"baseline": baseline},
                       {"expectations": {}, "baseline": doctored},
                       {"expectations": {**jlee.DEFAULT_EXPECTATIONS,
                                         **weak}, "baseline": baseline}):
                assert tlee.certify(report, **kw) == jlee.certify(report,
                                                                  **kw)
            for rec in report["rules"].values():
                for metric in ("abs", "rel"):
                    assert tlee.slope(report["config"]["dims"],
                                      rec[f"margin_{metric}"]) == \
                        jlee.slope(report["config"]["dims"],
                                   rec[f"margin_{metric}"])
        assert any("bulyan-weak" in v
                   for v in tlee.certify(got, expectations=weak))
        assert tlee.certify(got, baseline=baseline) == []
        assert tlee.slope((4, 16, 64), [np.sqrt(d) for d in (4, 16, 64)]) \
            == pytest.approx(0.5, abs=1e-6)

    def test_own_stacks_certify(self):
        """The port's own draw (a CPU generator seeded from (seed, d)):
        deterministic, the same on every device, certifying against the
        baseline with the weakened rule caught."""
        a = tlee.measure_leeway(rules=LEEWAY_RULES, device="cpu")
        b = tlee.measure_leeway(rules=LEEWAY_RULES, device="cpu")
        assert a == b
        with open(ROOT / "benchmarks" / "artifacts" /
                  "leeway_baseline.json") as fh:
            baseline = json.load(fh)
        assert tlee.certify(a, baseline=baseline) == []
        violations = tlee.certify(a, expectations={
            **tlee.DEFAULT_EXPECTATIONS,
            "bulyan-weak": ("rel", None, -0.25)}, baseline=baseline)
        assert violations and all("bulyan-weak" in v for v in violations)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

class TestSweep:
    def test_tiny_sweep_is_clean_with_reference_counts(self):
        report = tsweep.run_sweep(tsweep.SweepConfig(**TINY), device="cpu")
        assert report.ok(), report.violations[:5]
        assert {k: v[0] for k, v in report.sections.items()} == \
            REFERENCE_TINY_SECTIONS
        assert report.cases == sum(REFERENCE_TINY_SECTIONS.values()) == 1130

    def test_configs_match_reference(self):
        assert dataclasses.asdict(tsweep.SweepConfig()) == \
            dataclasses.asdict(jsweep.SweepConfig())
        assert dataclasses.asdict(tsweep.QUICK) == \
            dataclasses.asdict(jsweep.QUICK)
        assert tsweep._ATTACK_KW == jsweep._ATTACK_KW

    def test_sweep_is_deterministic_and_hooks_each_section(self):
        cfg = tsweep.SweepConfig(**{**TINY, "attacks": ("none", "zero")})
        seen = []

        class Hook:
            def __init__(self, name):
                seen.append(name)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        a = tsweep.run_sweep(cfg, device="cpu", section_hook=Hook)
        b = tsweep.run_sweep(cfg, device="cpu")
        assert a == b
        # on this grid the speculative section reports the reference's
        # own 8 violations (the same strings, read off its run): under
        # the zero attack Krum and GeoMed pick the all-zero row, every
        # token of the aggregate ties, and the colluding draft's token
        # is accepted as an argmax; every other section is clean
        assert a.violations == REFERENCE_ZERO_SPECULATIVE
        assert {k: v[1] for k, v in a.sections.items()} == {
            name: 8 if name == "speculative" else 0
            for name, _ in tsweep.SECTIONS}
        assert seen == [name for name, _ in tsweep.SECTIONS]

    def test_cli_names_the_missing_section(self, capsys):
        """The section this test once found named as missing is now
        reported, with the reference's case and violation counts on the
        quick grid."""
        assert tsweep.main(["--quick", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        cases, bad = REFERENCE_QUICK_SPECULATIVE
        assert f"audit/speculative: {cases} cases, {bad} violations" in out
        assert "not ported" not in out
        assert "audit/total: 1325 cases, 0 violations" in out


class TestSweepCatchesInjectedBugs:
    """The reference's injected-bug cases (``tests/test_audit.py``)."""

    def test_report_aggregation(self):
        r = tsweep.AuditReport()
        r.add("a", 3, [])
        r.add("a", 2, ["boom"])
        r.add("b", 1, [])
        assert r.cases == 6 and not r.ok()
        assert r.sections == {"a": (5, 1), "b": (1, 0)}

    @pytest.mark.parametrize("base,shift", [("average", 100.0),
                                            ("krum", 10.0)])
    def test_hull_violation_is_reported_not_raised(self, base, shift):
        """An aggregate pushed off the hull (``escaped-average``) and a
        Krum whose certificate lies about its output (``lying-krum``):
        the same violations as the reference's."""
        texts = []
        for reg, mod, result, as_arr in (
                (treg, tinv, AggResult, torch.from_numpy),
                (jreg, jinv, JaxResult, jnp.asarray)):
            rule = reg.resolve_rule(base)

            def doctored(grads, f, rule=rule, result=result):
                res = rule.dense_fn(grads, f)
                return result(res.gradient + shift, res.selected,
                              res.scores)

            fake = dataclasses.replace(rule, name=f"doctored-{base}",
                                       dense_fn=doctored)
            grads = as_arr(_stack(9, 4))
            res = fake.dense_fn(grads, 2)
            texts.append(mod.check_rule_output(
                fake, res.gradient, res.selected,
                mod.effective_stack(fake, grads, None), 2, "x"))
        assert texts[0] == texts[1]
        assert any("hull" in v for v in texts[0])


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_entry_points_run_on_the_cpu():
    """``python -m repro_torch.audit`` and ``scripts/torch_run_audit.py``
    on the CPU: no violation, and neither imports JAX or the reference."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['torch_run_audit', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_path('scripts/torch_run_audit.py',\n"
        "                   run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'rep', 'scripts/torch_obs_report.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = {**__import__("os").environ, "PYTHONPATH": "src"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "torch_run_audit: 0 total violations" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.audit", "leeway", "--device",
         "cpu"], capture_output=True, text=True,
        timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "leeway: 0 violations" in out.stdout


def test_report_script_imports_nothing_of_the_reference():
    spec = importlib.util.spec_from_file_location(
        "_torch_run_audit", ROOT / "scripts" / "torch_run_audit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.BASELINE == ROOT / "benchmarks" / "artifacts" / \
        "leeway_baseline.json"
