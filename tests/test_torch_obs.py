"""Port parity of the telemetry layer (``repro_torch.obs``) against the
JAX reference (``repro.obs``).

* the ring: push, wrap and drain, starting from a reference ring carried
  across by ``repro_torch.interop.metrics_buffer_from_jax``, and a push
  that reads no value on the host;
* ``dense_diagnostics`` / ``tree_diagnostics`` on stacks with ties,
  +-inf and NaN: floats at 1e-4 relative (NaN and inf in the same
  places), ``selected``, ``scores`` and ``step`` exact;
* every ``obs-`` name of the audit roster and the nestings
  (``stale-obs-krum``, ``obs-stale-fused-bulyan-krum``,
  ``obs-reputation-krum``) over 3 steps with the state carried: the
  result equal to the base rule's bit for bit (telemetry off == on),
  the ring equal to the reference's;
* the detectors, the exporters and ``SpanTimer``'s schema;
* both trainers' ``telemetry()`` against the reference's over 3 steps on
  a narrow MLP, and ``scripts/torch_obs_report.py``'s demo started from
  the reference's parameters.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.agg import registry as jreg  # noqa: E402
from repro.agg import state as jstate  # noqa: E402
from repro.agg.specs import AggSpec as JaxSpec  # noqa: E402
from repro.audit.sweep import audit_roster as jroster  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro.obs import buffer as jbuf  # noqa: E402
from repro.obs import detect as jdetect  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import forensics as jfor  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.optim import get_optimizer as jget  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.agg import registry as treg  # noqa: E402
from repro_torch.agg import state as tstate  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.dist import robust as trobust  # noqa: E402
from repro_torch.interop import (metrics_buffer_from_jax,  # noqa: E402
                                 params_from_jax)
from repro_torch.obs import buffer as tbuf  # noqa: E402
from repro_torch.obs import detect as tdetect  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import forensics as tfor  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.training import trainer as ttrainer  # noqa: E402

TOL = 1e-4
F, STEPS = 2, 3
SHAPES = {"w": (4, 5), "b": (7,), "c": (2, 3, 2)}
#: the obs- names of the reference's audit roster, and the nestings
ROSTER_OBS = [n for n in jroster() if "obs-" in n]
NESTED = ["stale-obs-krum", "obs-stale-fused-bulyan-krum",
          "obs-reputation-krum", "obs-fused-krum", "obs-buffered-cwmed",
          "obs-stale-reputation-krum"]
OBS_NAMES = sorted(set(ROSTER_OBS) | set(NESTED))
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    """1e-4 of the largest finite |want| (1 at least); NaN and inf in the
    same places, infinities of the same sign."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    assert np.array_equal(inf, np.isinf(got))
    assert np.array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    scale = max(1.0, float(np.max(np.abs(want[fin]), initial=0.0)))
    err = np.max(np.abs(got[fin] - want[fin]), initial=0.0)
    assert err <= tol * scale, (err, scale)


#: fields a record holds exactly (copied from the rule or the counter)
EXACT = ("step", "selected", "scores")


def _same_record(got, want, exact=EXACT):
    """One ``AggDiagnostics`` (or drained dict) against the reference."""
    for fld in jbuf.AggDiagnostics._fields:
        g = _np(got[fld] if isinstance(got, dict) else getattr(got, fld))
        w = _np(want[fld] if isinstance(want, dict) else getattr(want, fld))
        if fld in exact:
            assert np.array_equal(g, w, equal_nan=True), fld
        else:
            _close(g, w)


def _same_drain(got, want, exact=EXACT):
    assert got["pushed"] == want["pushed"]
    assert len(got["records"]) == len(want["records"])
    for g, w in zip(got["records"], want["records"]):
        assert set(g) == set(w)
        _same_record(g, w, exact)
    _close(got["selection_frequency"], want["selection_frequency"])


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _record_np(step, n, rng):
    vec = lambda: rng.standard_normal(n).astype(np.float32)  # noqa: E731
    return dict(step=np.float32(step), selected=(rng.random(n) > 0.5)
                .astype(np.float32), scores=vec(), dist_to_agg=vec(),
                trimmed_frac=vec(), reputation=vec(), staleness=vec(),
                agg_dev=np.float32(rng.standard_normal()),
                spread=np.float32(rng.standard_normal()))


def _jrec(r):
    return jbuf.AggDiagnostics(**{k: jnp.asarray(v) for k, v in r.items()})


def _trec(r, device="cpu"):
    return tbuf.AggDiagnostics(**{k: torch.as_tensor(v, device=device)
                                  for k, v in r.items()})


class TestRing:
    @pytest.mark.parametrize("start,extra", [(0, 3), (2, 1), (2, 5),
                                             (4, 2), (6, 7)])
    def test_push_wrap_drain_from_reference_ring(self, start, extra):
        """A reference ring (empty, half full, full, wrapped) carried
        across, then pushed in both packages: the same drain."""
        cap, n = 4, 5
        rng = np.random.default_rng(start * 10 + extra)
        recs = [_record_np(s, n, rng) for s in range(start + extra)]
        jb = jbuf.init_metrics_buffer(cap, n)
        for r in recs[:start]:
            jb = jbuf.push_record(jb, _jrec(r))
        tb = metrics_buffer_from_jax(
            jax.tree_util.tree_map(np.asarray, jb), device="cpu")
        assert tb.capacity == cap and tb.cursor.dtype == torch.int32
        assert tb.cursor.ndim == 0
        _same_drain(tbuf.drain(tb), jbuf.drain(jb))
        for r in recs[start:]:
            jb = jbuf.push_record(jb, _jrec(r))
            tb = tbuf.push_record(tb, _trec(r))
        got, want = tbuf.drain(tb), jbuf.drain(jb)
        _same_drain(got, want, exact=jbuf.AggDiagnostics._fields)
        assert [int(r["step"]) for r in got["records"]] == list(
            range(max(0, start + extra - cap), start + extra))

    def test_push_is_pure_and_reads_nothing_on_the_host(self):
        """The input ring is unchanged, and a push runs on ``meta``
        tensors (which hold no values): it never reads the cursor or a
        row on the host."""
        tb = tbuf.init_metrics_buffer(3, 4, device="cpu")
        rec = _trec(_record_np(1, 4, np.random.default_rng(0)))
        out = tbuf.push_record(tb, rec)
        assert int(tb.cursor) == 0 and not tb.records.scores.any()
        assert int(out.cursor) == 1
        meta = jax.tree_util.tree_map(lambda x: x.to("meta"), tb)
        meta = tbuf.MetricsBuffer(meta[0], tbuf.AggDiagnostics(*meta[1]),
                                  meta[2])
        mrec = tbuf.AggDiagnostics(*(x.to("meta") for x in rec))
        pushed = tbuf.push_record(meta, mrec)
        assert pushed.cursor.device.type == "meta"
        assert pushed.records.selected.shape == (3, 4)

    def test_empty_and_init_match_reference(self):
        for empty in ((), None):
            got, want = tbuf.drain(empty), jbuf.drain(empty)
            assert got["pushed"] == want["pushed"] == 0
            assert got["records"] == want["records"] == []
            assert got["selection_frequency"].shape == (0,)
        tb, jb = (tbuf.init_metrics_buffer(7, 3, device="cpu"),
                  jbuf.init_metrics_buffer(7, 3))
        for t, j in zip(jax.tree_util.tree_leaves(tuple(tb)),
                        jax.tree_util.tree_leaves(jb)):
            assert t.shape == j.shape and str(t.dtype).endswith(
                str(j.dtype))
        assert tbuf.DEFAULT_OBS_CAPACITY == jbuf.DEFAULT_OBS_CAPACITY


# ---------------------------------------------------------------------------
# the diagnostics
# ---------------------------------------------------------------------------

def _diag_stack(kind, n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2.0) / 2.0
        x[1] = x[0]
    elif kind == "inf":
        x[1, ::7] = np.inf
        x[3, 2::11] = -np.inf
    elif kind == "nan":
        x[2, ::5] = np.nan
    elif kind == "mixed":
        x = np.round(x * 2.0) / 2.0
        x[0, ::9] = np.nan
        x[1, 1::13] = np.inf
        x[4, 3::17] = -np.inf
    return x


def _diag_inputs(kind, n, d, seed=0):
    rng = np.random.default_rng(seed + 1)
    x = _diag_stack(kind, n, d, seed)
    agg = np.nanmedian(np.where(np.isinf(x), np.nan, x), axis=0).astype(
        np.float32)
    if kind in ("nan", "mixed"):
        agg[::23] = np.nan
    sel = (rng.random(n) > 0.4).astype(np.float32)
    scores = rng.standard_normal(n).astype(np.float32)
    rep = rng.random(n).astype(np.float32)
    stale = rng.integers(0, 3, n).astype(np.float32)
    return x, agg, sel, scores, rep, stale


DIAG_CASES = [(kind, n, d, f) for kind in ("plain", "ties", "inf", "nan",
                                           "mixed")
              for (n, d, f) in ((7, 48, 1), (11, 2000, 2))] + [
    ("plain", 5, 600, 0), ("ties", 9, 513, 6), ("plain", 39, 79_510, 9)]


class TestDiagnostics:
    @pytest.mark.parametrize("kind,n,d,f", DIAG_CASES)
    def test_dense_diagnostics(self, kind, n, d, f):
        x, agg, sel, scores, rep, stale = _diag_inputs(kind, n, d)
        want = jfor.dense_diagnostics(
            jnp.asarray(x), jnp.asarray(agg), jnp.asarray(sel),
            jnp.asarray(scores), f, jnp.int32(4), jnp.asarray(rep),
            jnp.asarray(stale))
        got = tfor.dense_diagnostics(
            torch.from_numpy(x), torch.from_numpy(agg),
            torch.from_numpy(sel), torch.from_numpy(scores), f, 4,
            torch.from_numpy(rep), torch.from_numpy(stale))
        _same_record(got, want)

    @pytest.mark.parametrize("kind", ["plain", "ties", "inf", "nan",
                                      "mixed"])
    @pytest.mark.parametrize("sizes", [{"w": (4, 5), "b": (7,),
                                        "c": (2, 3, 2)},
                                       {"a": (5,), "z": (1019,)},
                                       {"w": (300, 4), "b": (90,)}])
    def test_tree_diagnostics(self, kind, sizes):
        """Leaf budgets by Python's ``round`` (``{a: 5, z: 1019}`` puts
        2.5 coordinates on ``a``, which rounds to 2)."""
        n, f = 9, 2
        d = sum(int(np.prod(s)) for s in sizes.values())
        x, agg, sel, scores, rep, stale = _diag_inputs(kind, n, d, seed=3)
        leaves, agg_leaves, off = [], [], 0
        for k in sorted(sizes):
            size = int(np.prod(sizes[k]))
            leaves.append(x[:, off:off + size].reshape((n,) + sizes[k]))
            agg_leaves.append(agg[off:off + size].reshape(sizes[k]))
            off += size
        want = jfor.tree_diagnostics(
            [jnp.asarray(a) for a in leaves],
            [jnp.asarray(a) for a in agg_leaves], jnp.asarray(sel),
            jnp.asarray(scores), f, jnp.int32(2), jnp.asarray(rep),
            jnp.asarray(stale))
        got = tfor.tree_diagnostics(
            [torch.from_numpy(a) for a in leaves],
            [torch.from_numpy(a) for a in agg_leaves],
            torch.from_numpy(sel), torch.from_numpy(scores), f, 2,
            torch.from_numpy(rep), torch.from_numpy(stale))
        _same_record(got, want)

    @pytest.mark.parametrize("d", [512, 513, 545, 1000, 4099, 79_510])
    def test_sketch_blocks(self, d):
        x = np.arange(3 * d, dtype=np.float32).reshape(3, d)
        got = tfor._sketch_dense(torch.from_numpy(x)).numpy()
        assert np.array_equal(got, np.asarray(
            jfor._sketch_dense(jnp.asarray(x))))

    @pytest.mark.parametrize("f", [0, 1, 3, 5, 20])
    def test_trim_bounds_rank_ties_and_nan(self, f):
        x = np.round(np.random.default_rng(f).standard_normal((11, 64)))
        x = x.astype(np.float32)
        x[4, ::3] = np.nan
        x[5, 1::4] = np.inf
        for got, want in zip(tfor._trim_bounds(torch.from_numpy(x), f),
                             jfor._trim_bounds(jnp.asarray(x), f)):
            assert np.array_equal(got.numpy(), np.asarray(want),
                                  equal_nan=True)

    def test_obs_name(self):
        for name in ("krum", "obs-krum", "stale-krum", "obs-stale-krum"):
            assert tfor.obs_name(name) == jfor.obs_name(name)
        assert tfor.OBS_SKETCH == jfor.OBS_SKETCH
        assert tfor._SKETCH_BLOCKS == jfor._SKETCH_BLOCKS


# ---------------------------------------------------------------------------
# the obs- rules, state carried
# ---------------------------------------------------------------------------

def _n_for(name):
    return max(jreg.resolve_rule(name).min_n(F), F + 3)


def _stack(t, n, d=40):
    rng = np.random.default_rng(100 + t)
    x = 1.0 + rng.standard_normal((n, d))
    x[n - F:] = -x[:n - F].mean(axis=0)
    return x.astype(np.float32)


def _versions(t, n):
    return np.maximum(t - (np.arange(n) % 3), 0).astype(np.int32)


def _with_versions(state, t, n, as_array):
    """The bus versions of step t (and the step itself), when the state
    carries a bus; the reference's step is an int32 array."""
    if state.bus == ():
        return state
    step = t if as_array is torch.from_numpy else jnp.int32(t)
    return state._replace(step=step, bus=state.bus._replace(
        versions=as_array(_versions(t, n))))


def _base_of(name):
    """The rule telemetry wraps: the name without its ``obs-``."""
    return name.replace("obs-", "", 1)


def _same_fields(got, want, fields):
    for fld in fields:
        for a, b in zip(jax.tree_util.tree_leaves(getattr(got, fld)),
                        jax.tree_util.tree_leaves(getattr(want, fld))):
            assert torch.equal(a, b), fld


class TestObsRules:
    def test_roster_obs_names(self):
        assert set(ROSTER_OBS) == {"obs-krum", "obs-cwmed",
                                   "obs-bulyan-krum", "obs-stale-krum",
                                   "obs-reputation-krum"}

    @pytest.mark.parametrize("name", OBS_NAMES)
    def test_dense_off_equals_on_and_ring_matches(self, name):
        n = _n_for(name)
        tr, jr = treg.resolve_rule(name), jreg.resolve_rule(name)
        base = treg.resolve_rule(_base_of(name))
        assert (tr.state_fields, tr.obs_capacity) == (jr.state_fields,
                                                      jr.obs_capacity)
        ts = tstate.init_state(tr, torch.zeros((n, 40)))
        js = jstate.init_state(jr, jnp.zeros((n, 40), jnp.float32))
        bs = (tstate.init_state(base, torch.zeros((n, 40)))
              if base.stateful else None)
        for t in range(STEPS):
            x = _stack(t, n)
            ts = _with_versions(ts, t, n, torch.from_numpy)
            js = _with_versions(js, t, n, jnp.asarray)
            tres, ts = tr.dense_fn(torch.from_numpy(x), F, ts)
            jres, js = jr.dense_fn(jnp.asarray(x), F, js)
            if base.stateful:
                bs = _with_versions(bs, t, n, torch.from_numpy)
                bres, bs = base.dense_fn(torch.from_numpy(x), F, bs)
                _same_fields(ts, bs, [f for f in base.state_fields
                                      if f != "obs"])
                assert ts.step == bs.step
            else:
                bres = base.dense_fn(torch.from_numpy(x), F)
            for a, b in zip(tres, bres):   # telemetry off == on
                assert torch.equal(a, b)
            _close(tres.gradient.numpy(), np.asarray(jres.gradient))
            assert np.array_equal(tres.selected.numpy(),
                                  np.asarray(jres.selected))
            assert int(ts.step) == int(js.step)
        _same_drain(tbuf.drain(ts.obs), jbuf.drain(js.obs),
                    exact=("step", "selected"))

    @pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
    @pytest.mark.parametrize("name", ["obs-krum", "obs-cwmed",
                                      "obs-bulyan-krum", "obs-stale-krum",
                                      "obs-reputation-krum",
                                      "obs-stale-fused-bulyan-krum"])
    def test_tree_off_equals_on_and_ring_matches(self, name, backend):
        n = _n_for(name)
        d = sum(int(np.prod(s)) for s in SHAPES.values())

        def tree(t, as_array):
            x, out, off = _stack(t, n, d), {}, 0
            for k in sorted(SHAPES):
                size = int(np.prod(SHAPES[k]))
                out[k] = as_array(x[:, off:off + size].reshape(
                    (n,) + SHAPES[k]))
                off += size
            return out

        ts = js = bs = None
        base = _base_of(name)
        for t in range(STEPS):
            tt, jt = tree(t, torch.from_numpy), tree(t, jnp.asarray)
            if ts is None:
                rule = treg.resolve_rule(name)
                ts = tstate.init_state(rule, tt, flat=False)
                js = jstate.init_state(jreg.resolve_rule(name), jt,
                                       flat=False)
                brule = treg.resolve_rule(base)
                bs = (tstate.init_state(brule, tt, flat=False)
                      if brule.stateful else None)
            ts = _with_versions(ts, t, n, torch.from_numpy)
            js = _with_versions(js, t, n, jnp.asarray)
            tagg, tres, ts = trobust.distributed_aggregate(
                tt, F, name, state=ts, distance_backend=backend)
            jagg, jres, js = jrobust.distributed_aggregate(
                jt, F, name, state=js, distance_backend=backend)
            if bs is not None:
                bs = _with_versions(bs, t, n, torch.from_numpy)
                bagg, bres, bs = trobust.distributed_aggregate(
                    tt, F, base, state=bs, distance_backend=backend)
            else:
                bagg, bres = trobust.distributed_aggregate(
                    tt, F, base, distance_backend=backend)
            for k in SHAPES:
                assert torch.equal(tagg[k], bagg[k])
                _close(tagg[k].numpy(), np.asarray(jagg[k]))
            assert torch.equal(tres.selected, bres.selected)
            assert torch.equal(tres.scores, bres.scores)
            assert np.array_equal(tres.selected.numpy(),
                                  np.asarray(jres.selected))
        _same_drain(tbuf.drain(ts.obs), jbuf.drain(js.obs),
                    exact=("step", "selected"))

    @pytest.mark.parametrize("name", ["obs-obs-krum", "obs-nonsense",
                                      "obs-stale-obs-krum",
                                      "stale-obs-stale-krum",
                                      "obs-buffered-stale-krum",
                                      "reputation-obs-reputation-krum"])
    def test_nesting_error_texts(self, name):
        with pytest.raises(KeyError) as want:
            jreg.resolve_rule(name)
        with pytest.raises(KeyError) as got:
            treg.resolve_rule(name)
        assert str(got.value) == str(want.value).replace(
            repr(sorted(jreg.RULES)), repr(sorted(treg.RULES)))

    def test_spec_effective_gar(self):
        for kw in ({"gar": "krum"}, {"gar": "krum", "telemetry": True},
                   {"gar": "obs-krum", "telemetry": True},
                   {"gar": "stale-fused-bulyan-krum", "telemetry": True}):
            t, j = AggSpec(f=2, **kw), JaxSpec(f=2, **kw)
            assert t.effective_gar == j.effective_gar
            assert t.rule().name == j.rule().name
            assert t.rule().min_n(2) == j.rule().min_n(2)
        spec = AggSpec(f=2, gar="bulyan-krum", telemetry=True)
        with pytest.raises(ValueError, match="obs-bulyan-krum requires"):
            spec.validate(10)


# ---------------------------------------------------------------------------
# detectors, exporters, the span timer
# ---------------------------------------------------------------------------

def _drained_attack_run():
    """A reference ring of 5 Krum steps: 7 workers, the last two the
    sign-flipped honest mean, so Krum starves them."""
    rule = jreg.resolve_rule("obs-krum")
    n, f = 9, 2
    state = jstate.init_state(rule, jnp.zeros((n, 30), jnp.float32))
    for t in range(5):
        x = _stack(t, n, 30)
        _, state = rule.dense_fn(jnp.asarray(x), f, state)
    return jbuf.drain(state.obs)


class TestDetectors:
    @pytest.mark.parametrize("freq", [[0.0, 0.0, 1.0], [0.25] * 4,
                                      [0.1, 0.2, 0.7, 0.0], [], [0, 0],
                                      [1.0], [3.0, 1.0]])
    def test_entropy_and_collapse(self, freq):
        assert tdetect.selection_entropy(np.asarray(freq)) == \
            jdetect.selection_entropy(np.asarray(freq))
        for th in (0.3, 0.5, 0.9):
            assert tdetect.selection_collapsed(np.asarray(freq), th) == \
                jdetect.selection_collapsed(np.asarray(freq), th)

    def test_on_a_drained_run(self):
        out = _drained_attack_run()
        freq, recs = out["selection_frequency"], out["records"]
        assert np.array_equal(tdetect.suspicion_scores(recs, freq),
                              jdetect.suspicion_scores(recs, freq))
        assert np.array_equal(tdetect.margin_trajectory(recs),
                              jdetect.margin_trajectory(recs))
        assert np.array_equal(tdetect.suspicion_scores([], freq),
                              jdetect.suspicion_scores([], freq))
        assert set(np.argsort(tdetect.suspicion_scores(recs, freq))[-2:]) \
            == {7, 8}


class TestExport:
    def test_round_trip_and_reference_text(self, tmp_path):
        rows = _drained_attack_run()["records"]
        trows = [{k: torch.from_numpy(np.array(v)) for k, v in r.items()}
                 for r in rows]
        assert texport.write_jsonl(tmp_path / "t.jsonl", trows) == len(rows)
        jexport.write_jsonl(tmp_path / "j.jsonl", rows)
        assert (tmp_path / "t.jsonl").read_text() == \
            (tmp_path / "j.jsonl").read_text()
        back = texport.read_jsonl(tmp_path / "t.jsonl")
        assert back == jexport.read_jsonl(tmp_path / "j.jsonl")
        assert back[0]["selected"] == rows[0]["selected"].tolist()
        assert texport.write_csv(tmp_path / "t.csv", trows) == len(rows)
        jexport.write_csv(tmp_path / "j.csv", rows)
        assert (tmp_path / "t.csv").read_text() == \
            (tmp_path / "j.csv").read_text()

    def test_to_jsonable(self):
        obj = {"a": torch.tensor([1.5, 2.0]), 3: (np.float32(0.5),
                                                  np.int64(7)),
               "s": torch.tensor(4), "n": np.arange(3), "x": "text"}
        want = jexport.to_jsonable({"a": np.array([1.5, 2.0],
                                                  np.float32),
                                    3: (np.float32(0.5), np.int64(7)),
                                    "s": np.int64(4), "n": np.arange(3),
                                    "x": "text"})
        assert texport.to_jsonable(obj) == want
        assert json.dumps(texport.to_jsonable(obj)) == json.dumps(want)


class TestTrace:
    def test_span_timer_schema(self, tmp_path):
        assert ttrace.EVENT_FIELDS == jtrace.EVENT_FIELDS
        assert ttrace.span_event("a", 3, n=4) == jtrace.span_event(
            "a", 3, n=4)
        timer = ttrace.SpanTimer()
        with timer.span("outer", backend="cpu"):
            with timer.span("inner"):
                pass
        with pytest.raises(RuntimeError):
            with timer.span("failed"):
                raise RuntimeError("kept on exception")
        assert [e["name"] for e in timer.events] == ["inner", "outer",
                                                     "failed"]
        for ev in timer.events:
            assert tuple(ev) == ttrace.EVENT_FIELDS and ev["us"] >= 0.0
        assert timer.export_jsonl(tmp_path / "e.jsonl") == 3
        assert texport.read_jsonl(tmp_path / "e.jsonl") == timer.events

    def test_package_exports(self):
        assert tobs.__all__ == sorted(tobs.__all__) == jobs.__all__
        for name in tobs.__all__:
            assert hasattr(tobs, name), name


# ---------------------------------------------------------------------------
# the trainers and the report script
# ---------------------------------------------------------------------------

N_TR, F_TR = 7, 1
N_IN, N_HID, N_OUT, BATCH = 12, 8, 3, 6


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (0.4 * rng.standard_normal((N_IN, N_HID))).astype(
                np.float32),
            "b1": np.zeros(N_HID, np.float32),
            "w2": (0.4 * rng.standard_normal((N_HID, N_OUT))).astype(
                np.float32),
            "b2": np.zeros(N_OUT, np.float32)}


class _Batcher:
    def __init__(self, n_honest, seed=1):
        self.n_honest, self.seed = n_honest, seed

    def batch(self, t):
        rng = np.random.default_rng((self.seed, t))
        y = rng.integers(0, N_OUT, (self.n_honest, BATCH))
        x = rng.standard_normal((self.n_honest, BATCH, N_IN)) + y[..., None]
        return x.astype(np.float32), y.astype(np.int32)


def _jloss(p, x, y):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    logp = jax.nn.log_softmax(h @ p["w2"] + p["b2"])
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _tloss(p, x, y):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    logp = torch.log_softmax(h @ p["w2"] + p["b2"], dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None]))


class TestTrainers:
    @pytest.mark.parametrize("mode,gar,kw", [
        ("sync", "krum", {"attack": "signflip"}),
        ("sync", "bulyan-krum", {"attack": "signflip", "n_workers": 11,
                                 "f": 2}),
        ("async", "stale-krum", {"attack": "signflip", "async_tau": 2}),
        ("async", "fused-cwmed", {"attack": "zero", "async_tau": 1})])
    def test_telemetry_matches_reference(self, mode, gar, kw):
        kw = {"n_workers": N_TR, "f": F_TR, **kw}
        p0 = _params()
        jcls = (jtrainer.AsyncByzantineTrainer if mode == "async"
                else jtrainer.ByzantineTrainer)
        tcls = (ttrainer.AsyncByzantineTrainer if mode == "async"
                else ttrainer.ByzantineTrainer)
        runs = {}
        for telemetry in (False, True):
            ttr = tcls(_tloss, {k: torch.from_numpy(v)
                                for k, v in p0.items()},
                       get_optimizer("sgd", 0.1),
                       AggSpec(gar=gar, telemetry=telemetry, **kw),
                       device="cpu")
            ttr.run(_Batcher(kw["n_workers"] - kw["f"]), STEPS)
            runs[telemetry] = ttr
        # telemetry off == on: parameters and metrics bit for bit
        for k in p0:
            assert torch.equal(runs[False].params[k], runs[True].params[k])
        assert runs[False].history == runs[True].history
        assert runs[False].telemetry()["pushed"] == 0
        jtr = jcls(_jloss, {k: jnp.asarray(v) for k, v in p0.items()},
                   jget("sgd", 0.1), JaxSpec(gar=gar, telemetry=True, **kw))
        jtr.run(_Batcher(kw["n_workers"] - kw["f"]), STEPS)
        got, want = runs[True].telemetry(), jtr.telemetry()
        assert got["pushed"] == STEPS
        _same_drain(got, want, exact=("step", "selected"))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_report_from_reference_params():
    """The quick demo (n = 9, f = 2, 4 steps, krum) in both packages from
    the reference's seed-0 weights: the clean and defended reports agree
    (most-suspect row, selection frequencies, entropies at 1e-4), and so
    does the verdict.

    The attacked run submits the exact search's gamma_m at margin 1.0:
    the Byzantine row sits on Krum's selection boundary by construction,
    so its score ties the best honest score to the last bits and the pick
    falls to rounding.  There the test holds every step's selection
    equal, or the two candidates' scores within 1e-6 of each other.
    """
    from repro.models import simple as jsimple
    tscript, jscript = (_load_script("torch_obs_report"),
                        _load_script("obs_report"))
    params = params_from_jax(
        {k: np.asarray(v) for k, v in
         jsimple.init_mnist_mlp(jax.random.PRNGKey(0)).items()}, "cpu")
    got = tscript.demo("krum", "omniscient_lp", 9, 2, 4, device="cpu",
                       params=params)
    jattacked = jscript._train("krum", "omniscient_lp", 9, 2, 4)
    want = (jscript._report("clean", jscript._train("krum", "none", 9, 0,
                                                    4)),
            jscript._report("attacked (omniscient_lp)", jattacked),
            jscript._report("defended (signflip)", jscript._train(
                "krum", "signflip", 9, 2, 4)))
    for g, w in zip(got, want):
        assert (g["tag"], g["pushed"], g["recorded_steps"],
                g["collapsed"]) == (w["tag"], w["pushed"],
                                    w["recorded_steps"], w["collapsed"])
    for g, w in (got[0], want[0]), (got[2], want[2]):
        assert g["most_suspect"] == w["most_suspect"]
        assert abs(g["selection_entropy"] - w["selection_entropy"]) <= TOL
        assert g["selection_frequency"] == w["selection_frequency"]
        _close(g["suspicion"], w["suspicion"])
    tattacked = tscript._train("krum", "omniscient_lp", 9, 2, 4,
                               device="cpu", params=params)
    for tr, jr in zip(tattacked["records"], jattacked["records"]):
        if np.array_equal(tr["selected"], jr["selected"]):
            continue
        i, j = int(np.argmax(tr["selected"])), int(np.argmax(jr["selected"]))
        assert abs(float(jr["scores"][i] - jr["scores"][j])) <= 1e-6 * abs(
            float(jr["scores"][j]))
    # the verdict of the reference's exit rule
    for rep in (got, want):
        assert rep[1]["selection_entropy"] < rep[0]["selection_entropy"]
        assert rep[2]["most_suspect"] >= 9 - 2


def test_report_input_mode(tmp_path, capsys):
    """``--input`` replays an exported ring, as the reference's does."""
    out = _drained_attack_run()
    path = tmp_path / "ring.jsonl"
    texport.write_jsonl(path, out["records"] + [
        {"selection_frequency": out["selection_frequency"]}])
    tscript, jscript = (_load_script("torch_obs_report"),
                        _load_script("obs_report"))
    assert tscript.main(["--input", str(path), "--out",
                         str(tmp_path / "t.jsonl")]) == 0
    t_text = capsys.readouterr().out
    assert jscript.main(["--input", str(path), "--out",
                         str(tmp_path / "j.jsonl")]) == 0
    j_text = capsys.readouterr().out
    assert t_text.replace("t.jsonl", "") == j_text.replace("j.jsonl", "")
    assert texport.read_jsonl(tmp_path / "t.jsonl") == \
        texport.read_jsonl(tmp_path / "j.jsonl")
