"""The launch harness's dry-run (``repro_torch.launch.dryrun``), its
matrix runner and tables, and the ``meta`` readiness of the port.

* The reference's four ``tests/test_dryrun.py`` cases through ``run_one``
  in-process, with its schema assertions, and one through the CLI.
* ``RecordingMesh``'s collectives per kind against a real CPU gloo
  world's ``Mesh.comm["by_kind"]``, rank by rank: reduced llama3.2-3b's
  train step on a (2, 2) mesh (``bulyan-krum`` over ``fused``, ``krum``
  over ``xla`` with the attack's ``"top"`` coordinate, the asynchronous
  ``stale-bulyan-krum`` over ``pallas``) and the robust decode step on a
  (2, 1) mesh, both worlds spawned once, side by side.
* A step traced on ``meta`` against the same step on CPU tensors: the
  same ``FlopCounterMode`` total and the same kernel launches (on the
  CPU, the calls each wrapper makes to its plain version, which stand for
  the card's launches; their own ops are hidden from the counters, as a
  kernel is no ATen op), for ``bulyan-krum`` over ``xla``, ``pallas``
  and ``fused`` and for ``krum``: the fixed ``meta`` selection
  (``repro_torch.device.host_index``) changes no shape.
* The kernel wrappers' ``meta`` branch: the kernel's output shape and
  dtype, one launch counted.
* ``_sqrt_d`` bit for bit, ``grad`` of the loss on ``meta`` for every
  reduced config, ``resolve_device("meta")``.
* ``summarize`` renders the reference's tables; ``sweep`` skips what
  exists.
"""
import concurrent.futures
import contextlib
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import summarize as jsummarize  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.core.pytree import tree_map  # noqa: E402
from repro_torch.device import host_index, resolve_device  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from repro_torch.dist.train import make_loss_fn, make_train_step  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import dryrun, summarize, sweep  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.attention import _sqrt_d  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from torch.utils._python_dispatch import _disable_current_modes  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import torch_launch_cases as cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pairwise_gram, fused_agg, coord_stats, bulyan_select = (
    importlib.import_module(f"repro_torch.kernels.{m}")
    for m in ("pairwise_gram", "fused_agg", "coord_stats", "bulyan_select"))

ROOFLINE_KEYS = ("compute_s", "memory_s", "collective_s", "dominant",
                 "useful_flops_ratio")


# ---------------------------------------------------------------------------
# the reference's four cases
# ---------------------------------------------------------------------------

def _schema(rec):
    """What ``tests/test_dryrun.py`` and ``summarize`` read."""
    for k in ROOFLINE_KEYS + ("model_flops_total", "model_flops_per_chip",
                              "collective_bytes_per_chip", "peak_flops"):
        assert k in rec["roofline"]
    assert rec["roofline"]["compute_s"] > 0
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes"):
        assert rec["memory_analysis"][k] > 0
    assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
    assert list(rec["collectives"]) == list(dryrun.COLLECTIVES)
    assert rec["hlo_lines"] > 0
    assert isinstance(rec["kernel_launches"], dict)
    for k in ("mesh", "multi_pod", "gar", "lower_s", "compile_s",
              "top_collective_ops", "no_effect", "overrides"):
        assert k in rec
    json.dumps(rec)


@pytest.fixture(scope="module")
def case_records():
    return {
        "train": dryrun.run_one("mamba2-130m", "train_4k", reduced=True),
        "multipod": dryrun.run_one("gemma3-1b", "decode_32k", reduced=True,
                                   multi_pod=True),
        "serve": dryrun.run_one("gemma3-1b", "decode_32k", reduced=True,
                                serve_gar="bulyan-krum", serve_f=1,
                                serve_replicas=7),
        "async": dryrun.run_one("mamba2-130m", "train_4k", reduced=True,
                                async_tau=3, async_schedule="fixed",
                                gar="stale-bulyan-krum",
                                attack="stale_replay"),
    }


def test_reduced_dryrun_train_artifact(case_records):
    rec = case_records["train"]
    _schema(rec)
    assert rec["mesh"] == "16x16"
    assert sum(v["count"] for v in rec["collectives"].values()) > 0
    assert rec["roofline"]["peak_flops"] == dryrun.PEAK_FLOPS_FP32


def test_reduced_dryrun_multipod_decode(case_records):
    rec = case_records["multipod"]
    _schema(rec)
    assert rec["mesh"] == "2x16x16"
    assert rec["multi_pod"] is True


def test_reduced_dryrun_robust_ensemble_decode(case_records):
    rec = case_records["serve"]
    _schema(rec)
    assert rec["serve_gar"] == "bulyan-krum"
    assert rec["serve_replicas"] == 7
    assert rec["hlo_lines"] > 0
    # 7 replicas do not split over 16 data ranks: the vocabulary does
    # over model, so the (n, n) partials are all-reduced and the
    # aggregate gathered back
    assert rec["collectives"]["all-reduce"]["count"] >= 1
    assert rec["collectives"]["all-gather"]["count"] >= 1


def test_reduced_dryrun_async_stale_train(case_records):
    rec = case_records["async"]
    _schema(rec)
    assert rec["async_tau"] == 3
    assert rec["gar"] == "stale-bulyan-krum"
    assert rec["roofline"]["compute_s"] > 0


def test_dryrun_cli_writes_the_artifact(tmp_path):
    out = tmp_path / "a.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "train_4k", "--reduced",
         "--distance-backend", "pallas", "--legacy-sharding",
         "--expert-gather", "--unroll", "--attn-shard", "batch",
         "--out", str(out)], capture_output=True, text=True, timeout=300,
        env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    _schema(rec)
    assert rec["mesh"] == "16x16"
    assert rec["legacy_sharding"] is True
    assert rec["overrides"] == {"unroll_scan": True, "attn_shard": "batch"}
    assert rec["no_effect"] == ["expert_gather", "unroll_scan",
                                "attn_shard"]
    # one K1 per local leaf slice under the model axis
    assert rec["kernel_launches"] == {"pairwise_gram_partial": 11}


@pytest.mark.parametrize("arch,shape,kw,launches", [
    ("llama3.2-3b", "decode_32k", dict(serve_gar="bulyan-krum", serve_f=1,
                                       serve_replicas=8,
                                       serve_speculative_k=4,
                                       distance_backend="fused"),
     {"pairwise_gram_partial": 4}),
    ("mixtral-8x22b", "train_4k", dict(moe_impl="scatter",
                                       gar="reputation-krum", rep_lr=0.5,
                                       telemetry=True), {}),
    ("gemma3-1b", "train_4k", dict(gar="buffered-bulyan-krum",
                                   attack="random"), {}),
    ("mamba2-130m", "train_4k", dict(async_tau=2, async_schedule="random",
                                     gar="stale-bulyan-krum"), {}),
], ids=["verify", "reputation-telemetry", "buffered-random",
        "async-random"])
def test_other_steps_trace(arch, shape, kw, launches):
    """The verify step (one aggregation per block position), a stateful
    rule with telemetry, a random attack and the random delay schedule
    (drawn without a generator on ``meta``)."""
    rec = dryrun.run_one(arch, shape, reduced=True, **kw)
    _schema(rec)
    assert rec["kernel_launches"] == launches
    assert rec["collectives"]["all-reduce"]["count"] > 0


def test_skip_record():
    rec = dryrun.run_one("gemma-2b", "long_500k")
    assert rec == {"arch": "gemma-2b", "shape": "long_500k",
                   "skipped": True,
                   "reason": "long_500k not applicable (see DESIGN.md §6)"}


# ---------------------------------------------------------------------------
# the prediction against real ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        train = pool.submit(run_on_mesh, cases.train_comm, (2, 2),
                            args=(list(cases.TRAIN),), device="cpu",
                            num_threads=1, timeout=300)
        serve = pool.submit(run_on_mesh, cases.serve_comm, (2, 1),
                            device="cpu", num_threads=1, timeout=300)
        return train.result(), serve.result()


@pytest.mark.parametrize("name", list(cases.TRAIN))
def test_recording_mesh_equals_gloo_train_step(worlds, name):
    cfg = get_reduced(cases.ARCH)
    n, kw, asynchronous = cases.TRAIN[name]
    for rank, got in enumerate(worlds[0]):
        mesh = dryrun.RecordingMesh((2, 2), rank=rank)
        assert mesh.coords == got["coords"]
        pred = dryrun.trace_train_step(
            cfg, AggSpec(**kw), get_optimizer("momentum", 1e-2), mesh,
            cases.train_batch(cfg.vocab_size, n), asynchronous=asynchronous)
        assert pred["by_kind"] == got[name], (rank, name)
        assert sum(v["calls"] for v in got[name].values()) > 0
        want_k1 = 0 if kw["distance_backend"] == "xla" else 11
        assert pred["launches"]["pairwise_gram_partial"] == want_k1


def test_recording_mesh_equals_gloo_decode_step(worlds):
    cfg = get_reduced(cases.ARCH)
    for rank, got in enumerate(worlds[1]):
        mesh = dryrun.RecordingMesh((2, 1), rank=rank)
        pred = dryrun.trace_serve_step(
            cfg, AggSpec(**cases.SERVE_SPEC), mesh, cases.SERVE_N,
            cases.SERVE_SLOTS, cases.SERVE_CACHE,
            pos=np.zeros((cases.SERVE_SLOTS,), np.int32))
        assert pred["by_kind"] == got["decode"], rank
        assert got["decode"]["all_gather"]["calls"] == 1
        # model = 1: K5 on the gathered stack
        assert pred["launches"]["fused_aggregate"] == 3


def test_recording_mesh_counts_like_a_mesh():
    mesh = dryrun.RecordingMesh((2, 2), rank=3)
    assert mesh.coords == {"data": 1, "model": 1}
    x = torch.empty((3, 4), device="meta")
    assert mesh.all_reduce(x, "model").shape == (3, 4)
    assert mesh.all_gather(x, "data", 1).shape == (3, 8)
    assert mesh.gather(x, "model", 0, dst=0) is None
    assert mesh.gather(x, "model", 0, dst=1).shape == (6, 4)
    assert mesh.broadcast(x, "model", 0).shape == (3, 4)
    one = dryrun.RecordingMesh((4, 1), rank=0)
    assert one.all_reduce(x, "model") is x
    assert one.comm["calls"] == 0
    assert mesh.comm["by_kind"] == {
        "all_reduce": {"calls": 1, "bytes": 48},
        "all_gather": {"calls": 1, "bytes": 96},
        "gather": {"calls": 2, "bytes": 96},
        "broadcast": {"calls": 1, "bytes": 48}}
    cpu = mesh.all_gather(torch.ones(2, dtype=torch.float64), "model")
    assert cpu.device.type == "cpu" and torch.equal(cpu, torch.zeros(4,
                                                    dtype=torch.float64))


# ---------------------------------------------------------------------------
# meta against CPU tensors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_calls():
    """Per kernel name, the calls CPU tensors make to each wrapper's
    plain version (where a CUDA tensor launches the kernel; K5 counts
    its parts, as on the card), each run with the dispatch modes off."""
    counts = dict.fromkeys(_build.LAUNCHES, 0)
    saved = []

    def spy(mod, attr, name):
        orig = getattr(mod, attr)

        def call(*args, **kwargs):
            counts[name] += 1
            with _disable_current_modes():
                return orig(*args, **kwargs)

        saved.append((mod, attr, orig))
        setattr(mod, attr, call)

    spy(pairwise_gram, "pairwise_gram_partial_plain",
        "pairwise_gram_partial")
    spy(fused_agg, "pairwise_gram_partial_plain", "pairwise_gram_partial")
    spy(fused_agg, "select_weights_plain", "select_weights")
    spy(fused_agg, "fused_coordinate_plain", "fused_coordinate")
    spy(coord_stats, "coord_stats_plain", "coord_stats")
    spy(bulyan_select, "bulyan_select_plain", "bulyan_select")
    k5 = fused_agg.fused_aggregate_plain
    parts = ("pairwise_gram_partial", "select_weights", "fused_coordinate")

    def whole(*args, **kwargs):
        before = sum(counts[p] for p in parts)
        out = k5(*args, **kwargs)
        counts["fused_aggregate"] += sum(counts[p] for p in parts) - before
        return out

    saved.append((fused_agg, "fused_aggregate_plain", k5))
    fused_agg.fused_aggregate_plain = whole
    try:
        yield counts
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


META_CASES = {
    "bulyan-xla": dict(gar="bulyan-krum", distance_backend="xla"),
    "bulyan-pallas": dict(gar="bulyan-krum", distance_backend="pallas"),
    "bulyan-fused": dict(gar="bulyan-krum", distance_backend="fused"),
    "krum": dict(gar="krum", attack="omniscient_lp",
                 attack_kwargs=(("coord", "top"),)),
}


@pytest.mark.parametrize("name", list(META_CASES))
def test_meta_step_matches_cpu_step(name):
    torch.set_num_threads(1)
    cfg = get_reduced(cases.ARCH)
    spec = AggSpec(f=1, **dict(dict(attack="omniscient_linf"),
                               **META_CASES[name]))
    batch = cases.train_batch(cfg.vocab_size, 7)

    def run(device):
        params = init_model(0, cfg, device=device)
        opt = get_optimizer("momentum", 1e-2)
        step = make_train_step(cfg, spec, opt)
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        return step, (params, opt.init(params), b)

    step, args = run("cpu")
    with plain_calls() as cpu_calls:
        flops = FlopCounterMode(display=False)
        with flops:
            step(*args)
    step, args = run("meta")
    meta = dryrun.trace_step(step, *args)
    assert meta["flops"] == flops.get_total_flops() > 0
    assert meta["launches"] == cpu_calls
    want = {"bulyan-xla": 0, "krum": 0}.get(name, 11)
    assert meta["launches"]["pairwise_gram_partial"] == want


def test_kernel_wrappers_meta_branch():
    x = torch.empty((7, 300), device="meta")
    _build.reset_launches()
    assert pairwise_gram.pairwise_gram_partial(x).shape == (7, 7)
    w, sel, scores = fused_agg.select_weights(
        torch.empty((7, 7), device="meta"), 7, 1, "bulyan-krum")
    assert (w.shape, sel.shape, scores.shape) == ((5, 7), (1, 7), (1, 7))
    agg = fused_agg.fused_coordinate(x, w, 1, mode="bulyan-krum")
    assert agg.shape == (300,) and agg.dtype == torch.float32
    med, trim = coord_stats.coord_stats(x.to(torch.bfloat16), 2)
    assert med.shape == trim.shape == (300,) and med.dtype == torch.float32
    assert bulyan_select.bulyan_select(x[:5], 1).shape == (300,)
    out = fused_agg.fused_aggregate(x, 1, mode="bulyan-krum")
    assert [t.shape for t in out] == [(300,), (7,), (7,)]
    assert all(t.device.type == "meta" for t in out)
    assert _build.LAUNCHES == {
        "pairwise_gram_partial": 2, "select_weights": 2,
        "fused_coordinate": 2, "fused_aggregate": 3, "bulyan_select": 1,
        "coord_stats": 1}
    _build.reset_launches()
    with pytest.raises(TypeError):
        pairwise_gram.pairwise_gram_partial(x.to(torch.float16))


# ---------------------------------------------------------------------------
# meta readiness
# ---------------------------------------------------------------------------

def test_sqrt_d_is_unchanged_bit_for_bit():
    import jax.numpy as jnp
    for d in (1, 2, 3, 64, 96, 128, 160, 256, 1152, 4096):
        got = _sqrt_d(d, "cpu")
        old = torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert torch.equal(got, old)
        assert got.item() == float(np.asarray(jnp.sqrt(d),
                                              dtype=np.float32))
    assert _sqrt_d(64, "meta").device.type == "meta"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grad_of_the_loss_runs_on_meta(arch):
    cfg = get_reduced(arch)
    params = init_model(0, cfg, device="meta")
    toks = torch.empty((2, 16), dtype=torch.int32, device="meta")
    args = [params, toks, toks]
    if cfg.arch_type in ("audio", "vlm"):
        args.append(torch.empty((2, cfg.encoder_seq or cfg.vision_seq,
                                 cfg.d_model), device="meta"))
    grads = torch.func.grad(make_loss_fn(cfg))(*args)
    assert tree_map(lambda g: (g.shape, g.dtype, g.device.type), grads) \
        == tree_map(lambda p: (p.shape, p.dtype, "meta"), params)


def test_resolve_device_takes_meta_only_when_asked():
    import inspect
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    assert inspect.signature(resolve_device).parameters[
        "device"].default == "cuda"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    assert host_index(torch.tensor(3)) == 3 and host_index(5) == 5
    assert host_index(torch.empty((), dtype=torch.int64,
                                  device="meta")) == 0


# ---------------------------------------------------------------------------
# the tables and the matrix runner
# ---------------------------------------------------------------------------

def _artifacts():
    base = dict(cost_analysis={"flops": 1.5e12, "bytes accessed": 2.5e11},
                memory_analysis={"temp_size_in_bytes": 3 * 2 ** 30},
                collectives={k: {"bytes": (i + 1) * 2 ** 28, "count": i}
                             for i, k in enumerate(dryrun.COLLECTIVES)},
                compile_s=2.5, kernel_launches={"pairwise_gram_partial": 74})
    roof = dict(compute_s=0.02, memory_s=0.07, collective_s=0.01,
                dominant="memory_s", useful_flops_ratio=0.0625)
    return [
        dict(base, arch="gemma3-1b", shape="train_4k", mesh="16x16",
             roofline=roof),
        dict(base, arch="mamba2-130m", shape="decode_32k", mesh="16x16",
             roofline=dict(roof, useful_flops_ratio=None,
                           dominant="collective_s")),
        dict(base, arch="gemma3-1b", shape="train_4k", mesh="2x16x16",
             roofline=roof),
        {"arch": "gemma-2b", "shape": "long_500k", "skipped": True},
        {"arch": "gemma-2b", "shape": "long_500k", "skipped": True},
        {"arch": "qwen1.5-4b", "shape": "train_4k", "error": "boom"},
    ]


def test_summarize_renders_the_reference_tables(tmp_path):
    recs = _artifacts()
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    loaded = summarize.load(str(tmp_path))
    assert loaded == jsummarize.load(str(tmp_path)) == recs
    for fn in ("dryrun_table", "roofline_table", "interesting"):
        got = getattr(summarize, fn)(loaded)
        assert got == getattr(jsummarize, fn)(loaded)
        assert len(got.splitlines()) > 2


def test_sweep_skips_what_exists(tmp_path):
    done = ("mamba2-130m.train_4k", "mamba2-130m.long_500k",
            "gemma-2b.train_4k")
    for tag in done:
        (tmp_path / f"{tag}.pod1.json").write_text("{}")
    lines = sweep.run(str(tmp_path), archs=["mamba2-130m", "gemma-2b"],
                      shapes=["train_4k", "long_500k"], pods="1")
    assert lines[:3] == [f"[{i + 1}/4] {tag}.pod1: exists, skip"
                         for i, tag in enumerate(done)]
    # the one left runs in a subprocess: a shape gemma-2b does not run
    assert lines[3].startswith("[4/4] gemma-2b.long_500k.pod1: skip(n/a)")
    rec = json.loads((tmp_path / "gemma-2b.long_500k.pod1.json").read_text())
    assert rec["skipped"] is True
