#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the last line:

1. Setup: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, TF32 switched off for matmuls and cuDNN, and the build
   of every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel).
2. Every kernel against its plain PyTorch version on the card: K1
   (``pairwise_gram_partial``), the selection kernel, K4
   (``fused_coordinate``) and K5 (``fused_aggregate``) in all 7 modes, at
   n = 39, f = 9 with d = 79,510 and 486,346 (the paper's two models),
   plus edges d in {1, 129, 4097} and n in {7, 38, 64}, fp32 (tolerance
   1e-4 relative) and bf16 (5e-2).  Selections must be exactly equal, and
   K5 must equal K1 + select + K4 bit for bit.  Times per call of each
   kernel, its plain version and one PyTorch call as a yardstick.
3. The main path: ``ByzantineTrainer`` in the paper's Fig. 4 setting (30
   honest + 9 Byzantine workers, ``omniscient_linf`` with the closed-form
   gamma, "anti" direction, margin 0.8, SGD with ``fading_lr(0.3, 1e4)``,
   16 samples per worker) with ``fused-bulyan-krum``: 40 steps on the
   MNIST MLP and 5 on the CIFAR CNN, at their published widths, from
   seeded random weights.  Launch counters are reset just before each
   model's run and read just after; every step must launch K1, select
   and K4 once each, and K5's count is the sum of those three.  Step 0's aggregate must match the plain path at 1e-4.
   Final eval accuracy of clean ``average``, attacked ``fused-krum`` and
   attacked ``fused-bulyan-krum`` on the MLP, for a reader.
4. One JSON line of per-kernel measurements, then the result line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
#: (non-tensor-core) FLOP/s, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
#: the H100's L2 cache (50 MB)
L2_BYTES = 50 * 2 ** 20

FP32_TOL = 1e-4
BF16_TOL = 5e-2
N_MAIN, F_MAIN = 39, 9
D_MLP, D_CNN = 79_510, 486_346
LINF = (("gar_name", "krum"), ("gamma", "closed"), ("direction", "anti"),
        ("margin", 0.8))
ETA0 = 0.3

#: where each kernel of the port comes from in the JAX package
REPLACES = {
    "pairwise_gram_partial": "src/repro/kernels/pairwise_gram.py:46",
    "select_weights": "src/repro/kernels/fused_agg.py:164",
    "fused_coordinate": "src/repro/kernels/fused_agg.py:380",
    "fused_aggregate": "src/repro/kernels/fused_agg.py:271",
}
SOURCES = {
    "pairwise_gram_partial": "src/repro_torch/csrc/pairwise_gram.cu",
    "select_weights": "src/repro_torch/csrc/fused_agg.cu",
    "fused_coordinate": "src/repro_torch/csrc/fused_agg.cu",
    "fused_aggregate": "src/repro_torch/csrc/fused_agg.cu",
}


class CheckFailed(Exception):
    """A comparison or a contract of this script did not hold."""


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def rel_err(got, want) -> tuple:
    """(max abs error, max abs error over max(1, max |want|))."""
    got = got.double()
    want = want.double()
    if want.numel() == 0:
        return 0.0, 0.0
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else (
            f"nvidia-smi gave nothing: {out.stderr.strip()}")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Per-call device time with CUDA events, L2 flushed before each call
    (a 96 MB write evicts the H100's 50 MB L2), so every call finds its
    inputs in device memory as the training step does for the stack."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(24 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def bound(n: int, d: int, f: int, kernel: str, elem: int) -> dict:
    """Least time the card could take for one kernel in ``bulyan-krum``
    mode: the larger of the bytes the function must move over the memory
    rate and its fp32 operations over the fp32 peak.

    Bytes: each input read once, each output written once.  Bulyan-krum's
    weights are one-hot, so the combine is a gather of the theta = n - 2f
    picked rows, and K4 needs only those.  K5 reads the whole stack for
    the Gram and then the picked rows again: the selection needs every
    row's distances before the combine can start, so that second read
    comes from HBM when the stack exceeds the L2 cache.

    Operations: the Gram's symmetric half and diagonal, n (n + 1) d (a
    multiply-add counts 2); the selection's theta rounds of column sorts;
    per coordinate, the sort of theta values (theta (theta - 1) / 2
    compare-exchanges) and the window's 4 theta adds.  The gather does
    no arithmetic.
    """
    theta = n - 2 * f
    stack, picked = n * d * elem, theta * d * elem
    sel_ops = theta * n * (n * (n - 1) // 2 + n)
    window_ops = d * (theta * (theta - 1) // 2 + 4 * theta)
    gram_ops = n * (n + 1) * d
    if kernel == "pairwise_gram_partial":
        nbytes, ops = stack + n * n * 4, gram_ops
    elif kernel == "select_weights":
        nbytes, ops = n * n * 4 + (theta * n + 2 * n) * 4, sel_ops
    elif kernel == "fused_coordinate":
        nbytes, ops = picked + theta * n * 4 + d * 4, window_ops
    else:
        reread = picked if stack > L2_BYTES else 0
        nbytes = stack + reread + d * 4 + 2 * n * 4
        ops = gram_ops + sel_ops + window_ops
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_stack(torch, n, d, f, dtype, seed):
    """Gradient-like rows: n - f honest rows and f identical Byzantine
    rows just off their mean (the attack's shape: ties among them)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g) * 0.5 + 1.0
    if f:
        x[n - f:] = x[:n - f].mean(dim=0) + 0.05
    return x.to(device="cuda", dtype=dtype).contiguous()


def check_case(torch, ops, n, f, d, dtype, seed, worst):
    fa, pg = ops["fused_agg"], ops["pairwise_gram"]
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    tag = f"n={n} f={f} d={d} {str(dtype).split('.')[-1]}"
    x = make_stack(torch, n, d, f, dtype, seed)

    def note(kernel, err):
        worst[kernel] = max(worst.get(kernel, 0.0), err)

    raw = pg.pairwise_gram_partial(x)
    raw_plain = pg.pairwise_gram_partial_plain(x)
    err, rel = rel_err(raw, raw_plain)
    expect(rel <= tol, f"K1 {tag}: rel err {rel:.3e} > {tol}")
    note("pairwise_gram_partial", err)
    for mode in fa.FUSED_MODES:
        mtag = f"{mode} {tag}"
        if mode in fa.DIST_MODES:
            w, sel, sc = fa.select_weights(raw, n, f, mode)
            wp, selp, scp = fa.select_weights_plain(raw, n, f, mode)
            expect(torch.equal(w, wp), f"select weights differ: {mtag}")
            expect(torch.equal(sel, selp), f"select selected differ: {mtag}")
            err, rel = rel_err(sc, scp)
            expect(rel <= FP32_TOL, f"select scores {mtag}: {rel:.3e}")
            note("select_weights", err)
        else:
            wp = None
        got = fa.fused_coordinate(x, wp, f, mode=mode)
        want = fa.fused_coordinate_plain(x, wp, f, mode=mode)
        err, rel = rel_err(got, want)
        expect(rel <= tol, f"K4 {mtag}: rel err {rel:.3e} > {tol}")
        note("fused_coordinate", err)
        agg, sel, sc = fa.fused_aggregate(x, f, mode=mode)
        aggp, selp, scp = fa.fused_aggregate_plain(x, f, mode=mode)
        err, rel = rel_err(agg, aggp)
        expect(rel <= tol, f"K5 {mtag}: rel err {rel:.3e} > {tol}")
        expect(torch.equal(sel, selp), f"K5 selected differ: {mtag}")
        note("fused_aggregate", err)
        # K5 == K1 + select + K4, bit for bit
        if mode in fa.DIST_MODES:
            raw2 = pg.pairwise_gram_partial(x)
            w2, sel2, sc2 = fa.select_weights(raw2, n, f, mode)
            agg2 = fa.fused_coordinate(x, w2, f, mode=mode)
            same = (torch.equal(agg, agg2) and torch.equal(sel, sel2[0])
                    and torch.equal(sc, sc2[0]))
        else:
            same = torch.equal(agg, fa.fused_coordinate(x, None, f,
                                                        mode=mode))
        expect(same, f"K5 != K1 + select + K4: {mtag}")
    torch.cuda.synchronize()


def phase_kernels(torch, ops):
    cases = [(N_MAIN, F_MAIN, D_MLP), (N_MAIN, F_MAIN, D_CNN)]
    cases += [(N_MAIN, F_MAIN, d) for d in (1, 129, 4097)]
    cases += [(7, 1, 4097), (38, 8, 4097), (64, 15, 4097)]
    worst = {}
    seed = 0
    for n, f, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            check_case(torch, ops, n, f, d, dtype, seed, worst)
            print(f"  ok  n={n:2d} f={f:2d} d={d:7d} "
                  f"{str(dtype).split('.')[-1]:8s} all 7 modes", flush=True)
    return worst


def time_kernels(torch, ops, d, timer):
    """Per-call ms of each kernel, its plain version and a yardstick, at
    the main path's shape (n = 39, f = 9, fp32, bulyan-krum)."""
    fa, pg = ops["fused_agg"], ops["pairwise_gram"]
    n, f, mode = N_MAIN, F_MAIN, "bulyan-krum"
    x = make_stack(torch, n, d, f, torch.float32, 99)
    raw = pg.pairwise_gram_partial(x)
    w = fa.select_weights(raw, n, f, mode)[0]
    table = {
        "pairwise_gram_partial": (
            lambda: pg.pairwise_gram_partial(x),
            lambda: pg.pairwise_gram_partial_plain(x),
            lambda: torch.mm(x, x.T)),
        "select_weights": (
            lambda: fa.select_weights(raw, n, f, mode),
            lambda: fa.select_weights_plain(raw, n, f, mode), None),
        "fused_coordinate": (
            lambda: fa.fused_coordinate(x, w, f, mode=mode),
            lambda: fa.fused_coordinate_plain(x, w, f, mode=mode), None),
        "fused_aggregate": (
            lambda: fa.fused_aggregate(x, f, mode=mode),
            lambda: fa.fused_aggregate_plain(x, f, mode=mode), None),
    }
    out = {}
    for name, (kern, plain, lib) in table.items():
        out[name] = {"ms": timer.ms(kern, 20),
                     "plain_ms": timer.ms(plain, 3, warmup=1),
                     "library_ms": None if lib is None else timer.ms(lib,
                                                                     20)}
        out[name].update(bound(n, d, f, name, 4))
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def run_model(torch, rt, kind, steps, runs):
    simple, tr, fa = rt["simple"], rt["trainer"], rt["fused_agg"]
    build = rt["build"]
    if kind == "mnist":
        params = simple.init_mnist_mlp(seed=1, device="cuda")
        fwd = simple.mnist_mlp_forward
    else:
        params = simple.init_cifar_cnn(seed=1, device="cuda")
        fwd = simple.cifar_cnn_forward

    def loss(p, x, y):
        return simple.classification_loss(fwd(p, x), y, p)

    spec = rt["AggSpec"](n_workers=N_MAIN, f=F_MAIN,
                         gar="fused-bulyan-krum", attack="omniscient_linf",
                         attack_kwargs=LINF)
    opt = rt["get_optimizer"]("sgd", rt["fading_lr"](ETA0, 1e4))
    batcher = rt["ByzantineBatcher"](kind, N_MAIN - F_MAIN, 16, seed=1,
                                     noise=0.5)
    trainer = tr.ByzantineTrainer(loss, params, opt, spec, seed=1,
                                  device="cuda")

    # step 0's aggregate on the kernels against the plain path (these
    # comparison launches happen before the counters are reset)
    x0, y0 = batcher.batch(0)
    x0 = torch.as_tensor(x0, device="cuda")
    y0 = torch.as_tensor(y0, device="cuda").long()
    full, _, ctx = tr.byzantine_stack(loss, spec, trainer.params, x0, y0)
    agg_k, sel_k, _ = fa.fused_aggregate(full, F_MAIN, mode="bulyan-krum")
    agg_p, sel_p, _ = fa.fused_aggregate_plain(full, F_MAIN,
                                               mode="bulyan-krum")
    err, rel = rel_err(agg_k, agg_p)
    expect(rel <= FP32_TOL, f"{kind} step-0 aggregate: rel err {rel:.3e}")
    expect(torch.equal(sel_k, sel_p), f"{kind} step-0 selection differs")
    # SGD's first step with eta(0) = ETA0 and the plain path's aggregate
    step0 = rt["unflatten"](agg_p, ctx)
    expected = {k: v - ETA0 * step0[k] for k, v in trainer.params.items()}
    print(f"  {kind}: d={full.shape[1]} step-0 aggregate kernel vs plain "
          f"max abs err {err:.3e} (rel {rel:.3e}), selected "
          f"{sel_k.tolist()}", flush=True)

    torch.cuda.synchronize()
    build.reset_launches()
    step_ms = []
    for t in range(steps):
        t0 = time.perf_counter()
        trainer.run(batcher, 1, start_step=t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        h = trainer.history[-1]
        if t == 0:
            for k, v in expected.items():
                e, r = rel_err(trainer.params[k], v)
                expect(r <= FP32_TOL, f"{kind} step-0 update of {k}: {r:.3e}")
        print(f"  {kind} step {t:2d} loss {h['loss']:.6f} byz_weight "
              f"{h['byz_weight']:.1f} agg_dev {h['agg_dev']:.6f} "
              f"{step_ms[-1]:.3f} ms", flush=True)
        expect(math.isfinite(h["loss"]), f"{kind} loss not finite")
    counts = dict(build.LAUNCHES)
    for name in REPLACES:
        # K5 counts the K1, select and K4 launches it made
        want = 3 * steps if name == "fused_aggregate" else steps
        expect(counts[name] == want,
               f"{kind}: {name} launched {counts[name]} times in {steps} "
               f"steps, expected {want}")
    for k, v in trainer.params.items():
        expect(bool(torch.isfinite(v).all()), f"{kind} param {k} not finite")
    print(f"  {kind}: launches {counts}; median step "
          f"{sorted(step_ms)[len(step_ms) // 2]:.3f} ms", flush=True)
    runs[kind] = {"launches": counts, "step_ms": step_ms}

    prof = profile_steps(torch, trainer, batcher, steps, 3)
    if prof["device_ms"] > 0:
        print(f"  {kind} profile of 3 more steps: wall "
              f"{prof['wall_ms']:.3f} ms, device busy "
              f"{prof['device_ms'] / prof['wall_ms']:.3f}, aggregation "
              f"kernels {prof['agg_ms'] / prof['wall_ms']:.3f} of wall",
              flush=True)
        for ms, count, key in prof["top"]:
            print(f"    {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    else:
        print(f"  {kind} profile: the profiler recorded no device time "
              f"(device busy share not measured)", flush=True)
    return trainer


#: the port's kernels as the profiler names them
PORT_KERNELS = ("gram_partial_kernel", "gram_reduce_kernel", "select_kernel",
                "combine_kernel")


def profile_steps(torch, trainer, batcher, start: int, steps: int) -> dict:
    """Device time by kernel over a few steady steps (torch.profiler).

    Returns the window's wall ms, the device busy share (kernel time over
    wall time) and the share of the port's aggregation kernels; the
    profiler's own overhead is inside the wall time.
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(batcher, steps, start_step=start)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    agg_ms = sum(r[0] for r in rows if any(k in r[2] for k in PORT_KERNELS))
    return {"wall_ms": wall_ms, "steps": steps, "device_ms": device_ms,
            "agg_ms": agg_ms, "top": rows[:10]}


def eval_acc(torch, rt, params):
    xe, ye = rt["mnist_like"](1000, 10 ** 6, seed=0, noise=0.5)
    xe = torch.as_tensor(xe, device="cuda")
    ye = torch.as_tensor(ye, device="cuda")
    with torch.no_grad():
        return float(rt["simple"].accuracy(
            rt["simple"].mnist_mlp_forward(params, xe), ye))


def mlp_accuracies(torch, rt, bulyan_trainer):
    simple = rt["simple"]

    def loss(p, x, y):
        return simple.classification_loss(simple.mnist_mlp_forward(p, x),
                                          y, p)

    accs = {"attacked fused-bulyan-krum": eval_acc(torch, rt,
                                                   bulyan_trainer.params)}
    for label, kw, n_h in (
            ("clean average", dict(n_workers=30, f=0, gar="average"), 30),
            ("attacked fused-krum",
             dict(n_workers=N_MAIN, f=F_MAIN, gar="fused-krum",
                  attack="omniscient_linf", attack_kwargs=LINF), 30)):
        trainer = rt["trainer"].ByzantineTrainer(
            loss, simple.init_mnist_mlp(seed=1, device="cuda"),
            rt["get_optimizer"]("sgd", rt["fading_lr"](ETA0, 1e4)),
            rt["AggSpec"](**kw), seed=1, device="cuda")
        trainer.run(rt["ByzantineBatcher"]("mnist", n_h, 16, seed=1,
                                           noise=0.5), 40)
        accs[label] = eval_acc(torch, rt, trainer.params)
    return accs


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.agg.specs import AggSpec
    from repro_torch.core.pytree import unflatten
    from repro_torch.data.synthetic import ByzantineBatcher, mnist_like
    from repro_torch.kernels import _build, fused_agg, pairwise_gram
    from repro_torch.models import simple
    from repro_torch.optim import fading_lr, get_optimizer
    from repro_torch.training import trainer
    rt = dict(simple=simple, trainer=trainer, fused_agg=fused_agg,
              build=_build, AggSpec=AggSpec, unflatten=unflatten,
              ByzantineBatcher=ByzantineBatcher, mnist_like=mnist_like,
              fading_lr=fading_lr, get_optimizer=get_optimizer)
    ops = {"fused_agg": fused_agg, "pairwise_gram": pairwise_gram}

    print("== phase 1: build", flush=True)
    secs = _build.build_all()
    print(f"  built the CUDA kernels in {secs:.1f} s", flush=True)
    for log in sorted((_build._BUILD).glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")

    print("== phase 2: kernels vs plain versions", flush=True)
    worst = phase_kernels(torch, ops)
    timer = Timer(torch)
    timings = {"mlp": time_kernels(torch, ops, D_MLP, timer),
               "cnn": time_kernels(torch, ops, D_CNN, timer)}
    for model, rows in timings.items():
        for name, r in rows.items():
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.1f}")
            print(f"  {model} {name:22s} kernel {r['ms'] * 1e3:9.1f} us  "
                  f"plain {r['plain_ms'] * 1e3:10.1f} us  library "
                  f"{lib} us  bound {r['bound_ms'] * 1e3:.1f} us "
                  f"({r['bound_by']})", flush=True)

    print("== phase 3: main path (Fig. 4, fused-bulyan-krum)", flush=True)
    runs = {}
    mlp_trainer = run_model(torch, rt, "mnist", 40, runs)
    run_model(torch, rt, "cifar", 5, runs)
    accs = mlp_accuracies(torch, rt, mlp_trainer)
    for label, acc in accs.items():
        print(f"  MLP eval accuracy after 40 steps, {label}: {acc:.4f}")

    kernels = []
    for model, kind in (("mlp", "mnist"), ("cnn", "cifar")):
        for name, r in timings[model].items():
            kernels.append({
                "name": f"{name}@{model}", "route": "cuda",
                "source": SOURCES[name], "replaces": REPLACES[name],
                "launches": runs[kind]["launches"][name],
                "max_abs_err": worst[name], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report the phase that failed, never print ok
        traceback.print_exc()
        sys.exit(1)
