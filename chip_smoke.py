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
   plus edges d in {1, 2, 3, 129, 4097} and n in {7, 38, 64}, fp32
   (tolerance 1e-4 relative) and bf16 (5e-2).  K1's output must equal its
   transpose and a second call bit for bit.  Selections (weights,
   selected and scores) must be exactly equal, with NaN in the same
   places, and K5 must equal K1 + select + K4 bit for bit.  The selection
   also runs at n in {3, 4, 7, 38, 64} with the largest f each mode's
   quorum allows, and a stack with one NaN coordinate goes through the
   selection in all five distance modes and through K5.  K2
   (``bulyan_select``) at theta = 21, f = 9 and K3 (``coord_stats``) at n = 39, f = 9 at both
   widths, plus d in {1, 129, 4097}, theta in {3, 64}, n in {3, 38, 64}
   and a NaN-bearing column; K2 also with theta in every size bucket of
   its register sort and at its edges (d = 4097, two f each) on columns
   holding NaN, +inf, -inf, both infinities and -0.0, with NaN and the
   infinities in the plain version's places; for K2 in bf16 a coordinate
   may instead be any window mean that is optimal under a tie.  K4 on stacks holding
   inf, NaN and -0.0 (the reference's 0 * x rule) with the selection's,
   all-zero, convex and duplicated weights, in all 7 modes, fp32 and
   bf16, at d = 4097 and both widths.  Times per call of each kernel
   (K4 also in ``cwmed`` mode, beside K3), its plain version and one
   PyTorch call as a yardstick (``torch.mm(x, x.T)``, "Gram only", for
   K1; ``torch.sort``, "sort only", for K2, K3 and K4 ``cwmed``), with
   CUDA events.
3. The main path: ``ByzantineTrainer`` in the paper's Fig. 4 setting (30
   honest + 9 Byzantine workers, ``omniscient_linf`` with the closed-form
   gamma, "anti" direction, margin 0.8, SGD with ``fading_lr(0.3, 1e4)``,
   16 samples per worker) with ``fused-bulyan-krum``: 40 steps on the
   MNIST MLP and 5 on the CIFAR CNN, at their published widths, from
   seeded random weights.  Launch counters are reset just before each
   model's run and read just after; every step must launch K1, select
   and K4 once each (K2 and K3 not at all), and K5's count is the sum
   of those three.  Step 0's aggregate must match the plain path at
   1e-4.
   Final eval accuracy of clean ``average``, attacked ``fused-krum`` and
   attacked ``fused-bulyan-krum`` on the MLP, for a reader.
3b. Stateful and asynchronous training, same attack and optimizer:
   ``AsyncByzantineTrainer`` (``fixed`` schedule, tau = 2) with
   ``stale-fused-bulyan-krum`` (10 MLP steps, 3 CNN steps) and
   ``reputation-fused-bulyan-krum`` (10 MLP steps), ``ByzantineTrainer``
   with ``buffered-fused-cwmed`` (window 4, 10 MLP steps), and the
   paper's Fig. 2 / 3 Brute setting (``brute``, 6 + 5 workers,
   ``omniscient_linf`` aimed at Brute; 10 MLP steps, 3 CNN steps).  Step
   0's aggregate must match the same composite over the unfused rule on
   the card (Brute: its CPU result) at 1e-4 of its largest entry, with
   equal ``selected``, and the first update must be SGD's on it; the
   launch counters, reset before each run, must read exactly the
   launches per step the rule implies (``STEP_LAUNCHES``).  Then three
   identities, bit for bit: uniform reputation and uniform staleness
   reproduce ``fused-bulyan-krum``, and the asynchronous trainer at
   tau = 0 reproduces the synchronous one over 3 steps.  ms per step of
   each run, with the card's name and power limit.
4. The tree engine at full width: the Fig. 4 submissions of both models
   as per-leaf trees (30 ``vmap(grad)`` gradients, then the port's
   ``inject_byzantine`` with ``omniscient_linf``), aggregated by
   ``distributed_aggregate`` (through ``AggSpec.aggregate_tree``) with 8
   rules under the ``xla``, ``pallas`` and ``fused`` backends.  Each
   result must match the dense rule on ``stack_flatten`` of the same
   tree at 1e-4 of its largest entry, with equal ``selected``,
   and each aggregation must launch exactly the kernels its backend
   implies (launch counters reset just before it and read just after).
   Then the kernel-pair route (K1, phase 1 in PyTorch, K2) against
   ``fused-bulyan-krum``, and K3 against the engine's cwmed and
   trimmed_mean, counted the same way.  ms per aggregation per backend.
5. The fp32-accumulation contract on the card: the three probes in bf16
   at d in {512, 1536} and both model widths, each <= 1e-4, and a bf16
   tree through ``"auto"`` and ``"fused"`` within 1e-2 of the flat fp32
   rule with its leaf dtypes kept.
6. The device time of each timed kernel and yardstick, from
   ``torch.profiler`` over launches timed as in phase 2, the
   event and device time of ``x.sum(dim=0)`` over the (39, d) stack, a
   yardstick of reading the stack column by column, K2's device time
   beside three reads of its (21, d) stack (K4 in ``cwmed`` and ``krum``
   mode, ``x.sum(dim=0)``), and the selection's
   event and device time in each of its five modes.  It comes last
   because a profiler session leaves later launches slower on the host.
7. One JSON line of per-kernel measurements, then the result line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
import json
import math
import pathlib
import statistics
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
    "bulyan_select": "src/repro/kernels/bulyan_select.py:41",
    "coord_stats": "src/repro/kernels/coord_stats.py:29",
}
SOURCES = {
    "pairwise_gram_partial": "src/repro_torch/csrc/pairwise_gram.cu",
    "select_weights": "src/repro_torch/csrc/fused_agg.cu",
    "fused_coordinate": "src/repro_torch/csrc/fused_agg.cu",
    "fused_aggregate": "src/repro_torch/csrc/fused_agg.cu",
    "bulyan_select": "src/repro_torch/csrc/bulyan_select.cu",
    "coord_stats": "src/repro_torch/csrc/coord_stats.cu",
}
#: K2's theta in every size bucket of the register sort and at its edges
K2_THETAS = (3, 8, 9, 16, 17, 21, 24, 25, 40, 48, 49, 64)
#: the kernels of PR 11's training path (phase 3)
TRAIN_KERNELS = ("pairwise_gram_partial", "select_weights",
                 "fused_coordinate", "fused_aggregate")
#: the rules the tree engine runs (phase 4)
TREE_RULES = ("bulyan-krum", "bulyan-geomed", "krum", "multikrum",
              "geomed", "cwmed", "trimmed_mean", "average")


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


def scaled_err(got, want) -> tuple:
    """(max abs error, max abs error over max |want|, max |want|): a
    relative error that stays relative on small gradients."""
    got = got.double()
    want = want.double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err, err / scale if scale > 0 else err, scale


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

    def device_ms(self, fn, reps: int) -> float:
        """Device time per call of ``fn``'s own kernels (torch.profiler,
        the flush's fill kernel left out), over ``reps`` calls timed as
        :meth:`ms` times them.  A profile that recorded no device time is
        taken once more; 0.0 if that one is empty too."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            us = 0.0
            for ev in prof.key_averages():
                if "FillFunctor" in ev.key:
                    continue
                t = getattr(ev, "self_device_time_total", None)
                us += t if t is not None else getattr(
                    ev, "self_cuda_time_total", 0.0)
            if us > 0:
                break
        return us / 1e3 / reps


def bound(n: int, d: int, f: int, kernel: str, elem: int,
          mode: str = "bulyan-krum") -> dict:
    """Least time the card could take for one kernel at the main path's
    shapes (``bulyan-krum`` mode for the fused kernels unless ``mode``
    says ``cwmed`` or ``krum``): the larger of the bytes the function
    must move over the memory rate and its fp32 operations over the fp32
    peak.

    Bytes: each input read once, each output written once.  Bulyan-krum's
    weights are one-hot, so the combine is a gather of the theta = n - 2f
    picked rows, but K4 must still read all n rows: the reference's
    contraction multiplies every row by its weight, and 0 * inf is NaN,
    so an unselected row that is not finite at a coordinate makes that
    coordinate NaN.  K4 reads the (n, d) stack and the (theta, n)
    weights (one row in ``krum`` mode) and writes d floats.  K5 reads the whole stack for the Gram
    and then again for the combine: the selection needs every row's
    distances before the combine can start, so that second read comes
    from HBM when the stack exceeds the L2 cache.  K2 reads the (theta, d)
    picked stack and writes d floats; K3 reads the (n, d) stack and
    writes two d-float outputs; K4 in ``cwmed`` mode reads the stack and
    writes one.

    Operations: the Gram's symmetric half and diagonal, n (n + 1) d (a
    multiply-add counts 2); a sort of m values, m (m - 1) (a
    compare-exchange is a min and a max); the selection's one sort of
    each column's n - 1 off-diagonal entries and, in each of its theta
    rounds, every column's k = max(1, n - t - f - 2) neighbour sums (the
    distances do not change between rounds); per coordinate, the sort of
    theta values and the window's 4 theta adds (K4 and K2), or the sort
    of n values, the trimmed sum's n - 2f adds and the median's 2
    operations (K3), or the sort of n values and the median's 2 (K4 in
    ``cwmed`` mode).  The gather does no arithmetic, so K4 in ``krum``
    mode does none.
    """
    theta = n - 2 * f
    stack, picked = n * d * elem, theta * d * elem
    sel_ops = n * (n - 1) * (n - 2) + sum(
        n * max(1, n - t - f - 2) for t in range(theta))
    window_ops = d * (theta * (theta - 1) + 4 * theta)
    gram_ops = n * (n + 1) * d
    if kernel == "pairwise_gram_partial":
        nbytes, ops = stack + n * n * 4, gram_ops
    elif kernel == "select_weights":
        nbytes, ops = n * n * 4 + (theta * n + 2 * n) * 4, sel_ops
    elif kernel == "fused_coordinate" and mode == "cwmed":
        nbytes, ops = stack + d * 4, d * (n * (n - 1) + 2)
    elif kernel == "fused_coordinate" and mode == "krum":
        nbytes, ops = stack + n * 4 + d * 4, 0
    elif kernel == "fused_coordinate":
        nbytes, ops = stack + theta * n * 4 + d * 4, window_ops
    elif kernel == "bulyan_select":
        nbytes, ops = picked + d * 4, window_ops
    elif kernel == "coord_stats":
        nbytes = stack + 2 * d * 4
        ops = d * (n * (n - 1) + (n - 2 * f) + 2)
    else:
        reread = stack if stack > L2_BYTES else 0
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
    expect(torch.equal(raw, raw.T), f"K1 {tag}: not exactly symmetric")
    expect(torch.equal(raw, pg.pairwise_gram_partial(x)),
           f"K1 {tag}: a second call differs")
    note("pairwise_gram_partial", err)
    for mode in fa.FUSED_MODES:
        mtag = f"{mode} {tag}"
        if mode in fa.DIST_MODES:
            wp = check_select(torch, fa, raw, n, f, mode, mtag)
            note("select_weights", 0.0)
        else:
            wp = None
        got = fa.fused_coordinate(x, wp, f, mode=mode)
        want = fa.fused_coordinate_plain(x, wp, f, mode=mode)
        err, rel = rel_err(got, want)
        expect(rel <= tol, f"K4 {mtag}: rel err {rel:.3e} > {tol}")
        note("fused_coordinate", err)
        if mode in ("cwmed", "krum"):
            note(f"fused_coordinate:{mode}", err)
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


def same_nan(torch, got, want) -> bool:
    """Equal values with NaN in the same places."""
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))


def check_select(torch, fa, raw, n, f, mode, tag):
    """The selection kernel against its plain version: weights, selected
    and scores exactly equal, NaN in the same places.  Returns the plain
    weights."""
    got = fa.select_weights(raw, n, f, mode)
    want = fa.select_weights_plain(raw, n, f, mode)
    for what, g, w in zip(("weights", "selected", "scores"), got, want):
        expect(same_nan(torch, g, w), f"select {what} differ: {tag}")
    return want[0]


def max_f(n: int, mode: str) -> int:
    """The largest f the mode's quorum allows (``_check_mode_shape``)."""
    if mode.startswith("bulyan"):
        return (n - 3) // 4
    if mode in ("krum", "multikrum"):
        return n - 3
    return n - 1


def phase_select_edges(torch, ops):
    """The selection at the quorum edges, and a stack with one NaN
    coordinate through the selection and K5."""
    fa, pg = ops["fused_agg"], ops["pairwise_gram"]
    for n in (3, 4, 7, 38, 64):
        for mode in fa.DIST_MODES:
            f = max_f(n, mode)
            x = make_stack(torch, n, 257, min(f, n - 1), torch.float32, n)
            check_select(torch, fa, pg.pairwise_gram_partial(x), n, f, mode,
                         f"{mode} n={n} f={f}")
        print(f"  ok  select n={n:2d} at each mode's largest f", flush=True)
    n, f = N_MAIN, F_MAIN
    x = make_stack(torch, n, 4097, f, torch.float32, 77)
    x[n - 1, 7] = float("nan")
    raw = pg.pairwise_gram_partial(x)
    for mode in fa.FUSED_MODES:
        tag = f"{mode} NaN-bearing stack"
        if mode in fa.DIST_MODES:
            check_select(torch, fa, raw, n, f, mode, tag)
        agg, sel, sc = fa.fused_aggregate(x, f, mode=mode)
        aggp, selp, scp = fa.fused_aggregate_plain(x, f, mode=mode)
        expect(torch.equal(sel, selp) and same_nan(torch, sc, scp),
               f"K5 selected / scores differ: {tag}")
        expect(torch.equal(torch.isnan(agg), torch.isnan(aggp)),
               f"K5 NaN pattern differs: {tag}")
        ok = ~torch.isnan(aggp)
        err, rel = rel_err(agg[ok], aggp[ok])
        expect(rel <= FP32_TOL, f"K5 {tag}: rel err {rel:.3e}")
    print("  ok  a NaN-bearing stack through the selection (5 modes) and "
          "K5 (7 modes)", flush=True)


def k4_cases(torch, base, w, mw, f, mode, cols):
    """K4's non-finite contract on a finite stack: (label, stack, weights,
    check of the output at ``cols`` or None) per case.  ``w`` is the
    mode's selection from the plain version (None for the coordinate
    modes), ``mw`` multikrum's convex row."""
    n = base.shape[0]
    half = cols[: len(cols) // 2], cols[len(cols) // 2:]
    inf, nan = float("inf"), float("nan")

    def put(*entries):
        x = base.clone()
        for row, where, v in entries:
            x[row, where] = v
        return x

    if w is None:  # cwmed, trimmed_mean: rows only
        return [("inf in one row", put((0, cols, inf)), None, None),
                ("inf in f + 1 rows", put((slice(0, f + 1), cols, inf)),
                 None, None),
                ("-inf and NaN", put((1, half[0], -inf), (2, half[1], nan)),
                 None, lambda g: bool(torch.isnan(g[half[1]]).all())),
                ("-0.0 in every row", put((slice(None), cols, -0.0)), None,
                 lambda g: bool((g[cols] == 0).all()))]
    used = (w != 0).any(dim=0)
    picked = int(torch.nonzero(w[0]).flatten()[0])
    unsel = int(torch.nonzero(~used).flatten()[0])
    one_hot = mode in ("krum", "geomed")
    all_nan = lambda g: bool(torch.isnan(g[cols]).all())  # noqa: E731
    general = mw.expand(w.shape[0], n).contiguous()
    twice = w.clone()
    twice[-1] = w[0]
    return [
        ("inf in an unselected row", put((unsel, cols, inf)), w, all_nan),
        ("inf in a picked row", put((picked, cols, inf)), w,
         (lambda g: bool(torch.isposinf(g[cols]).all())) if one_hot
         else None),
        ("NaN in an unselected and a picked row",
         put((unsel, half[0], nan), (picked, half[1], nan)), w, all_nan),
        ("-0.0 in a picked row", put((picked, cols, -0.0)), w,
         (lambda g: bool((g[cols] == 0).all() and
                         not torch.signbit(g[cols]).any())) if one_hot
         else None),
        ("all-zero weights", put((unsel, cols, inf)), torch.zeros_like(w),
         lambda g: all_nan(g) and int(torch.count_nonzero(
             torch.nan_to_num(g))) == 0),
        ("multikrum's convex weights",
         put((unsel, half[0], inf), (picked, half[1], -inf)), general,
         None),
        ("a row picked twice", put((picked, half[0], inf)), twice, None),
    ]


def phase_k4_nonfinite(torch, ops, worst):
    """K4 against its plain version on stacks holding inf, NaN and -0.0,
    with the selection's weights, all-zero weights, multikrum's convex
    row and a row picked twice, in all 7 modes, fp32 and bf16, at
    d = 4097 and both models' widths: NaN in the same places, the rest
    within tolerance, and the reference's 0 * x rule where it fixes the
    value."""
    fa, pg = ops["fused_agg"], ops["pairwise_gram"]
    n, f = N_MAIN, F_MAIN
    for d in (4097, D_MLP, D_CNN):
        cols = torch.tensor(sorted({0, 1, 2, 3, d // 2, d - 2, d - 1}),
                            device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            name = str(dtype).split(".")[-1]
            base = make_stack(torch, n, d, f, dtype, 500 + d % 97)
            raw = pg.pairwise_gram_partial_plain(base)
            mw = fa.select_weights_plain(raw, n, f, "multikrum")[0]
            cases = 0
            for mode in fa.FUSED_MODES:
                w = (None if mode in fa.COORD_MODES
                     else fa.select_weights_plain(raw, n, f, mode)[0])
                for label, x, wc, at_cols in k4_cases(torch, base, w, mw, f,
                                                      mode, cols):
                    what = f"K4 {mode} d={d} {name}: {label}"
                    got = fa.fused_coordinate(x, wc, f, mode=mode)
                    want = fa.fused_coordinate_plain(x, wc, f, mode=mode)
                    torch.cuda.synchronize()
                    err, bad = compare_nan(torch, got, want, tol, what)
                    expect(not bool(bad.any()), f"{what}: {int(bad.sum())} "
                           f"coordinates off the plain version")
                    expect(at_cols is None or at_cols(got),
                           f"{what}: {got[cols].tolist()} breaks the "
                           f"reference's 0 * x rule")
                    worst["fused_coordinate"] = max(
                        worst.get("fused_coordinate", 0.0), float(err.max()))
                    cases += 1
            print(f"  ok  K4 non-finite contract d={d:7d} {name:8s} "
                  f"{cases} cases, 7 modes", flush=True)


def phase_kernels(torch, ops):
    cases = [(N_MAIN, F_MAIN, D_MLP), (N_MAIN, F_MAIN, D_CNN)]
    cases += [(N_MAIN, F_MAIN, d) for d in (1, 2, 3, 129, 4097)]
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
    the main path's shape (n = 39, f = 9, fp32, bulyan-krum), and of K4
    in ``krum`` mode: a gather of one row that sorts nothing, so its
    time is that of reading the stack.  Its yardstick ``wk @ x`` is the
    one PyTorch call that computes the same function (the (1, n) one-hot
    row times the stack, 0 * inf = NaN included); the port never calls
    it."""
    fa, pg = ops["fused_agg"], ops["pairwise_gram"]
    n, f, mode = N_MAIN, F_MAIN, "bulyan-krum"
    x = make_stack(torch, n, d, f, torch.float32, 99)
    raw = pg.pairwise_gram_partial(x)
    w = fa.select_weights(raw, n, f, mode)[0]
    wk = fa.select_weights(raw, n, f, "krum")[0]
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
        "fused_coordinate:krum": (
            lambda: fa.fused_coordinate(x, wk, f, mode="krum"),
            lambda: fa.fused_coordinate_plain(x, wk, f, mode="krum"),
            lambda: wk @ x),
    }
    return timed(timer, table, n, d, f)


def timed(timer, table, n, d, f) -> dict:
    """Event ms per call of each kernel, its plain version and its
    yardstick, beside the kernel's bound.  The kernel and the yardstick
    are kept under "calls" for :func:`device_times`.  A name
    ``kernel:mode`` times a kernel in another mode than the main path's."""
    out = {}
    for name, (kern, plain, lib) in table.items():
        kernel, _, mode = name.partition(":")
        out[name] = {"ms": timer.ms(kern, 20),
                     "plain_ms": timer.ms(plain, 3, warmup=1),
                     "library_ms": None if lib is None else timer.ms(lib,
                                                                     20),
                     "calls": (kern, lib)}
        out[name].update(bound(n, d, f, kernel, 4, mode or "bulyan-krum"))
    return out


def time_select_modes(torch, ops, timer) -> None:
    """Event and device ms per call of the selection in each distance
    mode at n = 39, f = 9 (the selection does not depend on d)."""
    fa, pg = ops["fused_agg"], ops["pairwise_gram"]
    raw = pg.pairwise_gram_partial(make_stack(torch, N_MAIN, 4097, F_MAIN,
                                              torch.float32, 96))
    for mode in fa.DIST_MODES:
        fn = (lambda m: lambda: fa.select_weights(raw, N_MAIN, F_MAIN,
                                                  m))(mode)
        print(f"  select {mode:13s} event {timer.ms(fn, 20) * 1e3:7.1f} us  "
              f"device {timer.device_ms(fn, 20) * 1e3:7.1f} us", flush=True)


def read_yardstick(torch, timer) -> None:
    """Event and device time of ``x.sum(dim=0)`` over the main path's
    (39, d) fp32 stack at both widths: one PyTorch call that reads the
    whole stack once, column by column, as K3 and K4 do."""
    for model, d in (("mlp", D_MLP), ("cnn", D_CNN)):
        x = make_stack(torch, N_MAIN, d, F_MAIN, torch.float32, 95)
        event = timer.ms(lambda: x.sum(dim=0), 20) * 1e3
        us = timer.device_ms(lambda: x.sum(dim=0), 20) * 1e3
        device = (f"device {us:.1f} us ({N_MAIN * d * 4 / us / 1e6:.2f} "
                  f"TB/s)" if us > 0 else "device time not recorded")
        print(f"  {model} read yardstick x.sum(dim=0): event {event:.1f} us, "
              f"{device}", flush=True)


def k2_yardsticks(torch, ops, timer) -> None:
    """Device time of K2 beside three reads of its (21, d) stack at both
    widths: K4 in ``cwmed`` mode (K2's kernel with the median in place of
    Bulyan's window: the load and the sort), K4 in ``krum`` mode (a
    gather of one row that reads every row and sorts nothing) and
    ``x.sum(dim=0)`` (one PyTorch call that reads the stack column by
    column): what K2's read, sort and window each cost."""
    bs, fa = ops["bulyan_select"], ops["fused_agg"]
    theta = N_MAIN - 2 * F_MAIN
    for model, d in (("mlp", D_MLP), ("cnn", D_CNN)):
        x = make_stack(torch, theta, d, 0, torch.float32, 98)
        w = torch.zeros((1, theta), device="cuda")
        w[0, 0] = 1.0
        parts = (("K2", lambda: bs.bulyan_select(x, F_MAIN)),
                 ("K4 cwmed", lambda: fa.fused_coordinate(
                     x, None, F_MAIN, mode="cwmed")),
                 ("K4 krum", lambda: fa.fused_coordinate(
                     x, w, F_MAIN, mode="krum")),
                 ("x.sum(dim=0)", lambda: x.sum(dim=0)))
        line = ", ".join(f"{name} {timer.device_ms(fn, 20) * 1e3:.1f}"
                         for name, fn in parts)
        print(f"  {model} K2's ({theta}, {d}) stack, device us: {line}",
              flush=True)


def device_times(timer, timings) -> None:
    """The profiler's device ms per call of each timed kernel and
    yardstick (phase 6).  It runs last: once a profiler session has run,
    later launches in the process pay for its tracing on the host, which
    would slow the step and aggregation times of phases 3 and 4."""
    for model, rows in timings.items():
        for name, r in rows.items():
            kern, lib = r.pop("calls")
            r["device_ms"] = timer.device_ms(kern, 20)
            r["library_device_ms"] = (None if lib is None
                                      else timer.device_ms(lib, 20))
            lib_ms = ("-" if lib is None else
                      f"{r['library_device_ms'] * 1e3:.1f}")
            print(f"  {model} {name:22s} device {r['device_ms'] * 1e3:8.1f} "
                  f"us (event {r['ms'] * 1e3:.1f})  library device "
                  f"{lib_ms} us  bound {r['bound_ms'] * 1e3:.2f} us",
                  flush=True)


def coord_stack(torch, rows, d, dtype, seed, nan_col=None):
    """Unit-normal rows (coordinate-kernel inputs), one NaN if asked."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, d), generator=g)
    if nan_col is not None:
        x[rows // 2, nan_col] = float("nan")
    return x.to(device="cuda", dtype=dtype).contiguous()


def compare_nan(torch, got, want, tol, what):
    """(abs error, mask of coordinates outside tol) after checking that
    NaN and +-inf sit in the same places, the infinities with the same
    signs.  The tolerance scales with max(1, max |want|) over the finite
    coordinates only, so an inf in ``want`` widens nothing."""
    got, want = got.double(), want.double()
    expect(torch.equal(torch.isnan(got), torch.isnan(want)),
           f"{what}: NaN pattern differs")
    inf = torch.isinf(want)
    expect(torch.equal(torch.isinf(got), inf)
           and torch.equal(got[inf], want[inf]), f"{what}: infinities differ")
    fin = torch.isfinite(want)
    zero = torch.zeros_like(want)
    got, want = torch.where(fin, got, zero), torch.where(fin, want, zero)
    err = (got - want).abs()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    return err, err > tol * scale


def tie_optimal(torch, x, f, got):
    """Coordinates where ``got`` is the mean of a window whose deviation
    from the median is optimal under a tie (bf16 ties; the paper's arg min
    is a set), as tests/test_kernels.py accepts."""
    theta = x.shape[0]
    beta = theta - 2 * f
    sv = torch.sort(x.float(), dim=0).values
    med = sv[(theta - 1) // 2]
    wins = range(theta - beta + 1)
    devs = torch.stack([(sv[w:w + beta] - med).abs().sum(0) for w in wins])
    means = torch.stack([sv[w:w + beta].mean(0) for w in wins])
    best = devs.min(0).values
    tie = devs <= best * (1 + 1e-2) + 1e-2
    close = (got[None] - means).abs() <= 1e-2 + 1e-3 * means.abs()
    return (tie & close).any(0)


#: K2's poisoned columns (``check_k2(..., poison=True)``): one +inf, one
#: -inf, a +inf and a -inf, all -0.0, in rows picked at random
K2_POS, K2_NEG, K2_BOTH, K2_NEG_ZERO = 1, 2, 3, 4


def poison_k2(torch, x, seed):
    """K2's poisoned columns in a copy of the (theta, d) stack x."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(x.shape[0], generator=g).tolist()
    x = x.clone()
    x[rows[0], K2_POS] = float("inf")
    x[rows[0], K2_NEG] = -float("inf")
    x[rows[0], K2_BOTH] = float("inf")
    x[rows[1], K2_BOTH] = -float("inf")
    x[:, K2_NEG_ZERO] = -0.0
    return x


def check_k2(torch, bs, theta, f, d, dtype, seed, worst, nan_col=None,
             poison=False):
    """K2 against its plain version; with ``poison`` also on K2's
    poisoned columns, where an inf is not a NaN: a +inf leaves the best
    window once f >= 1 and a -inf gives -inf, as in the reference."""
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    tag = (f"K2 theta={theta} f={f} d={d} {str(dtype).split('.')[-1]}"
           f"{' poisoned' if poison else ''}")
    x = coord_stack(torch, theta, d, dtype, seed, nan_col)
    if poison:
        x = poison_k2(torch, x, seed)
    got = bs.bulyan_select(x, f)
    want = bs.bulyan_select_plain(x, f)
    torch.cuda.synchronize()
    err, bad = compare_nan(torch, got, want, tol, tag)
    if poison:
        expect(float(got[K2_NEG]) == -math.inf, f"{tag}: -inf column gave "
               f"{float(got[K2_NEG])}")
        expect(bool(torch.isfinite(got[K2_POS])) if f
               else float(got[K2_POS]) == math.inf,
               f"{tag}: +inf column gave {float(got[K2_POS])}")
        expect(float(got[K2_NEG_ZERO]) == 0.0, f"{tag}: -0.0 column gave "
               f"{float(got[K2_NEG_ZERO])}")
    if dtype == torch.bfloat16 and bool(bad.any()):
        excused = bad & tie_optimal(torch, x, f, torch.nan_to_num(got))
        bad &= ~excused
        err = torch.where(excused, torch.zeros_like(err), err)
    expect(not bool(bad.any()), f"{tag}: {int(bad.sum())} coordinates "
           f"off the plain version by more than {tol} relative")
    worst["bulyan_select"] = max(worst.get("bulyan_select", 0.0),
                                 float(err.max()))


def check_k3(torch, cs, n, f, d, dtype, seed, worst, nan_col=None):
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    tag = f"K3 n={n} f={f} d={d} {str(dtype).split('.')[-1]}"
    x = coord_stack(torch, n, d, dtype, seed, nan_col)
    med, trim = cs.coord_stats(x, f)
    medp, trimp = cs.coord_stats_plain(x, f)
    torch.cuda.synchronize()
    for what, got, want in (("median", med, medp),
                            ("trimmed mean", trim, trimp)):
        err, bad = compare_nan(torch, got, want, tol, f"{tag} {what}")
        expect(not bool(bad.any()), f"{tag} {what}: {int(bad.sum())} "
               f"coordinates off the plain version by more than {tol}")
        worst["coord_stats"] = max(worst.get("coord_stats", 0.0),
                                   float(err.max()))


def phase_coord_kernels(torch, ops, worst):
    """K2 and K3 against their plain versions (phase 2's second half)."""
    bs, cs = ops["bulyan_select"], ops["coord_stats"]
    theta = N_MAIN - 2 * F_MAIN
    widths = (D_MLP, D_CNN, 1, 129, 4097)
    k2 = [(theta, F_MAIN, d) for d in widths] + [(3, 1, 4097),
                                                   (64, 15, 4097)]
    k3 = [(N_MAIN, F_MAIN, d) for d in widths] + [(3, 1, 4097),
                                                    (38, 9, 4097),
                                                    (64, 15, 4097)]
    seed = 1000
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for rows, f, d in k2:
            seed += 1
            check_k2(torch, bs, rows, f, d, dtype, seed, worst)
            print(f"  ok  K2 theta={rows:2d} f={f:2d} d={d:7d} {name}",
                  flush=True)
        for rows, f, d in k3:
            seed += 1
            check_k3(torch, cs, rows, f, d, dtype, seed, worst)
            print(f"  ok  K3 n={rows:2d} f={f:2d} d={d:7d} {name}",
                  flush=True)
    check_k2(torch, bs, theta, F_MAIN, 4097, torch.float32, 7, worst,
             nan_col=7)
    check_k3(torch, cs, N_MAIN, F_MAIN, 4097, torch.float32, 8, worst,
             nan_col=7)
    print("  ok  K2 and K3 with a NaN-bearing column", flush=True)
    # K2 in every size bucket of theta and at its edges, at the largest f
    # and a quarter of it, on a NaN column and the poisoned columns
    for dtype in (torch.float32, torch.bfloat16):
        for rows in K2_THETAS:
            for f in sorted({(rows - 1) // 2, rows // 4}):
                seed += 1
                check_k2(torch, bs, rows, f, 4097, dtype, seed, worst,
                         nan_col=7, poison=True)
        print(f"  ok  K2 theta in {K2_THETAS}, d=4097, NaN / inf / -inf / "
              f"-0.0 columns, {str(dtype).split('.')[-1]}", flush=True)


def time_coord_kernels(torch, ops, d, timer):
    """Per-call ms of K2, K3 and K4 in ``cwmed`` mode (K3's sort), their
    plain versions and ``torch.sort`` (sort only), at the main path's
    shapes (theta = 21 picked rows for K2, n = 39 for K3 and K4, f = 9,
    fp32)."""
    bs, cs, fa = ops["bulyan_select"], ops["coord_stats"], ops["fused_agg"]
    xs = make_stack(torch, N_MAIN - 2 * F_MAIN, d, 0, torch.float32, 98)
    xc = make_stack(torch, N_MAIN, d, F_MAIN, torch.float32, 97)
    table = {
        "bulyan_select": (lambda: bs.bulyan_select(xs, F_MAIN),
                          lambda: bs.bulyan_select_plain(xs, F_MAIN),
                          lambda: torch.sort(xs, dim=0)),
        "coord_stats": (lambda: cs.coord_stats(xc, F_MAIN),
                        lambda: cs.coord_stats_plain(xc, F_MAIN),
                        lambda: torch.sort(xc, dim=0)),
        "fused_coordinate:cwmed": (
            lambda: fa.fused_coordinate(xc, None, F_MAIN, mode="cwmed"),
            lambda: fa.fused_coordinate_plain(xc, None, F_MAIN,
                                              mode="cwmed"),
            lambda: torch.sort(xc, dim=0)),
    }
    return timed(timer, table, N_MAIN, d, F_MAIN)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def model_and_loss(rt, kind):
    """A paper model's seeded parameters and its training loss."""
    simple = rt["simple"]
    if kind == "mnist":
        params = simple.init_mnist_mlp(seed=1, device="cuda")
        fwd = simple.mnist_mlp_forward
    else:
        params = simple.init_cifar_cnn(seed=1, device="cuda")
        fwd = simple.cifar_cnn_forward

    def loss(p, x, y):
        return simple.classification_loss(fwd(p, x), y, p)

    return params, loss


def run_model(torch, rt, kind, steps, runs):
    tr, fa, build = rt["trainer"], rt["fused_agg"], rt["build"]
    params, loss = model_and_loss(rt, kind)

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
        # K5 counts the K1, select and K4 launches it made; K2 and K3 are
        # not on the training path
        want = (3 * steps if name == "fused_aggregate"
                else steps if name in TRAIN_KERNELS else 0)
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
PORT_KERNELS = ("gram_kernel", "select_kernel", "combine_single_kernel",
                "combine_bulyan_kernel", "coord_stats_kernel")
#: the port's profiler spans (``repro_torch.obs.trace.named_span``): the
#: profiler lists each with the device time of the kernels under it, so
#: they are not kernels of their own
SPANS = ("agg/coordinate", "agg/gram", "agg/select", "kernel/fused")


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
        if not str(ev.device_type).endswith("CUDA") or ev.key in SPANS:
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
# phase 3b: stateful and asynchronous training
# ---------------------------------------------------------------------------

#: the paper's Fig. 2 / 3 attack on Brute (benchmarks/fig2_mnist_attack.py)
BRUTE_LINF = (("gar_name", "brute"),) + LINF[1:]
N_BRUTE, F_BRUTE = 11, 5
#: kernel launches per step of each phase-3b rule, by its fused base: K5
#: counts the K1, select and K4 launches it made; Brute is plain PyTorch
STEP_LAUNCHES = {
    "bulyan-krum": {"pairwise_gram_partial": 1, "select_weights": 1,
                    "fused_coordinate": 1, "fused_aggregate": 3},
    "cwmed": {"fused_coordinate": 1, "fused_aggregate": 1},
    "brute": {},
}
#: (trainer, model, rule, n, f, steps, attack kwargs, spec kwargs)
STATEFUL_RUNS = (
    ("async", "mnist", "stale-fused-bulyan-krum", N_MAIN, F_MAIN, 10, LINF,
     {"async_tau": 2}),
    ("async", "mnist", "reputation-fused-bulyan-krum", N_MAIN, F_MAIN, 10,
     LINF, {"async_tau": 2}),
    ("async", "cifar", "stale-fused-bulyan-krum", N_MAIN, F_MAIN, 3, LINF,
     {"async_tau": 2}),
    ("sync", "mnist", "buffered-fused-cwmed", N_MAIN, F_MAIN, 10, LINF,
     {"history_window": 4}),
    ("sync", "mnist", "brute", N_BRUTE, F_BRUTE, 10, BRUTE_LINF, {}),
    ("sync", "cifar", "brute", N_BRUTE, F_BRUTE, 3, BRUTE_LINF, {}),
)


def fused_base(gar: str) -> str:
    """The fused base under a rule's wrapper prefixes, or the rule."""
    return gar.split("fused-", 1)[1] if "fused-" in gar else gar


def step0_stack(torch, rt, spec, trainer, loss, batcher):
    x0, y0 = batcher.batch(0)
    x0 = torch.as_tensor(x0, device="cuda")
    y0 = torch.as_tensor(y0, device="cuda").long()
    return rt["trainer"].byzantine_stack(loss, spec, trainer.params, x0, y0)


def run_stateful(torch, rt, mode, kind, gar, n, f, steps, akw, spec_kw):
    """One phase-3b run: step 0's aggregate against the unfused rule (or,
    for Brute, its CPU result), then ``steps`` counted and timed steps."""
    import dataclasses
    tr, build = rt["trainer"], rt["build"]
    params, loss = model_and_loss(rt, kind)
    spec = rt["AggSpec"](n_workers=n, f=f, gar=gar,
                         attack="omniscient_linf", attack_kwargs=akw,
                         **spec_kw)
    opt = rt["get_optimizer"]("sgd", rt["fading_lr"](ETA0, 1e4))
    batcher = rt["ByzantineBatcher"](kind, n - f, 16, seed=1, noise=0.5)
    cls = tr.AsyncByzantineTrainer if mode == "async" else tr.ByzantineTrainer
    trainer = cls(loss, params, opt, spec, seed=1, device="cuda")
    what = f"3b {kind} {mode} {gar}"

    full, _, ctx = step0_stack(torch, rt, spec, trainer, loss, batcher)
    rule = spec.rule()
    if rule.stateful:
        state = trainer.agg_state
        if mode == "async":   # step 0 delivers every worker
            state = state._replace(bus=rt["update_bus"](
                state.bus, full, 0, torch.ones(n, dtype=torch.bool,
                                               device="cuda")))
        plain = dataclasses.replace(spec, gar=gar.replace("fused-", ""))
        got, _ = rule.dense_fn(full, f, state)
        want, _ = plain.rule().dense_fn(full, f, state)
        against = plain.gar
    else:
        got = rule.dense_fn(full, f)
        want = rule.dense_fn(full.cpu(), f)
        against = "its CPU result"
    err, rel, scale = scaled_err(got.gradient,
                                 want.gradient.to(got.gradient.device))
    expect(rel <= FP32_TOL, f"{what} step-0 aggregate vs {against}: rel "
           f"err {rel:.3e} (max |want| {scale:.3e})")
    expect(torch.equal(got.selected.cpu(), want.selected.cpu()),
           f"{what} step-0 selection differs from {against}")
    step0 = rt["unflatten"](want.gradient.to("cuda"), ctx)
    expected = {k: v - ETA0 * step0[k] for k, v in trainer.params.items()}
    print(f"  {what}: step-0 aggregate vs {against}: max abs err "
          f"{err:.3e}, over max |want| {scale:.3e}: {rel:.3e}; selected "
          f"equal", flush=True)

    torch.cuda.synchronize()
    build.reset_launches()
    step_ms = []
    for t in range(steps):
        t0 = time.perf_counter()
        trainer.run(batcher, 1, start_step=t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        h = trainer.history[-1]
        expect(math.isfinite(h["loss"]), f"{what}: loss not finite")
        if t == 0:
            for k, v in expected.items():
                e, r = rel_err(trainer.params[k], v)
                expect(r <= FP32_TOL, f"{what} step-0 update of {k}: {r:.3e}")
    counts = dict(build.LAUNCHES)
    per_step = STEP_LAUNCHES[fused_base(gar)]
    for name in REPLACES:
        want_n = steps * per_step.get(name, 0)
        expect(counts[name] == want_n, f"{what}: {name} launched "
               f"{counts[name]} times in {steps} steps, expected {want_n}")
    for k, v in trainer.params.items():
        expect(bool(torch.isfinite(v).all()), f"{what}: param {k} not finite")
    last = trainer.history[-1]
    extra = "".join(f" {k} {last[k]:.0f}" for k in ("staleness_max",
                                                    "delivered") if k in last)
    print(f"  ok  {what}: {steps} steps, loss {last['loss']:.4f}, "
          f"byz_weight {last['byz_weight']:.2f}{extra}; launches per step "
          f"{per_step or 'none'}; ms per step "
          f"{[round(x, 3) for x in step_ms]}", flush=True)
    return {"what": what, "launches": counts, "step_ms": step_ms,
            "full": full}


def phase_identities(torch, rt, mlp_stack):
    """The reference's bitwise identities on the card, over the fused
    kernels: uniform reputation and uniform staleness reproduce
    ``fused-bulyan-krum``, and the asynchronous trainer at tau = 0
    reproduces the synchronous one."""
    resolve, init_state = rt["resolve_rule"], rt["init_state"]
    base = resolve("fused-bulyan-krum").dense_fn(mlp_stack, F_MAIN)
    rep = resolve("reputation-fused-bulyan-krum")
    got, _ = rep.dense_fn(mlp_stack, F_MAIN, init_state(rep, mlp_stack))
    stale = resolve("stale-fused-bulyan-krum")
    state = init_state(stale, mlp_stack)
    state = state._replace(step=5, bus=state.bus._replace(
        versions=torch.full_like(state.bus.versions, 3)))
    got_s, _ = stale.dense_fn(mlp_stack, F_MAIN, state)
    for label, res in (("uniform reputation", got),
                       ("uniform staleness", got_s)):
        expect(all(torch.equal(a, b) for a, b in zip(res, base)),
               f"{label} is not fused-bulyan-krum bit for bit")
        print(f"  ok  {label} == fused-bulyan-krum, bit for bit",
              flush=True)

    tr = rt["trainer"]
    params, loss = model_and_loss(rt, "mnist")
    trainers = []
    for cls in (tr.AsyncByzantineTrainer, tr.ByzantineTrainer):
        spec = rt["AggSpec"](n_workers=N_MAIN, f=F_MAIN,
                             gar="stale-fused-bulyan-krum",
                             attack="omniscient_linf", attack_kwargs=LINF,
                             async_tau=0)
        trainer = cls(loss, params, rt["get_optimizer"](
            "sgd", rt["fading_lr"](ETA0, 1e4)), spec, seed=1, device="cuda")
        trainer.run(rt["ByzantineBatcher"]("mnist", N_MAIN - F_MAIN, 16,
                                           seed=1, noise=0.5), 3)
        trainers.append(trainer)
    a, s = trainers
    expect(all(torch.equal(a.params[k], s.params[k]) for k in a.params),
           "async tau = 0 is not the synchronous step bit for bit")
    print("  ok  AsyncByzantineTrainer at tau = 0 == ByzantineTrainer, "
          "3 steps, parameters bit for bit", flush=True)


# ---------------------------------------------------------------------------
# phase 4: the tree engine
# ---------------------------------------------------------------------------

def tree_submissions(torch, rt, kind):
    """The Fig. 4 submissions of one model as a per-leaf tree: the 30
    honest ``vmap(grad)`` gradients, not flattened, then 9
    ``omniscient_linf`` rows from the port's ``inject_byzantine``."""
    params, loss = model_and_loss(rt, kind)
    n_h = N_MAIN - F_MAIN
    x, y = rt["ByzantineBatcher"](kind, n_h, 16, seed=1,
                                  noise=0.5).batch(0)
    x = torch.as_tensor(x, device="cuda")
    y = torch.as_tensor(y, device="cuda").long()
    honest = torch.func.vmap(torch.func.grad(loss),
                             in_dims=(None, 0, 0))(params, x, y)
    padded = {k: torch.cat([g, torch.zeros_like(g[:F_MAIN])])
              for k, g in honest.items()}
    return rt["inject_byzantine"](padded, F_MAIN, "omniscient_linf",
                                  **dict(LINF))


def expected_launches(build, backend: str, gar: str, n_leaves: int):
    """The launches one ``distributed_aggregate`` call implies."""
    want = dict.fromkeys(build.LAUNCHES, 0)
    if gar == "average" or backend == "xla":
        return want        # no distances, or no kernel at all
    dist = gar not in ("cwmed", "trimmed_mean")
    if backend == "pallas":
        want["pairwise_gram_partial"] = n_leaves if dist else 0
        return want
    want["fused_coordinate"] = n_leaves
    if dist:
        want["pairwise_gram_partial"] = n_leaves
        want["select_weights"] = 1
    if n_leaves == 1:      # one leaf goes to K5, which counts its parts
        want["fused_aggregate"] = 3 if dist else 1
    return want


def counted(torch, build, fn):
    """Run ``fn`` with every launch counter reset just before it; return
    its result and the counters read just after."""
    torch.cuda.synchronize()
    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(build.LAUNCHES)


def expect_launches(counts, want, what):
    expect(counts == want, f"{what}: launches {counts}, expected {want}")


def median_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after 2 warm-up
    calls; the host's work inside ``fn`` shows as device idle time)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flat_of(torch, rt, tree):
    return torch.cat([leaf.reshape(-1).float()
                      for leaf in rt["tree_leaves"](tree)])


def phase_tree(torch, rt, kind):
    """The tree engine on one model's Fig. 4 tree (see the docstring)."""
    build, da = rt["build"], rt["distributed_aggregate"]
    tree = tree_submissions(torch, rt, kind)
    n_leaves = len(tree)
    flat, _ = rt["stack_flatten"](tree)
    dense = {gar: rt["resolve_rule"](gar).dense_fn(flat, F_MAIN)
             for gar in TREE_RULES}
    print(f"  {kind} gradient scale: max |g| over the tree "
          f"{float(flat.abs().max()):.3e}, rms "
          f"{float(flat.pow(2).mean().sqrt()):.3e}", flush=True)
    results, fused_launches = {}, {}
    for backend in ("xla", "pallas", "fused"):
        worst_rel, smallest = 0.0, float("inf")
        for gar in TREE_RULES:
            what = f"{kind} tree {backend} {gar}"
            # through the spec, as a distributed trainer sets the backend
            spec = rt["AggSpec"](f=F_MAIN, gar=gar,
                                 distance_backend=backend)
            (agg, res), counts = counted(
                torch, build, lambda: spec.aggregate_tree(tree))
            expect_launches(counts, expected_launches(
                build, backend, gar, n_leaves), what)
            got = flat_of(torch, rt, agg)
            err, rel, scale = scaled_err(got, dense[gar].gradient)
            expect(rel <= FP32_TOL, f"{what} vs flat: rel err {rel:.3e} "
                   f"(max |want| {scale:.3e})")
            expect(torch.equal(res.selected, dense[gar].selected),
                   f"{what}: selected differs from the flat rule")
            results[(backend, gar)] = got
            if backend == "fused":
                fused_launches[gar] = counts
            worst_rel, smallest = max(worst_rel, rel), min(smallest, scale)
        print(f"  ok  {kind} ({n_leaves} leaves, d={flat.shape[1]}) "
              f"{backend}: {len(TREE_RULES)} rules match the flat rule "
              f"(worst err / max |want| {worst_rel:.3e}, smallest max "
              f"|want| {smallest:.3e}), launches as expected", flush=True)
    for gar in ("bulyan-krum", "cwmed"):
        what = f"{kind} single-leaf fused {gar}"
        (agg, res), counts = counted(torch, build, lambda: da(
            {"flat": flat}, F_MAIN, gar, distance_backend="fused"))
        expect_launches(counts, expected_launches(build, "fused", gar, 1),
                        what)
        err, rel, scale = scaled_err(agg["flat"], dense[gar].gradient)
        expect(rel <= FP32_TOL, f"{what} vs flat: rel err {rel:.3e} "
               f"(max |want| {scale:.3e})")
        expect(torch.equal(res.selected, dense[gar].selected),
               f"{what}: selected differs")
    print(f"  ok  {kind} single-leaf fused: K5 = K1 + select + K4",
          flush=True)

    # the kernel-pair route (K1, phase 1 in PyTorch, gather, K2) and K3,
    # counted from 0
    ops = rt["ops"]

    def pair_route():
        d2 = ops.pairwise_distances(flat)
        idx = rt["select_indices_from_dists"](d2, F_MAIN, "krum")
        agg = ops.bulyan_coordinate(flat[idx].contiguous(), F_MAIN)
        return idx, agg, rt["coord_stats"](flat, F_MAIN)

    (idx, pair, (med, trim)), path = counted(torch, build, pair_route)
    want = dict.fromkeys(build.LAUNCHES, 0)
    want.update(pairwise_gram_partial=1, bulyan_select=1, coord_stats=1)
    expect_launches(path, want, f"{kind} kernel-pair route and K3")
    sel = torch.zeros_like(dense["bulyan-krum"].selected)
    sel[idx] = 1.0
    expect(torch.equal(sel, dense["bulyan-krum"].selected),
           f"{kind} kernel-pair route picked other workers")
    for what, got, ref in (
            ("K1 + K2 vs fused-bulyan-krum", pair,
             results[("fused", "bulyan-krum")]),
            ("K3 median vs tree cwmed", med, results[("xla", "cwmed")]),
            ("K3 trimmed mean vs tree trimmed_mean", trim,
             results[("xla", "trimmed_mean")])):
        err, rel, scale = scaled_err(got, ref)
        expect(rel <= FP32_TOL, f"{kind} {what}: rel err {rel:.3e} "
               f"(max |want| {scale:.3e})")
        print(f"  ok  {kind} {what}: max abs err {err:.3e}, over max "
              f"|want| {scale:.3e}: {rel:.3e}", flush=True)

    agg_ms = {}
    for gar in ("bulyan-krum", "cwmed"):
        for backend in ("xla", "pallas", "fused"):
            agg_ms[(gar, backend)] = median_ms(torch, lambda: da(
                tree, F_MAIN, gar, distance_backend=backend))
            print(f"  {kind} {gar:12s} {backend:6s} "
                  f"{agg_ms[(gar, backend)]:.3f} ms per aggregation "
                  f"(median of 20)", flush=True)
    return {"launches": path, "agg_ms": agg_ms, "n_leaves": n_leaves,
            "fused_launches": fused_launches}


# ---------------------------------------------------------------------------
# phase 5: the fp32-accumulation contract
# ---------------------------------------------------------------------------

def phase_fp32(torch, rt):
    """The reference audit's fp32 section (``audit/sweep.py``) on the
    card: bf16 inputs, fp32 accumulation."""
    probes = rt["probes"]
    for d in (512, 1536, D_MLP, D_CNN):
        errs = {
            "gram": probes.gram_fp32_contract_error(n=8, d=d),
            "coord": probes.coord_fp32_contract_error(theta=9, f=2, d=d),
        }
        for mode in ("bulyan-krum", "trimmed_mean"):
            errs[f"fused {mode}"] = probes.fused_fp32_contract_error(
                n=11, f=2, d=d, mode=mode)
        for name, err in errs.items():
            expect(err <= FP32_TOL, f"probe {name} bf16 d={d}: rel err "
                   f"{err:.3e} > {FP32_TOL}")
        print(f"  ok  probes bf16 d={d}: " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()), flush=True)

    g = torch.Generator(device="cuda").manual_seed(3)
    n, f = 11, 2
    tree = {"w": torch.randn((n, 24, 8), generator=g, device="cuda"),
            "b": torch.randn((n, 40), generator=g, device="cuda")}
    tree = {k: v.to(torch.bfloat16) for k, v in tree.items()}
    flat, _ = rt["stack_flatten"](tree)
    for gar in ("krum", "cwmed", "bulyan-krum"):
        want = rt["resolve_rule"](gar).dense_fn(flat, f).gradient
        for backend in ("auto", "fused"):
            agg, _ = rt["distributed_aggregate"](tree, f, gar,
                                                 distance_backend=backend)
            for k, leaf in agg.items():
                expect(leaf.dtype == torch.bfloat16,
                       f"{gar}[{backend}]: leaf {k} came back {leaf.dtype}")
            err, rel = rel_err(flat_of(torch, rt, agg), want)
            expect(rel <= 1e-2, f"{gar}[{backend}]: bf16 tree deviates "
                   f"from the flat fp32 rule by rel {rel:.3e}")
            print(f"  ok  bf16 tree {gar}[{backend}]: rel err {rel:.2e}, "
                  f"leaf dtypes kept", flush=True)


# ---------------------------------------------------------------------------

def print_ptxas(log: pathlib.Path) -> None:
    """One line per kernel of an ``-Xptxas -v`` build log: its (mangled)
    name, registers, shared memory and spill bytes."""
    name, spill = None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.split(":")[-1].strip()
        elif "registers" in line and name:
            print(f"  {log.stem}: {name}: {line.split(':', 1)[1].strip()}; "
                  f"{spill}")
            name = None


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

    from repro_torch.agg.registry import resolve_rule
    from repro_torch.agg.specs import AggSpec
    from repro_torch.agg.state import init_state
    from repro_torch.dist.async_train import update_bus
    from repro_torch.core.bulyan import select_indices_from_dists
    from repro_torch.core.pytree import (stack_flatten, tree_leaves,
                                         unflatten)
    from repro_torch.data.synthetic import ByzantineBatcher, mnist_like
    from repro_torch.dist.robust import (distributed_aggregate,
                                         inject_byzantine)
    from repro_torch.kernels import _build, ops as kernel_ops, probes
    # the package exports functions under the names of these modules, as
    # the reference's does, so the modules come from the import system
    bulyan_select, coord_stats, fused_agg, pairwise_gram = (
        importlib.import_module(f"repro_torch.kernels.{name}")
        for name in ("bulyan_select", "coord_stats", "fused_agg",
                     "pairwise_gram"))
    from repro_torch.models import simple
    from repro_torch.optim import fading_lr, get_optimizer
    from repro_torch.training import trainer
    rt = dict(simple=simple, trainer=trainer, fused_agg=fused_agg,
              build=_build, AggSpec=AggSpec, unflatten=unflatten,
              ByzantineBatcher=ByzantineBatcher, mnist_like=mnist_like,
              fading_lr=fading_lr, get_optimizer=get_optimizer,
              resolve_rule=resolve_rule, stack_flatten=stack_flatten,
              tree_leaves=tree_leaves,
              distributed_aggregate=distributed_aggregate,
              inject_byzantine=inject_byzantine, ops=kernel_ops,
              select_indices_from_dists=select_indices_from_dists,
              coord_stats=coord_stats.coord_stats, probes=probes,
              init_state=init_state, update_bus=update_bus)
    ops = {"fused_agg": fused_agg, "pairwise_gram": pairwise_gram,
           "bulyan_select": bulyan_select, "coord_stats": coord_stats}

    print("== phase 1: build", flush=True)
    secs = _build.build_all()
    print(f"  built the CUDA kernels in {secs:.1f} s", flush=True)
    for log in sorted((_build._BUILD).glob("*.log")):
        print_ptxas(log)

    print("== phase 2: kernels vs plain versions", flush=True)
    worst = phase_kernels(torch, ops)
    phase_select_edges(torch, ops)
    phase_k4_nonfinite(torch, ops, worst)
    phase_coord_kernels(torch, ops, worst)
    timer = Timer(torch)
    timings = {}
    for model, d in (("mlp", D_MLP), ("cnn", D_CNN)):
        timings[model] = time_kernels(torch, ops, d, timer)
        timings[model].update(time_coord_kernels(torch, ops, d, timer))
    for model, rows in timings.items():
        for name, r in rows.items():
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.1f}")
            print(f"  {model} {name:22s} kernel {r['ms'] * 1e3:9.1f} us  "
                  f"plain {r['plain_ms'] * 1e3:10.1f} us  library {lib} us  "
                  f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})",
                  flush=True)

    print("== phase 3: main path (Fig. 4, fused-bulyan-krum)", flush=True)
    runs = {}
    mlp_trainer = run_model(torch, rt, "mnist", 40, runs)
    run_model(torch, rt, "cifar", 5, runs)
    accs = mlp_accuracies(torch, rt, mlp_trainer)
    for label, acc in accs.items():
        print(f"  MLP eval accuracy after 40 steps, {label}: {acc:.4f}")

    print("== phase 3b: stateful and async training", flush=True)
    stateful_runs = [run_stateful(torch, rt, *run) for run in STATEFUL_RUNS]
    phase_identities(torch, rt, stateful_runs[0]["full"])
    for r in stateful_runs:
        print(f"  {r['what']}: median "
              f"{statistics.median(r['step_ms']):.3f} ms per step "
              f"({len(r['step_ms'])} steps; {smi})", flush=True)
        del r["full"]

    print("== phase 4: the tree engine (Fig. 4 trees, 3 backends)",
          flush=True)
    tree_runs = {kind: phase_tree(torch, rt, kind)
                 for kind in ("mnist", "cifar")}

    print("== phase 5: fp32-accumulation contract (bf16 inputs)",
          flush=True)
    phase_fp32(torch, rt)

    print("== phase 6: device times (torch.profiler)", flush=True)
    device_times(timer, timings)
    read_yardstick(torch, timer)
    k2_yardsticks(torch, ops, timer)
    time_select_modes(torch, ops, timer)

    kernels = []
    for model, kind in (("mlp", "mnist"), ("cnn", "cifar")):
        for name, r in timings[model].items():
            kernel, _, mode = name.partition(":")
            if mode:  # K4 in another mode: the tree phase's fused rule
                launches = tree_runs[kind]["fused_launches"][mode][kernel]
            else:     # K2 and K3 run on the tree phase's kernel-pair route
                path = runs if name in TRAIN_KERNELS else tree_runs
                launches = path[kind]["launches"][name]
            expect(launches > 0, f"{name} was not launched on its path "
                   f"({model})")
            kernels.append({
                "name": f"{name}@{model}", "route": "cuda",
                "source": SOURCES[kernel], "replaces": REPLACES[kernel],
                "launches": launches,
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
