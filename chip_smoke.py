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
7. Telemetry and the self-audit (after phase 6), with cuDNN set
   deterministic (its default weight-gradient algorithms are not
   bitwise repeatable): (7a) the Fig. 4 step with
   ``AggSpec(telemetry=True)`` (``obs-fused-bulyan-krum``) beside the
   same run without, steps interleaved, 10 MLP and 3 CNN steps:
   parameters equal bit for bit and launches as phase 3's after every
   step, ``telemetry()["pushed"]`` the step count, each ring row's
   ``selected`` that step's, step 0's row against ``dense_diagnostics``
   on a CPU copy at 1e-4 (``selected``, ``scores``, ``step`` exact), and
   ms per step off and on; (7b) ``AsyncByzantineTrainer`` (tau = 2) over
   ``obs-stale-fused-bulyan-krum`` beside ``stale-fused-bulyan-krum``, 5
   MLP steps, the ring's staleness rows against the bus, and the CNN's
   tree through ``obs-fused-bulyan-krum`` (``fused``) beside
   ``fused-bulyan-krum``, its ``tree_diagnostics`` row against the CPU;
   (7c) ``scripts/torch_obs_report.py``'s demo (MLP, n = 15, f = 3, 12
   steps, ``fused-krum``), which must exit 0; (7d) the leeway meter with
   ``DEFAULT_RULES``, their ``fused-`` forms and the weakened
   ``bulyan-weak``, on ``DEFAULT_DIMS`` against
   ``benchmarks/artifacts/leeway_baseline.json`` and on d up to
   486,346 against ``DEFAULT_EXPECTATIONS``: only ``bulyan-weak``
   flagged, each ``fused-`` margin its base's at 1e-4, launches exact
   per rung, seconds per rung; (7e) the quick audit sweep on CUDA
   tensors: no violation, the CPU run's case counts per section, the
   ``fp32`` section's kernel launches, the reference's 408
   ``speculative`` cases, seconds per section.
8. The LLM path, ``repro_torch.dist.train.make_train_step`` over the
   model zoo (still with cuDNN deterministic): (8a) gemma3-1b at its
   published widths (d_model 1152, 4 heads, MQA, head_dim 256, geglu
   d_ff 6912, vocab 262,144, window 512, tied embeddings, fp32) with its
   26 layers cut to 8 (one period of 5 swa + 1 attn, then the 2 tail swa
   layers): 516,705,408 parameters in 74 leaves, n = 7, f = 1,
   ``bulyan-krum`` over the ``fused`` backend, ``omniscient_linf``,
   AdamW 3e-4, one 1,024-token sequence per worker from ``lm_batches``,
   per-worker gradients one worker per ``vmap`` pass.  Step 0's
   submissions aggregated by the ``fused`` backend (K1 74, select 1, K4
   74 launches exactly) against the ``xla`` backend on the same tree at
   1e-4 of each leaf's largest entry with equal ``selected``; K1 and K4
   on the (7, 301,989,888) embedding leaf against their plain versions
   at 1e-4, and the selection exactly; a strided leaf through K1 and K4
   against their plain versions; then 3 steps with the launch counters
   reset before and read after (K1 74, select 1, K4 74 per step, K5
   none), finite losses equal bit for bit to a second 3-step run's, ms
   per step on the host clock (median of 3) and K1's and K4's device
   time per step (``torch.profiler``).  (8b) one ``reduced()`` config
   of each other family (llama3.2-3b, gemma-2b, qwen1.5-4b, mixtral and
   llama4-scout MoE, mamba2 SSM, jamba hybrid, whisper audio, llama3.2
   vision), 2 steps of ``fused-bulyan-krum`` over the ``fused`` backend
   with step 0 against ``xla`` at 1e-4 and exact launches per step (every
   reduced config is fp32).
9. Serving, ``repro_torch.serving.ServingEngine`` over the zoo's decode
   path (``models/decode.py``) and ``dist/serve_robust.py``, with
   ``AggSpec(f=1, gar="bulyan-krum", distance_backend="fused")``: (9a)
   8a's gemma3-1b cut and seed, an ensemble of 7 replicas
   (``replicate_params``, jitter 1e-3 from a CPU generator) with the
   last one poisoned (``signflip``, scale 10), ``n_slots=4``,
   ``cache_len=1024``, 6 seeded requests (prompts 32-256 tokens, 16-32
   new tokens, so slots are reused).  Around every admission and decode
   step the launches must read K1 1, select 1, K4 1 (one K5, whose
   counter reads its 3 parts), K2 / K3 0, and the poisoned replica's
   selection weight 0; the run's totals are the counters from 0.  The
   first decode step's (7, 1,048,576) logits stack through ``fused``
   against ``xla`` at 1e-4 of its largest entry with equal
   ``selected``; a second run, request 0 served alone and a
   ``telemetry=True`` run give the same streams bit for bit (``pushed``
   equals the decode aggregations).  Readings: ms per decode step and
   per admission, tokens/s, peak memory, one profiled step (device busy
   share, K5's device time), whether ``average`` is steered (not gated),
   and K1 / select / K4 / K5 on that stack against their plain versions
   with their times.  (9b) speculative verify at llama3.2-3b's published
   widths cut to 2 layers (595,344,384 parameters per replica; gemma3-1b's
   swa slots fail ``verify_supported``): k = 1 equals the per-token engine
   bit for bit; at k = 4 (draft on replica 0) each verify block launches
   exactly 4 K5s, counts lie in [1, 4] and every emitted token sits at its
   position's aggregated maximum; accept mean and agreement with the
   per-token stream printed.  (9c) every family's ``reduced()`` config:
   the robust prefill step and 4 robust decode steps, exact launches per
   call, finite aggregates.  (9d) sharded serving, ``ServingEngine(mesh=)``
   on gloo ranks sharing the card (``run_on_mesh(..., backend="gloo")``;
   the rank functions are ``tests/torch_serve_mesh_check.py``'s): 9a's
   gemma3-1b cut and requests, an ensemble of 8 (jitter 1e-3 from a CUDA
   generator seeded in each process, the last replica ``signflip`` x 10)
   on a (2, 1) mesh, 4 replicas per rank, the logits all-gathered over
   ``data``.  Around every admission and decode step each rank's
   launches must read one K5 (K1 1, select 1, K4 1; K2 / K3 0) and the
   poisoned replica's weight 0; the first decode step's gathered (8, 4,
   262,144) stack must match a single-device 8-replica run's (its own
   process) in the honest replicas' rows at 1e-4 of their largest
   entry; the poisoned replica's row, which rounding moves far more, is
   held on the single-device run's own first-step inputs (token,
   positions, that replica's cache), where the rank's row and one
   device's must each lie within 1e-3 of its largest entry from the
   step in float64 (``hold_first_step``); each rank's aggregate and
   selection must equal ``aggregate_logits`` on one device on that stack
   bit for bit (scores at 1e-4); the ranks' streams must equal each other
   and the single-device run's by the serving tests' rule
   (``tests/torch_serving_compare.py``: a parting only after a near-tie
   of the aggregate's two largest logits in either run, printed).  Then
   the same two ranks as a (1, 2) mesh, the ``model`` axis at full width,
   tensor-parallel: each rank holds the model halves of all 8 replicas
   (``ensemble_param_shardings``' share in the serving layout, its bytes
   exactly what ``launch.dryrun.serve_layout_bytes`` gives, under 51% of
   the 8 replicas whole) and decodes on the split forward, ``fused``
   becomes ``pallas``, exactly one K1 per aggregation per rank on its
   (8, 524,288) vocabulary slice and nothing else, the same gates
   against the same single-device run (the one-device aggregate under
   ``pallas``).  Readings: ms per decode step and rank, the collectives'
   ms and bytes (and, on (1, 2), their calls and bytes per kind per
   decode step), tokens/s (the probe's own capture forward left out),
   memory per rank (resident after the build, peak in the run, and on
   (1, 2) the build's transient peak, when the rank holds the whole
   ensemble and its share at once), K5 on a rank's (8, 1,048,576) stack
   and K1 on its (8, 524,288) slice against their plain versions (and K1
   beside ``torch.mm``), timed with the card to itself.
   (9e) the ``model`` axis with verify and telemetry: reduced llama3.2-3b,
   8 replicas on a (2, 2) mesh, split over ``model`` as in 9d (``fused``
   becomes ``pallas``), per token,
   with ``speculative_k = 4`` (draft replica 0) and with
   ``telemetry=True``: exactly one K1 per aggregation per rank on its
   vocabulary slice and nothing else, the first decode step's aggregate
   held to one device's on its gathered stack as in 9d, streams equal
   across ranks and to the single-device engine's, telemetry on == off,
   each telemetry row equal bit for bit to what one device records from
   the step's gathered stack and aggregate, and against the
   single-device run's rows: where a row selects the same replicas,
   every field at 1e-4 of its largest entry (``trimmed_frac`` off by no
   more coordinates than lie near a trimmed bound on either stack),
   elsewhere a selection fp32 rounding can pick on one of the stacks.
10. The multi-rank runtime (``repro_torch.dist.mesh`` /
   ``dist.sharding`` and the ``mesh=`` step), gloo ranks sharing the card
   (``run_on_mesh(..., backend="gloo")``; the rank functions are
   ``tests/torch_mesh_check.py``'s, since spawned ranks import them, and
   the comparisons ``tests/torch_llm_compare.py``'s, the tests' rule):
   (10a) 8a's gemma3-1b cut on a (1, 2) mesh, n = 7, f = 1,
   ``bulyan-krum`` over ``fused`` (``pallas`` under the model axis),
   ``omniscient_linf`` ("ones"), momentum SGD 1e-2, 3 steps, one worker
   per ``vmap`` pass.  Every rank must launch K1 exactly 74 times per
   step (once per local leaf slice) and nothing else; step 0's
   all-reduced (7, 7) matrix and gathered aggregate must equal the
   single-device ``xla`` backend's on the same submissions (gathered to
   one rank) at 1e-4 of each leaf's largest entry with equal
   ``selected``; K1 on each rank's (7, 150,994,944) embedding slice is
   held to its float64 function at 1e-4 and timed (each rank with the
   card to itself) beside its plain version and ``torch.mm``; after 3
   steps each leaf's change must equal a single-device run's (its own
   process) at 1e-4 of its largest change plus one ulp per step,
   outside the coordinates where Bulyan's window ties on either run's
   submissions or differs between them (under 1e-3 of the coordinates),
   with the same selections every step (each counted step hands its own
   submissions to the check through ``make_train_step``'s ``observe``
   hook; one uncounted pass before them takes step 0's submissions for
   the gate and the K1 check).  Readings: ms per step and rank,
   seconds and bytes in collectives, peak memory per rank, where each
   rank's time went.  (10b) reduced llama3.2-3b on a (2, 2) mesh of four
   ranks, n = 8: 2 synchronous steps, 2 asynchronous steps at tau = 2
   (``stale-bulyan-krum``) and 2 at tau = 0, against single-device runs
   by the same rule, tau = 0 equal to the synchronous steps bit for bit,
   exactly K1 11 per step and rank.
11. One JSON line of per-kernel measurements (phase 8's K1, selection and
   K4 on the embedding leaf, phase 9a's K1, selection, K4 and K5 on the
   serving stack, 9d's K5 on a rank's gathered stack and K1 on a rank's
   vocabulary slice, phase 10a's K1 on a rank's embedding slice,
   phase 13's grouped GEMM and phase 14's decode attention added), then
   the result line
   ``{"ok": true, "device": {...}}``.
12. The launch harness (``repro_torch.launch``), after phase 10 and
   before the JSON lines.  (12a) ``python -m repro_torch.launch.dryrun``
   as subprocesses, all started together, on the cases of the
   reference's ``tests/test_dryrun.py`` (reduced mamba2-130m
   ``train_4k`` on 16 x 16, reduced gemma3-1b ``decode_32k`` on
   2 x 16 x 16, ``--serve-gar bulyan-krum``, ``--async-tau 3`` with
   ``stale-bulyan-krum``), gemma3-1b ``train_4k`` at full width over
   ``fused``, and the robust decode of a model no rank can hold whole,
   mixtral-8x22b ``decode_32k`` with 16 replicas on 16 x 16 (one per
   ``data`` row, split 16 ways; its per-rank arguments and temp printed
   beside the arguments a whole replica per rank would take): each
   artifact's schema as the reference's tests check it, its roofline
   (H100 data-sheet figures, an estimate), launches and seconds
   printed.  (12b) the hold: the dry-run's trace under
   ``RecordingMesh`` of 10a's step for each rank position, and of 9d's
   decode step on (2, 1) and (1, 2), on ``meta`` tensors; the predicted
   collectives per kind (calls and result bytes) must equal what each
   gloo rank recorded per counted step (``Mesh.comm["by_kind"]``, the
   step call's own), the predicted launches the measured ones (K1 74 per
   rank per 10a step, nothing else; 9d's K5 parts or one K1 per decode
   step), and the predicted argument bytes must not exceed the rank's
   measured peak; the predicted argument + temp bytes and the roofline
   terms are printed beside the measured peak and ms per step.
13. The grouped GEMM of the dropless expert layer
   (``repro_torch/kernels/grouped_gemm.py``, after phase 12 and before
   the JSON lines), at one worker pass of one expert layer of the
   ``deepseek-v2-lite-l5`` cell: 4,096 tokens x top-6 pairs sorted by
   expert in a 24,576-row buffer, the 8 held experts of 64 with the rows
   a seeded uniform router gives them (3,060 in all), D = 2,048,
   F = 1,408.  The forward (``gmm``), dX (``gmm`` with the weights
   transposed) and dW (``gmm_dw``) each against the per-group
   ``torch.mm`` loop at 1e-5 of its largest entry (``GMM_TOL``), the
   rows of no group exactly 0, each call launching ``grouped_gemm`` once
   and nothing else (counters reset just before it); then each one's
   CUDA-event time (L2 flushed), its kernel's device time, its bound and
   the loop's times (the loop is the plain version and the library
   call: it reads the group sizes on the host).  The forward must beat
   the loop on CUDA events.
14. The decode attention over the serving cache
   (``repro_torch/kernels/decode_attention.py``, after phase 13 and
   before the JSON lines), at the ``qwen1.5-4b-l4.serve-chat`` cell's
   shapes: one layer's period view of a replica-stacked cache (7
   replicas x 4 periods x 12 slots x 2,048 positions x 20 heads of 128,
   fp32), every replica's query of one decode step through ``vmap`` as
   the robust step runs it, the slots' lengths mixing 1, 127, 128, 129,
   1,020, 2,047 and 2,048.  Against the plain path as the parent's
   decode step ran it (the ``einsum`` body under ``vmap``) at 1e-5 of
   its largest entry, one ``decode_attention`` launch counted and
   nothing else; then CUDA-event ms (L2 flushed), the kernel's device
   ms, the bound (the K/V bytes up to each valid length, the queries
   and the output, at 3.35 TB/s), the plain path's times and
   ``F.scaled_dot_product_attention``'s on a dense copy with a boolean
   mask (a yardstick the port never calls), and the ptxas lines of the
   kernel's instances.  The kernel must beat the plain path's device
   time and reach 55% of its bound (its device time from a profile that
   recorded every launch: one that lost some is taken again).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
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
#: a poisoned replica's decode-step row (weights sign-flipped x 10, so
#: attention scores 100 times the honest ones') against the same step in
#: float64 on the same inputs, over the row's largest entry: 2.5 times
#: the largest the card has read (4.02e-4, 9d's split forward and one
#: device's, with the decode attention's kernel or the plain einsums)
POISONED_TOL = 1e-3
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
    "grouped_gemm": "none: the port's own (the JAX package's MoE is the "
                    "GShard einsum dispatch)",
    "decode_attention": "none: the port's own (the JAX package's "
                        "decode_attention is plain jnp)",
}
SOURCES = {
    "pairwise_gram_partial": "src/repro_torch/csrc/pairwise_gram.cu",
    "select_weights": "src/repro_torch/csrc/fused_agg.cu",
    "fused_coordinate": "src/repro_torch/csrc/fused_agg.cu",
    "fused_aggregate": "src/repro_torch/csrc/fused_agg.cu",
    "bulyan_select": "src/repro_torch/csrc/bulyan_select.cu",
    "coord_stats": "src/repro_torch/csrc/coord_stats.cu",
    "grouped_gemm": "src/repro_torch/csrc/grouped_gemm.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
}
#: K2's theta in every size bucket of the register sort and at its edges
K2_THETAS = (3, 8, 9, 16, 17, 21, 24, 25, 40, 48, 49, 64)
#: the kernels of PR 11's training path (phase 3)
TRAIN_KERNELS = ("pairwise_gram_partial", "select_weights",
                 "fused_coordinate", "fused_aggregate")
#: the reference's ``speculative`` audit cases on the quick grid
QUICK_SPECULATIVE = 408
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

    def device_ms(self, fn, reps: int, only: tuple = (),
                  launches: int = 0) -> float:
        """Device time per call of ``fn``'s own kernels (torch.profiler,
        the flush's fill kernel left out; with ``only``, just the kernels
        whose names hold one of its strings), over ``reps`` calls timed as
        :meth:`ms` times them.  A profile that recorded no device time is
        taken once more; 0.0 if that one is empty too.  With
        ``launches``, the kernels ``only`` names that one call launches:
        a profile that recorded another number of them (the profiler can
        lose kernels in a long process) is taken again, three times at
        most, and NaN is returned if none was whole."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for _ in range(3 if launches else 2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            us, seen = 0.0, 0
            for ev in prof.key_averages():
                if "FillFunctor" in ev.key or (
                        only and not any(k in ev.key for k in only)):
                    continue
                t = getattr(ev, "self_device_time_total", None)
                us += t if t is not None else getattr(
                    ev, "self_cuda_time_total", 0.0)
                seen += ev.count
            if launches:
                if seen == launches * reps:
                    break
                us = math.nan
            elif us > 0:
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


#: the port's aggregation kernels as the profiler names them
AGG_KERNELS = ("gram_kernel", "select_kernel", "combine_single_kernel",
               "combine_bulyan_kernel", "coord_stats_kernel")
#: the port's kernels as the profiler names them: the aggregation's and
#: the grouped GEMM's (forward and dX, dW)
PORT_KERNELS = AGG_KERNELS + ("gmm_rows_kernel", "gmm_dw_kernel")
#: the port's profiler spans (``repro_torch.obs.trace.named_span``): the
#: profiler lists each with the device time of the kernels under it, so
#: they are not kernels of their own
SPANS = ("agg/coordinate", "agg/gram", "agg/select", "kernel/fused",
         "model/cache", "model/mla", "moe/experts", "moe/route",
         "moe/shared", "serve/admit", "serve/aggregate", "serve/decode",
         "serve/prefill", "serve/sample", "serve/splice", "serve/step",
         "train/aggregate", "train/attack", "train/grad", "train/opt",
         "train/step")


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
    agg_ms = sum(r[0] for r in rows if any(k in r[2] for k in AGG_KERNELS))
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
# phase 7: telemetry and the self-audit
# ---------------------------------------------------------------------------

#: the paper's two MLP / CNN widths on top of the meter's default ladder
PAPER_DIMS = (64, 256, 1024, D_MLP, D_CNN)
#: launches of one fused rule's aggregation, by its base
RULE_LAUNCHES = {
    **{m: STEP_LAUNCHES["bulyan-krum"] for m in
       ("krum", "multikrum", "geomed", "bulyan-krum", "bulyan-geomed")},
    **{m: STEP_LAUNCHES["cwmed"] for m in ("cwmed", "trimmed_mean")},
}


def per_step(launches: dict, times: int = 1) -> dict:
    """Every counter's expected value: ``times`` x ``launches``."""
    return {name: times * launches.get(name, 0) for name in REPLACES}


def compare_record(torch, np, got: dict, want, what: str) -> None:
    """A drained ring row against a diagnostics row computed on the CPU:
    ``selected``, ``scores`` and ``step`` exact, the rest at 1e-4 of the
    largest entry (NaN in the same places)."""
    for fld, w in want._asdict().items():
        g = torch.as_tensor(np.asarray(got[fld]))
        w = w.detach().cpu()
        if fld in ("selected", "scores", "step"):
            expect(torch.equal(g, w), f"{what}: ring {fld} differs")
        else:
            expect(torch.equal(torch.isnan(g), torch.isnan(w)),
                   f"{what}: ring {fld} NaN places differ")
            err, rel = rel_err(torch.nan_to_num(g), torch.nan_to_num(w))
            expect(rel <= FP32_TOL, f"{what}: ring {fld} rel err {rel:.3e}")


def fig4_trainers(torch, rt, kind, cls, gar, **spec_kw):
    """The same Fig. 4 trainer twice from one seed: telemetry off, on."""
    out = {}
    for telemetry in (False, True):
        params, loss = model_and_loss(rt, kind)
        spec = rt["AggSpec"](n_workers=N_MAIN, f=F_MAIN, gar=gar,
                             attack="omniscient_linf", attack_kwargs=LINF,
                             telemetry=telemetry, **spec_kw)
        opt = rt["get_optimizer"]("sgd", rt["fading_lr"](ETA0, 1e4))
        out[telemetry] = cls(loss, params, opt, spec, seed=1, device="cuda")
    return out, loss


def interleaved_steps(torch, rt, trainers, kind, steps, what, after=None):
    """Steps of the off and on trainers in turn, each counted and timed;
    parameters equal bit for bit and launches as phase 3's after every
    step.  ``after(t)`` runs once both have taken step t."""
    build = rt["build"]
    batcher = rt["ByzantineBatcher"](kind, N_MAIN - F_MAIN, 16, seed=1,
                                     noise=0.5)
    want = per_step(STEP_LAUNCHES["bulyan-krum"])
    ms = {False: [], True: []}
    for t in range(steps):
        for telemetry in (False, True):
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            trainers[telemetry].run(batcher, 1, start_step=t)
            torch.cuda.synchronize()
            ms[telemetry].append((time.perf_counter() - t0) * 1e3)
            expect_launches(dict(build.LAUNCHES), want,
                            f"{what} step {t} telemetry={telemetry}")
        off, on = trainers[False].params, trainers[True].params
        expect(all(torch.equal(off[k], on[k]) for k in off),
               f"{what} step {t}: telemetry changed the parameters")
        if after is not None:
            after(t)
    return ms


def phase_telemetry(torch, np, rt, kind, steps):
    """7a: Fig. 4 training with ``AggSpec(telemetry=True)`` beside the
    same run without it."""
    tr = rt["trainer"]
    trainers, loss = fig4_trainers(torch, rt, kind, tr.ByzantineTrainer,
                                   "fused-bulyan-krum")
    on = trainers[True]
    expect(on.spec.effective_gar == "obs-fused-bulyan-krum",
           f"7a: effective gar {on.spec.effective_gar}")
    batcher = rt["ByzantineBatcher"](kind, N_MAIN - F_MAIN, 16, seed=1,
                                     noise=0.5)
    k5 = rt["resolve_rule"]("fused-bulyan-krum")
    selected, step0 = [], {}

    def before(t):
        # this step's stack and selection, recomputed outside the
        # counted window from the parameters the step will read
        x, y = batcher.batch(t)
        full, _, _ = tr.byzantine_stack(
            loss, on.spec, on.params, torch.as_tensor(x, device="cuda"),
            torch.as_tensor(y, device="cuda").long(),
            step=on.opt_state["step"])
        res = k5.dense_fn(full, F_MAIN)
        selected.append(res.selected.cpu())
        if t == 0:
            step0.update(full=full.cpu(), res=res)

    before(0)
    ms = interleaved_steps(
        torch, rt, trainers, kind, steps, f"7a {kind}",
        after=lambda t: before(t + 1) if t + 1 < steps else None)
    tel = on.telemetry()
    expect(tel["pushed"] == steps, f"7a {kind}: pushed {tel['pushed']}")
    for t, rec in enumerate(tel["records"]):
        expect(torch.equal(torch.as_tensor(rec["selected"]), selected[t]),
               f"7a {kind}: ring row {t} selected differs from the step's")
    res = step0["res"]
    want = rt["dense_diagnostics"](
        step0["full"], res.gradient.cpu(), res.selected.cpu(),
        res.scores.cpu(), F_MAIN, 1, torch.ones(N_MAIN),
        torch.zeros(N_MAIN))
    compare_record(torch, np, tel["records"][0], want,
                   f"7a {kind} step 0")
    off, on_ms = (statistics.median(ms[False]),
                  statistics.median(ms[True]))
    print(f"  ok  7a {kind}: {steps} steps obs-fused-bulyan-krum == "
          f"fused-bulyan-krum bit for bit, launches per step "
          f"{STEP_LAUNCHES['bulyan-krum']} both; pushed {tel['pushed']}, "
          f"ring selected == each step's, step-0 row vs the CPU at 1e-4",
          flush=True)
    print(f"  7a {kind}: ms per step median telemetry off {off:.3f} "
          f"(range {min(ms[False]):.3f}-{max(ms[False]):.3f}), on "
          f"{on_ms:.3f} (range {min(ms[True]):.3f}-{max(ms[True]):.3f}), "
          f"on / off {on_ms / off:.4f} (the reference's "
          f"benchmarks/obs_overhead.py gate: < 1.05)", flush=True)
    return {"steps": steps, "off_ms": ms[False], "on_ms": ms[True]}


def phase_telemetry_async(torch, np, rt, steps):
    """7b: the async trainer over ``obs-stale-fused-bulyan-krum`` (tau =
    2) beside ``stale-fused-bulyan-krum``; the ring's staleness rows
    against the bus."""
    trainers, _ = fig4_trainers(torch, rt, "mnist",
                                rt["trainer"].AsyncByzantineTrainer,
                                "stale-fused-bulyan-krum", async_tau=2)
    on = trainers[True]
    stale_rows = []

    def after(t):
        st = on.agg_state
        stale_rows.append(torch.clamp_min(st.step - st.bus.versions, 0)
                          .float().cpu())

    ms = interleaved_steps(torch, rt, trainers, "mnist", steps,
                           "7b async", after=after)
    tel = on.telemetry()
    expect(tel["pushed"] == steps, f"7b: pushed {tel['pushed']}")
    for t, rec in enumerate(tel["records"]):
        expect(torch.equal(torch.as_tensor(rec["staleness"]),
                           stale_rows[t]),
               f"7b: ring staleness row {t} differs from the bus")
    print(f"  ok  7b async tau=2: {steps} MLP steps "
          f"obs-stale-fused-bulyan-krum == stale-fused-bulyan-krum bit "
          f"for bit, launches per step as phase 3b; ring staleness == bus "
          f"(last {stale_rows[-1].tolist()}); ms per step median off "
          f"{statistics.median(ms[False]):.3f} on "
          f"{statistics.median(ms[True]):.3f}", flush=True)


def phase_telemetry_tree(torch, np, rt):
    """7b: ``obs-fused-bulyan-krum`` on the CNN's gradient tree through
    the ``fused`` backend beside ``fused-bulyan-krum``."""
    build, da = rt["build"], rt["distributed_aggregate"]
    tree = tree_submissions(torch, rt, "cifar")
    keys = sorted(tree)
    want_launches = expected_launches(build, "fused", "bulyan-krum",
                                      len(tree))
    (want, wres), counts = counted(torch, build, lambda: da(
        tree, F_MAIN, "fused-bulyan-krum", distance_backend="fused"))
    expect_launches(counts, want_launches, "7b tree fused-bulyan-krum")
    rule = rt["resolve_rule"]("obs-fused-bulyan-krum")
    state = rt["init_state"](rule, tree, flat=False)
    (got, gres, state), counts = counted(torch, build, lambda: da(
        tree, F_MAIN, "obs-fused-bulyan-krum", distance_backend="fused",
        state=state))
    expect_launches(counts, want_launches, "7b tree obs-fused-bulyan-krum")
    expect(all(torch.equal(got[k], want[k]) for k in keys),
           "7b tree: obs- leaves differ from fused-bulyan-krum's")
    expect(torch.equal(gres.selected, wres.selected),
           "7b tree: obs- selection differs")
    ref = rt["tree_diagnostics"](
        [tree[k].cpu() for k in keys], [want[k].cpu() for k in keys],
        wres.selected.cpu(), wres.scores.cpu(), F_MAIN, 1,
        torch.ones(N_MAIN), torch.zeros(N_MAIN))
    compare_record(torch, np, rt["drain"](state.obs)["records"][0], ref,
                   "7b tree")
    print(f"  ok  7b tree: CNN {len(tree)} leaves obs-fused-bulyan-krum "
          f"(fused) == fused-bulyan-krum bit for bit, launches {counts}; "
          f"tree_diagnostics row vs the CPU at 1e-4", flush=True)


def phase_report(torch, rt):
    """7c: ``scripts/torch_obs_report.py``'s demo on the MLP (n = 15, f =
    3, 12 steps, ``fused-krum``), in this process."""
    spec = importlib.util.spec_from_file_location(
        "torch_obs_report", ROOT / "scripts" / "torch_obs_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    build = rt["build"]
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    rc = report.main(["--gar", "fused-krum", "--steps", "12", "--device",
                      "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    expect(rc == 0, f"7c: torch_obs_report exited {rc}: no entropy "
           f"collapse, or no Byzantine row blamed")
    expect(counts["fused_aggregate"] > 0, f"7c: no kernel ran: {counts}")
    print(f"  ok  7c defense report: entropy collapse and a Byzantine row "
          f"blamed; launches {counts}; {secs:.2f} s", flush=True)


def phase_leeway(torch, rt):
    """7d: the leeway law on the card, through the fused kernels."""
    lw = rt["leeway"]
    fused = [f"fused-{r}" for r in lw.DEFAULT_RULES
             if r in rt["FUSED_BASES"]]
    rules = list(lw.DEFAULT_RULES) + fused + [("bulyan-weak",
                                               "bulyan-krum", 0)]
    weak = {"bulyan-weak": ("rel", None, -0.25)}
    with open(ROOT / "benchmarks" / "artifacts" /
              "leeway_baseline.json") as fh:
        baseline = json.load(fh)
    per_d = {}
    for name in REPLACES:
        per_d[name] = sum(RULE_LAUNCHES[g[len("fused-"):]].get(name, 0)
                          for g in fused)
    honest_stack = lw._honest_stack
    reports = {}
    for dims, kw in ((lw.DEFAULT_DIMS, {"baseline": baseline}),
                     (PAPER_DIMS, {})):
        starts = []

        def timed_stack(*args):
            # one timestamp per rung, the device idle
            torch.cuda.synchronize()
            starts.append(time.perf_counter())
            return honest_stack(*args)

        lw._honest_stack = timed_stack
        try:
            (rep, counts) = counted(torch, rt["build"], lambda: lw.
                                    measure_leeway(rules=rules, dims=dims,
                                                   device="cuda"))
        finally:
            lw._honest_stack = honest_stack
        starts.append(time.perf_counter())
        secs = [b - a for a, b in zip(starts, starts[1:])]
        expect_launches(counts, {k: v * len(dims) for k, v in per_d.items()},
                        f"7d leeway {dims}")
        violations = lw.certify(rep, expectations={
            **lw.DEFAULT_EXPECTATIONS, **weak}, **kw)
        against = "the baseline" if kw else "DEFAULT_EXPECTATIONS"
        expect(all("bulyan-weak" in v for v in violations),
               f"7d {dims}: certify against {against}: {violations}")
        expect(any("bulyan-weak" in v for v in violations),
               f"7d {dims}: the weakened rule passed certification")
        for g in fused:
            base = rep["rules"][g[len("fused-"):]]["margin_abs"]
            for i, (a, b) in enumerate(zip(rep["rules"][g]["margin_abs"],
                                           base)):
                expect(abs(a - b) <= FP32_TOL * abs(b),
                       f"7d {g} at d={dims[i]}: margin {a} vs {b}")
        print(f"  ok  7d leeway dims {list(dims)}: certify against "
              f"{against} flags only the weakened rule "
              f"({violations}); fused margins == unfused at 1e-4; "
              f"launches {counts}", flush=True)
        for label, r in rep["rules"].items():
            print(f"    {label:18s} margin_abs "
                  f"{[float('%.4g' % m) for m in r['margin_abs']]} "
                  f"slope_abs {r['slope_abs']:+.3f} slope_rel "
                  f"{r['slope_rel']:+.3f}", flush=True)
        for g, r in rep["gamma"].items():
            print(f"    gamma_{g:12s} {[float('%.4g' % v) for v in r['values']]}"
                  f" slope {r['slope']:+.3f}", flush=True)
        print(f"    seconds per d {dict(zip(dims, [round(x, 3) for x in secs]))}",
              flush=True)
        reports[dims] = rep
    return reports


def phase_sweep(torch, rt):
    """7e: the quick audit sweep on CUDA tensors, per section timed and
    counted, against the same sweep on the CPU."""
    import contextlib
    sw, build = rt["sweep"], rt["build"]
    secs, launches = {}, {}

    @contextlib.contextmanager
    def hook(name):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = dict(build.LAUNCHES)

    report = sw.run_sweep(sw.QUICK, device="cuda", section_hook=hook)
    expect(report.ok(), f"7e: {len(report.violations)} violations, first "
           f"{report.violations[:3]}")
    cpu = sw.run_sweep(sw.QUICK, device="cpu")
    expect(cpu.ok(), f"7e: the CPU sweep has violations "
           f"{cpu.violations[:3]}")
    cases = {k: v[0] for k, v in report.sections.items()}
    expect(cases == {k: v[0] for k, v in cpu.sections.items()},
           f"7e: case counts {cases} differ from the CPU's "
           f"{cpu.sections}")
    expect(cases.get("speculative") == QUICK_SPECULATIVE,
           f"7e: speculative cases {cases.get('speculative')}, the "
           f"reference's quick grid has {QUICK_SPECULATIVE}")
    expect(sum(launches["fp32"].values()) > 0,
           f"7e: the fp32 section launched no kernel: {launches['fp32']}")
    print(f"  ok  7e quick sweep on CUDA tensors: {report.cases} cases, 0 "
          f"violations, per-section cases == the CPU's {cases}", flush=True)
    for name, s in secs.items():
        print(f"    {name:12s} {s:8.3f} s  launches "
              f"{ {k: v for k, v in launches[name].items() if v} }",
              flush=True)
    return {"secs": secs, "launches": launches}


# ---------------------------------------------------------------------------
# phase 8: the LLM path (the model zoo's train step)
# ---------------------------------------------------------------------------

#: 8a: gemma3-1b at its published widths, 26 layers cut to one full
#: period (5 swa + 1 attn) and the two tail swa layers
LLM_ARCH, LLM_LAYERS, LLM_LEAVES, LLM_PARAMS = "gemma3_1b", 8, 74, 516_705_408
LLM_N, LLM_F, LLM_SEQ, LLM_STEPS = 7, 1, 1024, 3
#: 8b: every other family, reduced
LLM_OTHERS = ("llama3_2_3b", "gemma_2b", "qwen1_5_4b", "mixtral_8x22b",
              "llama4_scout", "mamba2_130m", "jamba_1_5_large",
              "whisper_medium", "llama3_2_vision")
#: coordinates per slice of a plain version or a float64 reference run
#: over the embedding leaf (a slice bounds the workspace)
LLM_SLICE = 2 ** 25
#: tile width of K1's plain version when it is timed on the embedding
#: leaf: 288 tiles, where its default 4096 would launch 73,728 of them
LLM_GRAM_TILE = 2 ** 20


def llm_batch(np, rt, cfg, step: int, seq: int, n: int = LLM_N,
              per_worker: int = 1):
    """One step's worker batch, ``(n, per_worker, seq)`` tokens and
    labels from ``lm_batches``; the audio and vlm models get seeded frame
    or patch embeddings as ``extra``."""
    toks, labs = zip(*(rt["lm_batches"](cfg.vocab_size, per_worker, seq,
                                        step * n + w, seed=7)
                       for w in range(n)))
    batch = {"tokens": np.stack(toks), "labels": np.stack(labs)}
    if cfg.arch_type in ("audio", "vlm"):
        rng = np.random.default_rng(step)
        batch["extra"] = rng.standard_normal(
            (n, per_worker, cfg.encoder_seq or cfg.vision_seq, cfg.d_model)
        ).astype(np.float32)
    return batch


def llm_tree_check(torch, rt, grads, gar: str, n_leaves: int, what: str):
    """One counted ``fused`` aggregation of a gradient tree against the
    ``xla`` backend on the same tree: every leaf at 1e-4 of its largest
    entry, ``selected`` equal, launches exactly K1 and K4 once per leaf
    and the selection once.  Returns the fused aggregate and result."""
    build = rt["build"]
    (agg, res), counts = counted(torch, build, lambda: rt[
        "distributed_aggregate"](grads, LLM_F, gar, distance_backend="fused"))
    expect_launches(counts, expected_launches(build, "fused", "bulyan-krum",
                                              n_leaves), what)
    want, wres = rt["distributed_aggregate"](
        grads, LLM_F, "bulyan-krum", distance_backend="xla",
        window=LLM_SLICE)
    expect(torch.equal(res.selected, wres.selected),
           f"{what}: selected {res.selected.tolist()} vs xla "
           f"{wres.selected.tolist()}")
    worst = 0.0
    for k, (a, b) in enumerate(zip(rt["tree_leaves"](agg),
                                   rt["tree_leaves"](want))):
        _, rel, _ = scaled_err(a, b)
        worst = max(worst, rel)
        expect(rel <= FP32_TOL, f"{what}: leaf {k} differs from xla by "
               f"{rel:.3e} of its largest entry")
    del want
    return agg, res, worst


def raw_dists_f64(torch, x):
    """K1's function, ``sq_i + sq_j - 2 <x_i, x_j>`` summed over all
    columns, in float64 over column slices: a reference whose own
    rounding is far below K1's fp32 sums over 302M coordinates."""
    out = 0.0
    for c0 in range(0, x.shape[1], LLM_SLICE):
        blk = x[:, c0:c0 + LLM_SLICE].double()
        sq = torch.sum(blk * blk, dim=1)
        out = out + (sq[:, None] + sq[None, :] - 2.0 * (blk @ blk.T))
    return out


def llm_embedding_leaf(torch, rt, ops, leaf, grads, timer):
    """K1 on the 2.11e9-element embedding leaf against its function in
    float64, K4 against its plain version over column slices, each at
    1e-4 of the largest entry of what it is held to; the selection on
    the tree's distances against its plain version; and each one's time
    with its plain version, its bound and a library call."""
    pg, fa = ops["pairwise_gram"], ops["fused_agg"]
    n, d = leaf.shape[0], leaf[0].numel()
    x = leaf.reshape(n, d)
    raw = pg.pairwise_gram_partial(x)
    exact = raw_dists_f64(torch, x)
    k1_err, k1_rel, k1_scale = scaled_err(raw, exact)
    expect(k1_rel <= FP32_TOL, f"8a K1 on the embedding leaf: {k1_rel:.3e} "
           f"of {k1_scale:.3e}")
    # the plain version's own fp32 rounding, shown beside K1's, not gated
    _, plain_rel, _ = scaled_err(pg.pairwise_gram_partial_plain(
        x, block_d=LLM_GRAM_TILE), exact)
    dist = rt["pairwise_gram_tree"](grads)
    w, sel, _ = fa.select_weights(dist, n, LLM_F, "bulyan-krum")
    wp, selp, _ = fa.select_weights_plain(dist, n, LLM_F, "bulyan-krum")
    expect(torch.equal(w, wp) and torch.equal(sel, selp),
           "8a selection differs from its plain version")
    got = fa.fused_coordinate(x, w, LLM_F, mode="bulyan-krum")
    want = torch.cat([fa.fused_coordinate_plain(
        x[:, c0:c0 + LLM_SLICE], wp, LLM_F, mode="bulyan-krum")
        for c0 in range(0, d, LLM_SLICE)])
    k4_err, k4_rel, k4_scale = scaled_err(got, want)
    del want
    expect(k4_rel <= FP32_TOL, f"8a K4 on the embedding leaf: {k4_rel:.3e} "
           f"of {k4_scale:.3e}")
    print(f"  ok  8a embedding leaf ({n}, {d:,}) = {n * d:,} elements: K1 "
          f"{k1_err:.3e} off its float64 function ({k1_rel:.2e} of its "
          f"largest entry, {k1_scale:.4e}; its plain version {plain_rel:.2e}"
          f"), K4 {k4_err:.3e} off its plain "
          f"version ({k4_rel:.2e} of {k4_scale:.4e}); selection equal",
          flush=True)
    reps = 5

    def plain_k4():
        for c0 in range(0, d, LLM_SLICE):
            sl = slice(c0, c0 + LLM_SLICE)
            fa.fused_coordinate_plain(x[:, sl], wp, LLM_F,
                                      mode="bulyan-krum")

    rows = {
        "pairwise_gram_partial": dict(
            ms=timer.ms(lambda: pg.pairwise_gram_partial(x), reps),
            plain_ms=timer.ms(lambda: pg.pairwise_gram_partial_plain(
                x, block_d=LLM_GRAM_TILE), 2, warmup=1),
            library_ms=timer.ms(lambda: torch.mm(x, x.T), reps),
            max_abs_err=k1_err, **bound(n, d, LLM_F,
                                        "pairwise_gram_partial", 4)),
        "select_weights": dict(
            ms=timer.ms(lambda: fa.select_weights(dist, n, LLM_F,
                                                  "bulyan-krum"), 20),
            plain_ms=timer.ms(lambda: fa.select_weights_plain(
                dist, n, LLM_F, "bulyan-krum"), 5),
            library_ms=None, max_abs_err=0.0,
            **bound(n, d, LLM_F, "select_weights", 4)),
        "fused_coordinate": dict(
            ms=timer.ms(lambda: fa.fused_coordinate(
                x, w, LLM_F, mode="bulyan-krum"), reps),
            plain_ms=timer.ms(plain_k4, 2, warmup=1),
            library_ms=None, max_abs_err=k4_err,
            **bound(n, d, LLM_F, "fused_coordinate", 4)),
    }
    for name, r in rows.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"  8a {name:22s} kernel {r['ms']:9.3f} ms  plain "
              f"{r['plain_ms']:9.3f} ms  library {lib} ms  bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)
    return rows


def llm_strided_leaf(torch, ops, leaf):
    """A strided ``(n, d)`` leaf (worker axis moved to the front, as a
    ``vmap`` output can be) through K1, the selection and K4, against
    their plain versions at 1e-4 of the largest entry, with equal
    selections."""
    pg, fa = ops["pairwise_gram"], ops["fused_agg"]
    n = leaf.shape[0]
    x = leaf.reshape(n, -1).T.contiguous().T
    expect(not x.is_contiguous(), "8a: the strided leaf is contiguous")
    raw = pg.pairwise_gram_partial(x)
    _, rel, _ = scaled_err(raw, pg.pairwise_gram_partial_plain(x))
    expect(rel <= FP32_TOL, f"8a K1 on a strided leaf: {rel:.3e}")
    w, sel, _ = fa.select_weights(raw, n, LLM_F, "bulyan-krum")
    wp, selp, _ = fa.select_weights_plain(raw, n, LLM_F, "bulyan-krum")
    expect(torch.equal(w, wp) and torch.equal(sel, selp),
           "8a: selection on a strided leaf differs")
    _, rel4, _ = scaled_err(
        fa.fused_coordinate(x, w, LLM_F, mode="bulyan-krum"),
        fa.fused_coordinate_plain(x, wp, LLM_F, mode="bulyan-krum"))
    expect(rel4 <= FP32_TOL, f"8a K4 on a strided leaf: {rel4:.3e}")
    print(f"  ok  8a strided leaf {tuple(x.shape)} strides {x.stride()}: "
          f"K1 {rel:.2e}, K4 {rel4:.2e}, selection equal", flush=True)


def llm_run(torch, rt, cfg, spec, steps: int, seq: int, chunk, seed: int,
            profile_last: bool = False):
    """``steps`` steps of the zoo's train step from ``init_model(seed)``:
    launch counters reset just before the first step and read just after
    the last, each step timed on the host clock ending in
    ``torch.cuda.synchronize()``; the last step optionally under
    ``torch.profiler`` for K1's and K4's device time."""
    import contextlib
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    build = rt["build"]
    opt = rt["get_optimizer"]("adamw", 3e-4)
    params = rt["init_model"](seed, cfg, device="cuda")
    state = opt.init(params)
    step = rt["make_train_step"](cfg, spec, opt, worker_chunk=chunk)
    batches = [llm_batch(np, rt, cfg, t, seq) for t in range(steps)]
    losses, step_ms, dev_ms = [], [], {}
    torch.cuda.synchronize()
    build.reset_launches()
    for t in range(steps):
        profiled = profile_last and t == steps - 1
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            params, state, m = step(params, state, batches[t])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if profiled:
            by_kernel = {}
            for ev in prof.key_averages():
                t_us = getattr(ev, "self_device_time_total", None)
                if t_us is None:
                    t_us = getattr(ev, "self_cuda_time_total", 0.0)
                if t_us > 0:
                    by_kernel[ev.key] = (by_kernel.get(ev.key, 0.0)
                                         + t_us / 1e3)
                for name, key in (("pairwise_gram_partial", "gram_kernel"),
                                  ("fused_coordinate",
                                   "combine_bulyan_kernel")):
                    if key in ev.key:
                        dev_ms[name] = dev_ms.get(name, 0.0) + t_us / 1e3
            dev_ms["busy"] = sum(by_kernel.values())
            dev_ms["top"] = sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1])[:8]
        losses.append(float(m["loss"]))
        expect(math.isfinite(losses[-1]), f"{cfg.name}: loss {losses[-1]}")
    counts = dict(build.LAUNCHES)
    del params, state
    return {"losses": losses, "step_ms": step_ms, "launches": counts,
            "device_ms": dev_ms}


def phase_llm_full(torch, rt, ops, timer, smi):
    """8a: gemma3-1b at full width, 8 layers, n = 7, f = 1,
    ``bulyan-krum`` over the ``fused`` backend, ``omniscient_linf``,
    AdamW 3e-4, one sequence of 1,024 tokens per worker."""
    import dataclasses
    import numpy as np
    cfg = dataclasses.replace(rt["get_config"](LLM_ARCH),
                              n_layers=LLM_LAYERS)
    expect(cfg.n_periods == 1 and cfg.n_tail == 2,
           f"8a: {cfg.n_periods} periods, {cfg.n_tail} tail layers")
    spec = rt["DistByzantineSpec"](f=LLM_F, gar="bulyan-krum",
                                   attack="omniscient_linf",
                                   distance_backend="fused")
    torch.cuda.reset_peak_memory_stats()
    params = rt["init_model"](0, cfg, device="cuda")
    leaves = rt["tree_leaves"](params)
    n_params = sum(p.numel() for p in leaves)
    expect(len(leaves) == LLM_LEAVES and n_params == LLM_PARAMS,
           f"8a: {len(leaves)} leaves, {n_params:,} parameters")
    expect(n_params == cfg.param_count(),
           f"8a: param_count {cfg.param_count():,} vs {n_params:,}")
    embed_d = cfg.vocab_size * cfg.d_model
    print(f"  8a {cfg.name} x {LLM_LAYERS} layers: {n_params:,} parameters "
          f"in {len(leaves)} leaves; embedding leaf ({LLM_N}, {embed_d:,}) "
          f"= {LLM_N * embed_d:,} elements", flush=True)

    # step 0's submissions: fused against xla, the embedding leaf, a
    # strided leaf (comparison launches, outside the counted runs)
    loss_fn = rt["make_loss_fn"](cfg)
    batch = llm_batch(np, rt, cfg, 0, LLM_SEQ)
    t0 = time.perf_counter()
    _, grads = rt["byzantine_grads"](loss_fn, spec, params, batch, 0,
                                     worker_chunk=1)
    torch.cuda.synchronize()
    print(f"  8a step-0 submissions in {time.perf_counter() - t0:.2f} s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    _, _, worst = llm_tree_check(torch, rt, grads, "bulyan-krum",
                                 LLM_LEAVES, "8a step 0")
    print(f"  ok  8a step 0: fused == xla at {worst:.2e} of each leaf's "
          f"largest entry, selected equal, launches K1 {LLM_LEAVES}, "
          f"select 1, K4 {LLM_LEAVES}", flush=True)
    rows = llm_embedding_leaf(torch, rt, ops, grads["embed"]["table"],
                              grads, timer)
    llm_strided_leaf(torch, ops, grads["final_norm"]["scale"])
    del grads, params, leaves
    torch.cuda.empty_cache()

    run_a = llm_run(torch, rt, cfg, spec, LLM_STEPS, LLM_SEQ, 1, seed=0)
    want = per_step({"pairwise_gram_partial": LLM_LEAVES,
                     "select_weights": 1,
                     "fused_coordinate": LLM_LEAVES}, LLM_STEPS)
    expect_launches(run_a["launches"], want, "8a 3 steps")
    run_b = llm_run(torch, rt, cfg, spec, LLM_STEPS, LLM_SEQ, 1, seed=0,
                    profile_last=True)
    expect(run_a["losses"] == run_b["losses"],
           f"8a: losses {run_a['losses']} vs a second run "
           f"{run_b['losses']}")
    med = statistics.median(run_a["step_ms"])
    print(f"  ok  8a 3 steps: losses {run_a['losses']} finite and equal to "
          f"a second run's bit for bit; launches {run_a['launches']} "
          f"(K1 {LLM_LEAVES}, select 1, K4 {LLM_LEAVES} per step)",
          flush=True)
    print(f"  8a ms per step: median {med:.1f} of "
          f"{[round(t, 1) for t in run_a['step_ms']]} (second run "
          f"{[round(t, 1) for t in run_b['step_ms']]}); device time per "
          f"step K1 {run_b['device_ms'].get('pairwise_gram_partial', 0):.3f}"
          f" ms, K4 {run_b['device_ms'].get('fused_coordinate', 0):.3f} ms "
          f"(torch.profiler, last step of the second run); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({smi})",
          flush=True)
    busy, last = run_b["device_ms"]["busy"], run_b["step_ms"][-1]
    print(f"  8a profiled step: device busy {busy:.1f} ms of {last:.1f} ms "
          f"({100 * busy / last:.1f}%); top device time:", flush=True)
    for key, ms in run_b["device_ms"]["top"]:
        print(f"    {ms:9.3f} ms  {key[:110]}", flush=True)
    return {"rows": rows, "launches": run_a["launches"], "step_ms": med,
            "device_ms": run_b["device_ms"]}


def phase_llm_reduced(torch, rt):
    """8b: one reduced config of every other family, 2 steps of
    ``fused-bulyan-krum`` over the ``fused`` backend under
    ``omniscient_linf``, step 0's aggregate against ``xla`` and exact
    launches per step."""
    import numpy as np
    spec = rt["DistByzantineSpec"](f=LLM_F, gar="fused-bulyan-krum",
                                   attack="omniscient_linf",
                                   distance_backend="fused")
    seq = 64
    for arch in LLM_OTHERS:
        cfg = rt["get_reduced"](arch)
        expect(cfg.param_dtype == "float32", f"8b {arch}: {cfg.param_dtype}")
        params = rt["init_model"](0, cfg, device="cuda")
        n_leaves = len(rt["tree_leaves"](params))
        _, grads = rt["byzantine_grads"](rt["make_loss_fn"](cfg), spec,
                                         params, llm_batch(np, rt, cfg, 0,
                                                           seq), 0)
        _, _, worst = llm_tree_check(torch, rt, grads, "fused-bulyan-krum",
                                     n_leaves, f"8b {arch} step 0")
        del grads, params
        run = llm_run(torch, rt, cfg, spec, 2, seq, None, seed=0)
        want = per_step({"pairwise_gram_partial": n_leaves,
                         "select_weights": 1,
                         "fused_coordinate": n_leaves}, 2)
        expect_launches(run["launches"], want, f"8b {arch} 2 steps")
        print(f"  ok  8b {cfg.name} ({cfg.arch_type}, {n_leaves} leaves): "
              f"step 0 fused == xla at {worst:.2e}, selected equal; losses "
              f"{[round(v, 4) for v in run['losses']]}; launches per step "
              f"K1 {n_leaves}, select 1, K4 {n_leaves}; ms per step "
              f"{[round(t, 1) for t in run['step_ms']]}", flush=True)


# ---------------------------------------------------------------------------
# phase 9: serving (the zoo's decode path, the ensemble engine, verify)
# ---------------------------------------------------------------------------

#: 9a: 8a's cut and seed, an ensemble of 7 with the last replica poisoned
SERVE_N, SERVE_F, SERVE_SLOTS, SERVE_CACHE = 7, 1, 4, 1024
SERVE_GAR = "bulyan-krum"
#: 9b: llama3.2-3b at its published widths, 28 layers cut to 2
SPEC_ARCH, SPEC_LAYERS, SPEC_K, SPEC_PARAMS = "llama3_2_3b", 2, 4, 595_344_384
#: the kernels K5 runs, and its counter's reading for one call
K5_CALL = {"pairwise_gram_partial": 1, "select_weights": 1,
           "fused_coordinate": 1, "fused_aggregate": 3}


def attn_calls(cfg) -> int:
    """Decode-attention launches of one decode step or verify block: one
    per attention layer, two for an ``xattn`` layer, none for Mamba."""
    slots = [cfg.slot(i) for i in range(cfg.n_layers)]
    return sum((s != "mamba") + (s == "xattn") for s in slots)


def call_launches(per_call: dict, kind: str, k: int = 1,
                  attn: int = 0) -> dict:
    """Every counter's expected value for one call of ``kind``: an
    admission launches ``per_call``; a decode step that and ``attn``
    decode attentions; a verify block ``k`` times ``per_call`` and
    ``attn``."""
    want = per_step(per_call, k if kind == "verify" else 1)
    if kind != "admit":
        want["decode_attention"] = attn
    return want


def serve_spec(rt, **kw):
    return rt["AggSpec"](f=SERVE_F, gar=SERVE_GAR, distance_backend="fused",
                         **kw)


def serve_requests(np, vocab: int, count: int, seed: int, plen, new):
    """``count`` requests ``(rid, prompt, max_new_tokens)`` from a seed."""
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, int(rng.integers(plen[0],
                                                          plen[1] + 1))
                               ).astype(np.int32),
             int(rng.integers(new[0], new[1] + 1))) for rid in range(count)]


def poisoned_ensemble(torch, rt, cfg, seed: int):
    """``SERVE_N`` replicas of ``init_model(seed)`` on the card, jittered
    at 1e-3 from a CPU generator, the last ``SERVE_F`` sign-flipped at
    scale 10."""
    params = rt["init_model"](seed, cfg, device="cuda")
    honest = rt["replicate_params"](
        params, SERVE_N, jitter=1e-3,
        generator=torch.Generator().manual_seed(seed))
    del params
    stacked = rt["poison_replicas"](honest, SERVE_F, "signflip", scale=10.0)
    del honest
    torch.cuda.empty_cache()
    return stacked


class Probe:
    """Wraps an engine's robust steps (``_ens_prefill``, ``_decode``,
    ``_verify``): the launches of each call (counter differences, so a
    run's totals stay readable around it), host ms per call ending in a
    synchronize, and the poisoned replica's selection weight, which must
    be 0 in every aggregation.  ``hook(args)`` runs before a decode call,
    outside its launch window."""

    def __init__(self, torch, rt, eng, hook=None):
        self.torch, self.build = torch, rt["build"]
        self.calls = {"admit": [], "decode": [], "verify": []}
        self.hook = hook
        for kind, attr in (("admit", "_ens_prefill"), ("decode", "_decode"),
                           ("verify", "_verify")):
            if hasattr(eng, attr):
                setattr(eng, attr, self.wrap(getattr(eng, attr), kind))

    def wrap(self, fn, kind):
        torch, build = self.torch, self.build

        def call(*args):
            if kind == "decode" and self.hook is not None:
                self.hook(args)
            torch.cuda.synchronize()
            before = dict(build.LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            diff = {k: build.LAUNCHES[k] - before[k] for k in before}
            sel = out[2].selected
            byz = float(sel[..., SERVE_N - SERVE_F:].abs().sum())
            self.calls[kind].append({"launches": diff, "ms": ms,
                                     "byz": byz})
            return out

        return call

    def check(self, per_call: dict, what: str, k: int = 1,
              attn: int = 0) -> None:
        """Each admission and decode step launches ``per_call``, each
        verify block ``k`` times that, and each decode step and verify
        block ``attn`` decode attentions besides; no aggregation selects
        the poisoned replica."""
        for kind, calls in self.calls.items():
            want = call_launches(per_call, kind, k, attn)
            for i, c in enumerate(calls):
                expect_launches(c["launches"], want, f"{what} {kind} {i}")
                expect(c["byz"] == 0.0, f"{what} {kind} {i}: the poisoned "
                       f"replica has selection weight {c['byz']}")


def serve_run(torch, rt, cfg, params, reqs, spec, n_slots=SERVE_SLOTS,
              cache_len=SERVE_CACHE, hook=None):
    """One engine run: streams, the probe, wall seconds and the engine."""
    eng = rt["ServingEngine"](params, cfg, n_slots=n_slots,
                              cache_len=cache_len, ensemble=spec)
    probe = Probe(torch, rt, eng, hook)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run([rt["Request"](rid, p, m) for rid, p, m in reqs],
                  max_steps=400)
    torch.cuda.synchronize()
    return out, probe, time.perf_counter() - t0, eng


def device_profile(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall ms, device busy ms,
    K5's device ms (its three kernels) and the top device entries."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0 and "/" not in ev.key:
            rows.append((us / 1e3, ev.key))
    rows.sort(reverse=True)
    k5 = sum(ms for ms, key in rows
             if any(k in key for k in ("gram_kernel", "select_kernel",
                                       "combine_bulyan_kernel")))
    return {"wall": wall, "busy": sum(ms for ms, _ in rows), "k5": k5,
            "top": rows[:8]}


def serve_kernel_rows(torch, ops, timer, x) -> dict:
    """K1, the selection, K4 and K5 on a decode step's (n, B V) logits
    stack: each against its plain version (1e-4 of the largest entry;
    selections exactly), its time, its plain version's, its bound and a
    library call where one computes the same function."""
    pg, fa = ops["pairwise_gram"], ops["fused_agg"]
    n, d, f, mode = x.shape[0], x.shape[1], SERVE_F, SERVE_GAR
    raw = pg.pairwise_gram_partial(x)
    k1_err, k1_rel, _ = scaled_err(raw, pg.pairwise_gram_partial_plain(x))
    w, sel, _ = fa.select_weights(raw, n, f, mode)
    wp, selp, _ = fa.select_weights_plain(raw, n, f, mode)
    expect(torch.equal(w, wp) and torch.equal(sel, selp),
           "9a: the selection differs from its plain version")
    k4_err, k4_rel, _ = scaled_err(fa.fused_coordinate(x, w, f, mode=mode),
                                   fa.fused_coordinate_plain(x, wp, f,
                                                             mode=mode))
    got, want = fa.fused_aggregate(x, f, mode=mode), \
        fa.fused_aggregate_plain(x, f, mode=mode)
    k5_err, k5_rel, _ = scaled_err(got[0], want[0])
    expect(torch.equal(got[1], want[1]), "9a: K5's selected differs")
    for name, rel in (("K1", k1_rel), ("K4", k4_rel), ("K5", k5_rel)):
        expect(rel <= FP32_TOL, f"9a {name} on the serve stack: {rel:.3e}")
    table = {
        "pairwise_gram_partial": (
            lambda: pg.pairwise_gram_partial(x),
            lambda: pg.pairwise_gram_partial_plain(x),
            lambda: torch.mm(x, x.T), k1_err, k1_rel),
        "select_weights": (
            lambda: fa.select_weights(raw, n, f, mode),
            lambda: fa.select_weights_plain(raw, n, f, mode), None, 0.0,
            0.0),
        "fused_coordinate": (
            lambda: fa.fused_coordinate(x, w, f, mode=mode),
            lambda: fa.fused_coordinate_plain(x, wp, f, mode=mode), None,
            k4_err, k4_rel),
        "fused_aggregate": (
            lambda: fa.fused_aggregate(x, f, mode=mode),
            lambda: fa.fused_aggregate_plain(x, f, mode=mode), None,
            k5_err, k5_rel),
    }
    rows = {}
    for name, (kern, plain, lib, err, rel) in table.items():
        rows[name] = {"ms": timer.ms(kern, 20),
                      "plain_ms": timer.ms(plain, 3, warmup=1),
                      "library_ms": None if lib is None else timer.ms(lib,
                                                                      20),
                      "max_abs_err": err, **bound(n, d, f, name, 4)}
        r = rows[name]
        lib_s = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  9a {name:22s} kernel {r['ms']:8.4f} ms  plain "
              f"{r['plain_ms']:8.4f} ms  library {lib_s} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); max abs err "
              f"{err:.3e} ({rel:.2e} of the largest entry)", flush=True)
    return rows


def phase_serve_full(torch, np, rt, ops, timer, smi):
    """9a: gemma3-1b at full width (8a's cut and seed) served by an
    ensemble of 7 (the last replica poisoned) through
    ``ServingEngine(ensemble=bulyan-krum over fused)``: 6 requests on 4
    slots, so slots are reused."""
    import dataclasses
    cfg = dataclasses.replace(rt["get_config"](LLM_ARCH),
                              n_layers=LLM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = poisoned_ensemble(torch, rt, cfg, 0)
    n_params = sum(p[0].numel() for p in rt["tree_leaves"](params))
    expect(n_params == LLM_PARAMS, f"9a: {n_params:,} parameters")
    print(f"  9a {cfg.name} x {LLM_LAYERS} layers: {n_params:,} parameters "
          f"per replica, {SERVE_N} replicas (last poisoned) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reqs = serve_requests(np, cfg.vocab_size, 6, 9, (32, 256), (16, 32))
    spec = serve_spec(rt)
    n_tokens = sum(m for _, _, m in reqs)

    # run A: the counted main path, counters from 0 just before, read
    # just after
    torch.cuda.synchronize()
    rt["build"].reset_launches()
    run_a, probe_a, secs_a, _ = serve_run(torch, rt, cfg, params, reqs, spec)
    totals = dict(rt["build"].LAUNCHES)
    attn = attn_calls(cfg)
    probe_a.check(K5_CALL, "9a", attn=attn)
    n_dec, n_adm = len(probe_a.calls["decode"]), len(probe_a.calls["admit"])
    expect(n_adm == len(reqs), f"9a: {n_adm} admissions")
    expect_launches(totals, dict(per_step(K5_CALL, n_dec + n_adm),
                                 decode_attention=n_dec * attn), "9a run")
    expect(all(len(run_a[r]) == m for r, _, m in reqs),
           "9a: a stream has the wrong length")
    print(f"  ok  9a {n_dec} decode steps and {n_adm} admissions: each "
          f"exactly K1 1, select 1, K4 1 (K5 counter 3), K2 / K3 0, and "
          f"each decode step {attn} decode attentions; the poisoned replica "
          f"never selected; totals {totals}", flush=True)

    # run B: the repeat, with the first decode step's stack held to the
    # xla backend and one later step profiled (outside run A)
    seen = {"stack": None}

    def first_step(args):
        if seen["stack"] is not None:
            return
        p, c, tok, pos, _ = args
        logits, _ = torch.func.vmap(lambda pp, cc: rt["decode_step"](
            pp, cfg, cc, tok, pos))(p, c)
        stack = logits[:, :, 0, :].to(torch.float32)
        agg_f, res_f = rt["aggregate_logits"](stack, SERVE_F, SERVE_GAR,
                                              distance_backend="fused")
        agg_x, res_x = rt["aggregate_logits"](stack, SERVE_F, SERVE_GAR,
                                              distance_backend="xla")
        err, rel, scale = scaled_err(agg_f, agg_x)
        expect(rel <= FP32_TOL, f"9a first step: fused vs xla {rel:.3e} "
               f"of {scale:.4e}")
        expect(torch.equal(res_f.selected, res_x.selected),
               f"9a first step: selected {res_f.selected.tolist()} vs xla "
               f"{res_x.selected.tolist()}")
        n_diff = int((agg_f != agg_x).sum())
        print(f"  ok  9a first decode step ({SERVE_N}, {stack[0].numel():,})"
              f": fused == xla at {rel:.2e} of its largest entry "
              f"({scale:.4f}; {n_diff} of {agg_f.numel():,} coordinates not "
              f"bit-equal), selected equal {res_f.selected.tolist()}",
              flush=True)
        seen["stack"] = stack.reshape(SERVE_N, -1).contiguous()

    run_b, _, secs_b, _ = serve_run(torch, rt, cfg, params, reqs, spec,
                                    hook=first_step)
    expect(run_b == run_a, "9a: a second run gave other streams")
    print(f"  ok  9a a second run gives the same {len(reqs)} streams bit for "
          f"bit", flush=True)

    # one request alone, then telemetry on
    solo, _, _, _ = serve_run(torch, rt, cfg, params, reqs[:1], spec)
    expect(solo[0] == run_a[0], f"9a: request 0 alone {solo[0]} vs in the "
           f"batch {run_a[0]}")
    run_c, probe_c, _, eng_c = serve_run(
        torch, rt, cfg, params, reqs, serve_spec(rt, telemetry=True))
    expect(run_c == run_a, "9a: telemetry=True changed the streams")
    pushed = eng_c.telemetry()["pushed"]
    expect(pushed == len(probe_c.calls["decode"]),
           f"9a: telemetry pushed {pushed} rows for "
           f"{len(probe_c.calls['decode'])} aggregations")
    probe_c.check(K5_CALL, "9a telemetry", attn=attn)
    print(f"  ok  9a request 0 alone == in the batch; telemetry on == off "
          f"bit for bit, {pushed} rows pushed == decode aggregations",
          flush=True)

    # readings: host ms per step, tokens/s, prefill ms, the profile
    dec_ms = [c["ms"] for c in probe_a.calls["decode"]]
    adm_ms = [c["ms"] for c in probe_a.calls["admit"]]
    state = {}

    def capture(args):
        state["args"] = args

    eng = rt["ServingEngine"](params, cfg, n_slots=SERVE_SLOTS,
                              cache_len=SERVE_CACHE, ensemble=spec)
    for rid, p, m in reqs[:SERVE_SLOTS]:
        eng.submit(rt["Request"](rid, p, m))
    eng.step()
    eng.step()
    step_fn = eng._decode
    tokens = torch.as_tensor(eng.last_token, device="cuda")[:, None]
    prof = device_profile(torch, lambda: step_fn(
        eng.params, eng.cache, tokens, eng.positions.copy(), eng.agg_state))
    del eng
    avg, _, _, _ = serve_run(torch, rt, cfg, params, reqs[:SERVE_SLOTS],
                             rt["AggSpec"](f=SERVE_F, gar="average"))
    steered = any(avg[r] != run_a[r] for r, _, _ in reqs[:SERVE_SLOTS])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  9a ms per decode step: median {statistics.median(dec_ms):.2f} "
          f"(min {min(dec_ms):.2f}, max {max(dec_ms):.2f}, {len(dec_ms)} "
          f"steps); prefill ms per admission: median "
          f"{statistics.median(adm_ms):.2f} (prompts "
          f"{[len(p) for _, p, _ in reqs]}); {n_tokens} tokens in "
          f"{secs_a:.2f} s = {n_tokens / secs_a:.1f} tokens/s (run A; run B "
          f"{secs_b:.2f} s); peak memory {peak:.1f} GiB ({smi})", flush=True)
    print(f"  9a profiled decode step: wall {prof['wall']:.2f} ms, device "
          f"busy {prof['busy']:.3f} ms ({100 * prof['busy'] / prof['wall']:.1f}"
          f"%), K5 (K1 + select + K4) {prof['k5']:.4f} ms; top device time:",
          flush=True)
    for ms, key in prof["top"]:
        print(f"    {ms:9.4f} ms  {key[:100]}", flush=True)
    print(f"  9a average on the poisoned ensemble steered: "
          f"{'YES' if steered else 'NO'} (printed, not gated)", flush=True)
    rows = serve_kernel_rows(torch, ops, timer, seen["stack"])
    del params, seen
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": totals,
            "step_ms": statistics.median(dec_ms)}


def phase_serve_speculative(torch, np, rt, smi):
    """9b: speculative verify at llama3.2-3b's published widths cut to 2
    layers (gemma3-1b's swa slots fail ``verify_supported``): k = 1
    against the per-token engine bit for bit, then k = 4 with the draft
    on replica 0."""
    import dataclasses
    cfg = dataclasses.replace(rt["get_config"](SPEC_ARCH),
                              n_layers=SPEC_LAYERS)
    ok, why = rt["verify_supported"](cfg)
    expect(ok, f"9b: {why}")
    gemma = rt["verify_supported"](rt["get_config"](LLM_ARCH))
    expect(not gemma[0], "9b: gemma3-1b passed verify_supported")
    t0 = time.perf_counter()
    params = poisoned_ensemble(torch, rt, cfg, 1)
    n_params = sum(p[0].numel() for p in rt["tree_leaves"](params))
    expect(n_params == SPEC_PARAMS, f"9b: {n_params:,} parameters")
    print(f"  9b {cfg.name} x {SPEC_LAYERS} layers: {n_params:,} parameters "
          f"per replica x {SERVE_N} built in {time.perf_counter() - t0:.1f} "
          f"s; gemma3-1b refused: {gemma[1]}", flush=True)
    reqs = serve_requests(np, cfg.vocab_size, 4, 11, (32, 64), (16, 24))
    per_token, probe_p, secs_p, _ = serve_run(torch, rt, cfg, params, reqs,
                                              serve_spec(rt), cache_len=512)
    attn = attn_calls(cfg)
    probe_p.check(K5_CALL, "9b per-token", attn=attn)
    k1, probe_1, _, _ = serve_run(torch, rt, cfg, params, reqs,
                                  serve_spec(rt, speculative_k=1),
                                  cache_len=512)
    expect(k1 == per_token, "9b: k = 1 differs from the per-token engine")
    probe_1.check(K5_CALL, "9b k = 1", k=1, attn=attn)
    print(f"  ok  9b k = 1 == the per-token engine bit for bit "
          f"({sum(len(v) for v in k1.values())} tokens)", flush=True)

    spec = serve_spec(rt, speculative_k=SPEC_K, draft_replica=0)
    eng = rt["ServingEngine"](params, cfg, n_slots=SERVE_SLOTS,
                              cache_len=512, ensemble=spec)
    probe = Probe(torch, rt, eng)
    accept = eng._accept
    worst = {"gap": 0.0}

    def checked_accept(block, agg_logits, **kw):
        emitted, count, v = accept(block, agg_logits, **kw)
        c = count.cpu()
        expect(bool(((c >= 1) & (c <= SPEC_K)).all()),
               f"9b: counts {c.tolist()} outside [1, {SPEC_K}]")
        top = agg_logits.amax(dim=-1)
        got = torch.gather(agg_logits, -1, emitted.long()[..., None])[..., 0]
        valid = torch.arange(SPEC_K, device=c.device)[None, :] < c[:, None]
        gap = float(((top - got).cpu() * valid).max())
        worst["gap"] = max(worst["gap"], gap)
        expect(gap <= 0.0, f"9b: an emitted token trails its position's "
               f"aggregated maximum by {gap}")
        return emitted, count, v

    eng._accept = checked_accept
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec_out = eng.run([rt["Request"](rid, p, m) for rid, p, m in reqs],
                       max_steps=400)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    probe.check(K5_CALL, f"9b k = {SPEC_K}", k=SPEC_K, attn=attn)
    tel = eng.telemetry()
    agree = []
    for rid, _, m in reqs:
        a, b = spec_out[rid], per_token[rid]
        expect(len(a) == m, f"9b: request {rid} has {len(a)} tokens")
        same = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    len(a))
        agree.append(same / m)
    blocks = len(probe.calls["verify"])
    print(f"  ok  9b k = {SPEC_K}: {blocks} verify blocks, each exactly "
          f"K1 {SPEC_K}, select {SPEC_K}, K4 {SPEC_K} (K5 counter "
          f"{3 * SPEC_K}); counts in [1, {SPEC_K}]; every emitted token at "
          f"its position's aggregated maximum (worst gap {worst['gap']})",
          flush=True)
    vms = [c["ms"] for c in probe.calls["verify"]]
    print(f"  9b accept mean {tel['accept_mean']:.3f} tokens per block; the "
          f"k = {SPEC_K} stream agrees with the per-token stream up to "
          f"{[round(a, 3) for a in agree]} of each request; ms per verify "
          f"block median {statistics.median(vms):.2f}; {secs:.2f} s for the "
          f"run vs {secs_p:.2f} s per-token ({smi})", flush=True)
    del params, eng
    torch.cuda.empty_cache()


def phase_serve_reduced(torch, np, rt):
    """9c: every family's ``reduced()`` config: the robust prefill step
    and 4 robust decode steps on the card, with exact launches per call
    and finite aggregates."""
    spec = serve_spec(rt)
    for arch in (LLM_ARCH,) + LLM_OTHERS:
        cfg = rt["get_reduced"](arch)
        params = rt["replicate_params"](
            rt["init_model"](0, cfg, device="cuda"), SERVE_N, jitter=1e-3,
            generator=torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)),
                                 dtype=torch.int32, device="cuda")
        extra = None
        if cfg.arch_type in ("audio", "vlm"):
            extra = torch.as_tensor(rng.standard_normal(
                (2, cfg.encoder_seq or cfg.vision_seq, cfg.d_model)),
                dtype=torch.float32, device="cuda")
        prefill = rt["make_robust_prefill_step"](cfg, spec, cache_len=16)
        step = rt["make_robust_serve_step"](cfg, spec)
        (agg, cache, _), counts = counted(
            torch, rt["build"], lambda: prefill(params, tokens, extra))
        expect_launches(counts, per_step(K5_CALL), f"9c {arch} prefill")
        token = torch.argmax(agg, dim=-1).to(torch.int32)[:, None]
        for t in range(4):
            pos = np.full((2,), 8 + t, np.int32)
            (agg, cache, _, _), counts = counted(
                torch, rt["build"], lambda: step(params, cache, token, pos))
            expect_launches(counts, call_launches(
                K5_CALL, "decode", attn=attn_calls(cfg)),
                f"9c {arch} decode {t}")
            expect(bool(torch.isfinite(agg).all()),
                   f"9c {arch}: a non-finite aggregate")
            token = torch.argmax(agg, dim=-1).to(torch.int32)[:, None]
        print(f"  ok  9c {cfg.name} ({cfg.arch_type}): prefill + 4 decode "
              f"steps of the robust ensemble, K1 1 / select 1 / K4 1 per "
              f"call, finite", flush=True)
        del params, cache


# ---------------------------------------------------------------------------
# phases 9d / 9e: sharded serving (gloo ranks sharing the card)
# ---------------------------------------------------------------------------

#: 9d: 8a's gemma3-1b cut, 8 replicas, on a (2, 1) mesh (4 per rank) and
#: then a (1, 2) mesh of the same two ranks (the model halves of all 8
#: replicas per rank, the split forward, the vocabulary split); 9e:
#: reduced llama3.2-3b, 8 replicas on (2, 2), split the same way
SHARD_SERVE_N, SHARD_SERVE_FULL, SHARD_SERVE_MODEL, SHARD_SERVE_REDUCED = (
    8, (2, 1), (1, 2), (2, 2))
#: the K1-only launches of one aggregation under a model axis
K1_CALL = {"pairwise_gram_partial": 1}


def shard_serve_settings(np, rt):
    """9d's and 9e's ``torch_serve_mesh_check.serve_rank`` settings."""
    import dataclasses
    full = dataclasses.replace(rt["get_config"](LLM_ARCH),
                               n_layers=LLM_LAYERS)
    reduced = rt["get_reduced"](MESH_ARCH)
    d = dict(arch=LLM_ARCH, layers=LLM_LAYERS, n=SHARD_SERVE_N, f=SERVE_F,
             seed=0, reqs=serve_requests(np, full.vocab_size, 6, 9,
                                         (32, 256), (16, 32)),
             slots=SERVE_SLOTS, cache_len=SERVE_CACHE, runs=("token",))
    e = dict(arch=MESH_ARCH, layers=None, n=SHARD_SERVE_N, f=SERVE_F,
             seed=1, reqs=serve_requests(np, reduced.vocab_size, 6, 11,
                                         (8, 24), (8, 12)),
             slots=SERVE_SLOTS, cache_len=64,
             runs=("token", "spec", "telemetry"))
    return d, e


def hold_streams(rt, got: dict, want: dict, what: str) -> int:
    """``got``'s streams against ``want``'s token for token by the
    serving tests' rule (``torch_serving_compare``), a parting let off
    after a near-tie in either run and printed; returns their count."""
    return rt["serving_compare"].assert_streams_match(
        want["streams"], got["streams"], (got["gaps"], want["gaps"]),
        log=lambda line: print(f"  {what}: {line}", flush=True))


def hold_first_step(run: dict, single: dict, what: str) -> tuple:
    """A sharded run's first decode step: the gathered stack against the
    single-device run's, and ``aggregate_logits`` on one device on that
    stack (under the backend the mesh resolves) giving the step's
    selection and aggregate bit for bit and its scores at 1e-4.

    The honest replicas' rows are held at 1e-4 of their largest entry.
    The poisoned replicas' rows (the last ``SERVE_F``, which every
    aggregation discards) are held on one set of inputs: the
    single-device run's first decode step (its token, positions and
    that replica's cache), which this rank's path also runs
    (``on_shared``).  A replica whose weights are sign-flipped and
    scaled by 10 has attention scores 100 times the honest ones, so its
    row follows rounding far more than theirs, and the two runs' caches
    (each written by its own prefill) part by rounding too: on those
    they would be held against two different exact steps.  On the
    shared inputs, the rank's row and one device's each lie within
    ``POISONED_TOL`` of their largest entry from the same step in
    float64 (so within twice that of each other).  Printed besides: the
    two rows' distance, the rows of the two runs' own stacks, each
    run's row against float64 on its own cache, and how far the float64
    steps on the two caches part.
    Returns the errors as a line and the poisoned rows this rank held
    on the shared inputs."""
    got, want = run["stack"].double(), single["stack"].double()
    honest = want.shape[0] - SERVE_F
    err = float((got[:honest] - want[:honest]).abs().max())
    rel = err / float(want[:honest].abs().max())
    expect(rel <= FP32_TOL, f"{what}: the honest replicas' rows of the "
           f"gathered stack are {rel:.3e} of their largest entry off one "
           f"device's")
    line = [f"honest rows {rel:.2e} of their largest entry"]
    one64 = dict(single["witness"])
    expect(sorted(one64) == list(range(honest, want.shape[0])),
           f"{what}: one device's float64 witness {single['witness']}")
    held = []
    for i, sh in run["on_shared"]:
        own = float(want[i].abs().max())
        one = one64[i] / own
        off = sh["off64"] / own
        e = float((sh["row"].double() - want[i]).abs().max()) / own
        for name, x in (("one device's row", one),
                        ("this rank's row", off)):
            expect(x <= POISONED_TOL, f"{what}: the poisoned replica "
                   f"{i}: {name} is {x:.3e} of its largest entry off the "
                   f"step in float64 on one device's inputs")
        stacks = float((got[i] - want[i]).abs().max()) / own
        w = dict(run["witness"])[i] / own
        line.append(f"poisoned row {i} on one device's inputs {e:.2e} of "
                    f"its own off one device's, {off:.2e} off float64 "
                    f"(one device's {one:.2e}); on the runs' own caches "
                    f"{stacks:.2e} off one device's, {w:.2e} off float64 "
                    f"on its own, the float64 steps on the two caches "
                    f"{sh['caches64'] / own:.2e} apart")
        held.append(i)
    expect(run["on_stack"], f"{what}: the step's aggregate or selection "
           f"differs from aggregate_logits on one device on the same stack")
    expect(run["on_stack_scores"] <= FP32_TOL, f"{what}: the step's scores "
           f"are {run['on_stack_scores']:.3e} of their largest off one "
           f"device's on the same stack")
    return ", ".join(line), held


def held_poisoned(held: list, single: dict, what: str) -> None:
    """Every poisoned row was held on the shared inputs by some rank."""
    rows = sorted(dict(single["witness"]))
    expect(sorted(set(held)) == rows, f"{what}: the poisoned rows {rows} "
           f"were held on one device's inputs by ranks holding {held}")


def check_serve_calls(run: dict, per_call: dict, what: str, k: int = 1,
                      attn: int = 0) -> None:
    """Each call launches what :func:`call_launches` gives; the poisoned
    replica has weight 0 in every aggregation; the run's counters (from
    0) are the calls' sum and the draft's ``k - 1`` decode steps per
    verify block, outside the calls."""
    total = {name: 0 for name in REPLACES}
    total["decode_attention"] = (k - 1) * attn * len(
        run["calls"].get("verify", ()))
    for kind, calls in run["calls"].items():
        want = call_launches(per_call, kind, k, attn)
        for i, c in enumerate(calls):
            expect_launches(c["launches"], want, f"{what} {kind} {i}")
            expect(c["byz"] == 0.0, f"{what} {kind} {i}: the poisoned "
                   f"replica has selection weight {c['byz']}")
            for name in total:
                total[name] += c["launches"][name]
    expect_launches(run["launches"], total, f"{what} run")


def print_serve_times(r: dict, run: dict, n_tok: int, what: str,
                      smi: str) -> None:
    """A rank's ms per decode step and admission, collectives, tokens/s
    (the probe's own host time left out) and memory."""
    dec = [c["ms"] for c in run["calls"]["decode"]]
    adm = [c["ms"] for c in run["calls"]["admit"]]
    cs = [c["comm_s"] * 1e3 for c in run["calls"]["decode"]]
    cb = [c["comm_bytes"] for c in run["calls"]["decode"]]
    print(f"  {what} rank {r['coords']}: ms per decode step median "
          f"{statistics.median(dec):.2f} (min {min(dec):.2f}, max "
          f"{max(dec):.2f}), of it in collectives median "
          f"{statistics.median(cs):.2f} ms for "
          f"{statistics.median(cb):,.0f} bytes of results; ms per "
          f"admission median {statistics.median(adm):.2f}; {n_tok} tokens "
          f"in {run['wall_s']:.2f} s = {n_tok / run['wall_s']:.1f} "
          f"tokens/s; {r['resident_gib']:.1f} GiB resident after the "
          f"build, peak {run['peak_gib']:.1f} GiB in the run; built in "
          f"{r['build_s']:.1f} s ({smi})", flush=True)


def check_share(r: dict, what: str) -> None:
    """A rank's engine holds its share of the ensemble: the bytes the
    serving layout gives it (its replicas' model slices, the leaves a
    layer reads whole kept whole), under 51% of its replicas whole."""
    lay = r["layout"]
    expect(r["share_bytes"] == lay["share"], f"{what}: the engine holds "
           f"{r['share_bytes']:,} B of parameters, its share is "
           f"{lay['share']:,} B")
    expect(lay["share"] < 0.51 * lay["whole"], f"{what}: a share of "
           f"{lay['share']:,} B for {lay['whole']:,} B of whole replicas")


def print_share(r: dict, run: dict, what: str, smi: str) -> None:
    """A rank's parameter bytes against its replicas whole, its memory
    around the build and the run, and the collectives of one decode
    step per kind (every decode step's the same)."""
    lay = r["layout"]
    kinds = [c["comm_kinds"] for c in run["calls"]["decode"]]
    expect(all(k == kinds[0] for k in kinds), f"{what}: decode steps ran "
           f"different collectives")
    print(f"  {what} rank {r['coords']}: parameters "
          f"{lay['share'] / 2 ** 30:.3f} GiB (its {r['n_local']} replicas "
          f"whole: {lay['whole'] / 2 ** 30:.3f} GiB; the leaves read whole "
          f"add {lay['read_whole']:,} B); resident "
          f"{r['resident_gib']:.2f} GiB after the build, peak "
          f"{run['peak_gib']:.2f} GiB in the run, {r['build_peak_gib']:.2f}"
          f" GiB while it built the whole ensemble and cut its share; per "
          f"decode step {kinds_line(kinds[0])} ({smi})", flush=True)


def hold_telemetry(np, torch, rt, mine: dict, other: dict, what: str):
    """A sharded run's telemetry rows against the single-device run's,
    row by row: where a row selects the replicas one device selected,
    every field at 1e-4 of its largest entry, and ``trimmed_frac`` off by
    no more window coordinates than have two values next to a trimmed
    range's bound within twice the two runs' largest difference in the
    window, on either run's stack; elsewhere the selection must be one
    that fp32 rounding can pick on one of the two stacks.  Returns
    ``(rows whose selection differs, the largest relative error, the
    coordinates let off)``."""
    got, want = mine["telemetry"]["records"], other["telemetry"]["records"]
    expect(len(got) == len(want) == mine["sketch"]["rows"],
           f"{what}: {len(got)} telemetry rows, one device {len(want)}")
    sk, ot = mine["sketch"], other["sketch"]
    ties = rt["serve_mesh_check"].trim_ties
    flips, worst, let_off = [], 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g["selected"], w["selected"]):
            expect(ot["selected"][i] in sk["reachable"][i]
                   or sk["selected"][i] in ot["reachable"][i],
                   f"{what} telemetry row {i}: selection "
                   f"{sk['selected'][i]} vs one device's "
                   f"{ot['selected'][i]}, which rounding cannot explain "
                   f"(reachable {sk['reachable'][i]})")
            flips.append(i)
            continue
        for key in w:
            if key == "trimmed_frac":
                a, b = sk["windows"][i], ot["windows"][i]
                near = 2 * float((a.double() - b.double()).abs().max())
                moved = float(np.abs(g[key] - w[key]).max()) * a.shape[1]
                slack = ties(a, SERVE_F, near) + ties(b, SERVE_F, near)
                expect(moved <= slack + 0.5, f"{what} telemetry row {i}: "
                       f"trimmed_frac moved by {moved:.1f} coordinates, "
                       f"{slack} lie within {near:.3e} of a trimmed bound")
                let_off += round(moved)
                continue
            _, rel, _ = scaled_err(torch.as_tensor(g[key]),
                                   torch.as_tensor(w[key]))
            expect(rel <= FP32_TOL, f"{what} telemetry row {i}: {key} "
                   f"{rel:.3e} of its largest entry off one device's")
            worst = max(worst, rel)
    return flips, worst, let_off


def phase_shard_serve(torch, np, rt, smi):
    """9d and 9e: ``ServingEngine(mesh=)`` on gloo ranks sharing the card
    (``tests/torch_serve_mesh_check.py``'s rank functions), against the
    single-device engine on the same ensemble in a process of its own."""
    import dataclasses
    sm = rt["serve_mesh_check"]
    set_d, set_e = shard_serve_settings(np, rt)
    attn_d = attn_calls(dataclasses.replace(rt["get_config"](LLM_ARCH),
                                            n_layers=LLM_LAYERS))
    torch.cuda.empty_cache()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    print(f"  9d this process holds "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB of the card",
          flush=True)
    t0 = time.perf_counter()
    single_d, single_e = rt["run_on_mesh"](
        sm.serve_settings, (1, 1), args=([dict(set_d, single=True),
                                          dict(set_e, single=True)],),
        device="cuda", backend="gloo", timeout=600)[0]
    t_single = time.perf_counter() - t0
    sd = single_d["token"]

    # 9d: gemma3-1b at full width, on a (2, 1) mesh (K5 on every rank's
    # gathered stack), then a (1, 2) mesh of the same ranks (K1 on every
    # rank's vocabulary slice); each rank's poisoned rows also on the
    # single-device run's first decode step's inputs
    t0 = time.perf_counter()
    shared = dict(set_d, shared=sd["inputs"])
    res, res_m = zip(*rt["run_on_mesh"](
        sm.serve_settings, SHARD_SERVE_FULL,
        args=([dict(shared, time_k5=True),
               dict(shared, shape=SHARD_SERVE_MODEL, time_k1=True)],),
        device="cuda", backend="gloo", timeout=600))
    t_d = time.perf_counter() - t0
    n_tok = sum(m for _, _, m in set_d["reqs"])
    lines, held = [], []
    for r in res:
        what = f"9d rank {r['coords']}"
        run = r["token"]
        check_serve_calls(run, K5_CALL, what, attn=attn_d)
        expect(r["n_local"] == SHARD_SERVE_N // SHARD_SERVE_FULL[0],
               f"{what} holds {r['n_local']} replicas")
        line, rows = hold_first_step(run, sd, what)
        lines.append(f"rank {r['coords']['data']}: {line}")
        held += rows
        expect(run["streams"] == res[0]["token"]["streams"],
               f"{what}: streams differ from rank 0's")
    held_poisoned(held, sd, "9d")
    rel = "; ".join(lines)
    parted = hold_streams(rt, res[0]["token"], sd, "9d")
    run0 = res[0]["token"]
    print(f"  ok  9d {LLM_ARCH} x {LLM_LAYERS} layers, {SHARD_SERVE_N} "
          f"replicas on a {SHARD_SERVE_FULL} mesh ({res[0]['n_local']} per "
          f"rank): {len(run0['calls']['decode'])} decode steps and "
          f"{len(run0['calls']['admit'])} admissions per rank, each exactly "
          f"K1 1, select 1, K4 1 (one K5), K2 / K3 0; the poisoned replica "
          f"never selected; the first decode step's gathered "
          f"{tuple(run0['stack'].shape)} stack off the single-device "
          f"run's: {rel}; each rank's aggregate "
          f"and selection equal bit for bit to aggregate_logits on one "
          f"device on it; streams equal across ranks, {parted} parting(s) "
          f"from the single-device run", flush=True)
    for r in res:
        print_serve_times(r, r["token"], n_tok, "9d", smi)
    dec1 = [c["ms"] for c in sd["calls"]["decode"]]
    print(f"  9d single-device run (8 replicas, the card alone): ms per "
          f"decode step median {statistics.median(dec1):.2f}; {n_tok} "
          f"tokens in {sd['wall_s']:.2f} s = {n_tok / sd['wall_s']:.1f} "
          f"tokens/s; {single_d['resident_gib']:.1f} GiB resident, peak "
          f"{sd['peak_gib']:.1f} GiB in the run", flush=True)
    k5 = res[0]["k5"]
    n, d = k5["shape"]
    row = dict(ms=k5["ms"], plain_ms=k5["plain_ms"], library_ms=None,
               max_abs_err=k5["max_abs_err"],
               **bound(n, d, SERVE_F, "fused_aggregate", 4))
    for r in res:
        k = r["k5"]
        print(f"  ok  9d rank {r['coords']}: K5 on its {k['shape']} stack "
              f"{k['rel_err']:.2e} of the largest entry off its plain "
              f"version; {k['ms']:.4f} ms (CUDA events, the card alone), "
              f"plain {k['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']})", flush=True)
    out = {"k5_row": row, "k5_launches": run0["launches"]}

    # 9d, the model axis at full width: each rank holds the model halves
    # of all 8 replicas and decodes on them (the split forward); one K1
    # per aggregation per rank
    for r in res_m:
        what = f"9d model axis rank {r['coords']}"
        run = r["token"]
        check_serve_calls(run, K1_CALL, what, attn=attn_d)
        expect(r["n_local"] == SHARD_SERVE_N,
               f"{what} holds {r['n_local']} replicas")
        check_share(r, what)
        rel, rows = hold_first_step(run, sd, what)
        held_poisoned(rows, sd, what)
        expect(run["streams"] == res_m[0]["token"]["streams"],
               f"{what}: streams differ from rank 0's")
    parted = hold_streams(rt, res_m[0]["token"], sd, "9d model axis")
    k1 = res_m[0]["k1"]
    n, d = k1["shape"]
    row1 = dict(ms=k1["ms"], plain_ms=k1["plain_ms"],
                library_ms=k1["library_ms"], max_abs_err=k1["max_abs_err"],
                **bound(n, d, SERVE_F, K1_ONLY, 4))
    print(f"  ok  9d model axis: the model halves of all {SHARD_SERVE_N} "
          f"replicas per rank on a {SHARD_SERVE_MODEL} mesh of the same "
          f"ranks, decoding on the split forward; exactly one K1 per "
          f"aggregation per rank on its vocabulary slice {k1['shape']} "
          f"and no select / K4 / K5 / K2 / K3; the poisoned replica never "
          f"selected; the first decode step's stack off the single-device "
          f"run's: {rel}; each rank's "
          f"aggregate and selection equal bit for bit to aggregate_logits "
          f"on one device (pallas) on it; streams equal across ranks, "
          f"{parted} parting(s) from the single-device run", flush=True)
    for r in res_m:
        print_serve_times(r, r["token"], n_tok, "9d model axis", smi)
        print_share(r, r["token"], "9d model axis", smi)
        k = r["k1"]
        print(f"  ok  9d model axis rank {r['coords']}: K1 on its "
              f"{k['shape']} slice {k['rel_err']:.2e} of the largest entry "
              f"off its plain version; {k['ms']:.4f} ms (CUDA events, the "
              f"card alone), plain {k['plain_ms']:.4f} ms, torch.mm "
              f"{k['library_ms']:.4f} ms, bound {row1['bound_ms']:.5f} ms "
              f"({row1['bound_by']})", flush=True)
    print(f"  9d took {t_d:.1f} s (the single-device runs of 9d and 9e "
          f"{t_single:.1f} s)", flush=True)
    out.update(k1_row=row1, k1_launches=res_m[0]["token"]["launches"][
        K1_ONLY])
    # what phase 12b holds its prediction to: each rank's decode steps
    out["decode_calls"] = {
        shape: [{"coords": r["coords"], "peak_gib": r["token"]["peak_gib"],
                 "calls": [{k: c[k] for k in ("comm_kinds", "launches",
                                              "ms")}
                           for c in r["token"]["calls"]["decode"]]}
                for r in rs]
        for shape, rs in ((SHARD_SERVE_FULL, res), (SHARD_SERVE_MODEL,
                                                    res_m))}

    # 9e: the model axis on a (2, 2) mesh, verify, telemetry (F4)
    t0 = time.perf_counter()
    res = rt["run_on_mesh"](sm.serve_rank, SHARD_SERVE_REDUCED,
                            args=(dict(set_e, shared=single_e["token"][
                                "inputs"]),), device="cuda",
                            backend="gloo", timeout=600)
    t_e = time.perf_counter() - t0
    held = []
    for r in res:
        what = f"9e rank {r['coords']}"
        check_share(r, what)
        for name in set_e["runs"]:
            run = r[name]
            check_serve_calls(run, K1_CALL, f"{what} {name}",
                              k=sm.RUNS["spec"]["speculative_k"],
                              attn=attn_calls(rt["get_reduced"](MESH_ARCH)))
            expect(run["streams"] == res[0][name]["streams"],
                   f"{what} {name}: streams differ from rank 0's")
        held += hold_first_step(r["token"], single_e["token"], what)[1]
        expect(r["telemetry"]["streams"] == r["token"]["streams"],
               f"{what}: telemetry=True changed the streams")
        tel = r["telemetry"]["telemetry"]
        expect(tel["pushed"] == single_e["telemetry"]["telemetry"][
            "pushed"] > 0, f"{what}: {tel['pushed']} telemetry rows")
        # F4 on the card: each row is what one device records from the
        # step's gathered stack and aggregate, bit for bit
        sk = r["telemetry"]["sketch"]
        expect(sk["rows"] == tel["pushed"] and sk["differ"] == 0,
               f"{what}: {sk['differ']} of {sk['rows']} telemetry rows "
               f"differ from tree_diagnostics on one device")
    held_poisoned(held, single_e["token"], "9e")
    parts = {name: hold_streams(rt, res[0][name], single_e[name],
                                f"9e {name}")
             for name in set_e["runs"]}
    parted = sum(parts.values())
    rows = res[0]["telemetry"]["sketch"]["rows"]
    if parts["telemetry"]:
        versus = "not compared row by row with one device's: a stream parted"
    else:
        flips, worst, let_off = hold_telemetry(
            np, torch, rt, res[0]["telemetry"], single_e["telemetry"], "9e")
        versus = (f"against the single-device run's, the {rows - len(flips)}"
                  f" rows with its selection within {worst:.2e} of each "
                  f"field's largest entry, trimmed_frac moved by {let_off} "
                  f"coordinate(s) in all, each near a trimmed bound; "
                  f"{len(flips)} rows selecting another set that fp32 "
                  f"rounding can pick")
    print(f"  ok  9e telemetry: every rank's {rows} rows equal "
          f"tree_diagnostics on one device from the step's gathered stack "
          f"bit for bit; {versus}", flush=True)
    verify = [c["ms"] for c in res[0]["spec"]["calls"]["verify"]]
    decode = [c["ms"] for c in res[0]["token"]["calls"]["decode"]]
    print(f"  ok  9e {MESH_ARCH} reduced, {SHARD_SERVE_N} replicas on a "
          f"{SHARD_SERVE_REDUCED} mesh: per token, speculative k = "
          f"{sm.RUNS['spec']['speculative_k']} (draft replica 0) and with "
          f"telemetry, exactly one K1 per aggregation per rank on its "
          f"vocabulary slice and no select / K4 / K5 / K2 / K3; the first "
          f"decode step's aggregate and selection equal bit for bit to "
          f"aggregate_logits on one device (pallas) on its gathered "
          f"stack; streams equal across ranks and to the single-device "
          f"engine's ({parted} parting(s)); telemetry on == off; ms per "
          f"decode step median {statistics.median(decode):.2f}, per "
          f"verify block {statistics.median(verify):.2f}; {t_e:.1f} s "
          f"({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: the multi-rank runtime (gloo ranks sharing the card)
# ---------------------------------------------------------------------------

#: 10a: phase 8a's gemma3-1b cut on a (1, 2) mesh; 10b: reduced
#: llama3.2-3b on a (2, 2) mesh, 8 workers; momentum SGD in both
MESH_FULL, MESH_REDUCED, MESH_POD = (1, 2), (2, 2), (2, 1, 2)
MESH_ARCH, MESH_N, MESH_STEPS, MESH_LR = "llama3_2_3b", 8, 2, 1e-2
#: 10b's sequences per worker: the model axis splits the attention by
#: them (2 over 2 ranks); the pod world's pod axis halves 4 first
MESH_PER_WORKER, POD_PER_WORKER = 2, 4
#: 10a's peak allocation per rank when each pass gathered the whole
#: parameter tree (measured on an H100 80GB HBM3 at 700 W; PERF.md §6)
MESH_FULL_PEAK_BEFORE_GIB = 20.27
K1_ONLY = "pairwise_gram_partial"


def mesh_grid(np, shape):
    """What the sharding rules read of a mesh (this process is no rank)."""
    import types
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(shape))


def hold_run(torch, cmp, got, want, init, steps: int, ties, what: str):
    """Each leaf's change from ``init`` against the single-device run's at
    1e-4 of its largest change (plus one fp32 ulp per step), the window
    ties let off (``torch_llm_compare.change_ratio``), on the card;
    returns the worst error over its limit."""
    ratios = [cmp.change_ratio(g.cuda(), w.cuda(), p.cuda(), steps,
                               None if ties is None else ties[k].cuda())
              for k, (g, w, p) in enumerate(zip(got, want, init))]
    bad = [(k, r) for k, r in enumerate(ratios) if not r <= 1.0]
    expect(not bad, f"{what}: {len(bad)} of {len(ratios)} leaves' changes "
           f"off the single-device run's beyond their limit: (leaf, error "
           f"over limit) {[(k, round(r, 3)) for k, r in bad[:12]]}")
    return max(ratios)


def single_device_run(torch, rt, cfg, spec, batches, seed: int,
                      asynchronous: bool = False):
    """10b's single-device step (or asynchronous step) over ``batches``:
    ``(initial leaves, per step (leaves after it, the stack it
    aggregated, the bus versions or None))``, on the CPU; the stack is
    the step's submissions (taken before it) or the bus after it."""
    opt = rt["get_optimizer"]("momentum", MESH_LR)
    params = rt["init_model"](seed, cfg, device="cuda")
    init = [p.cpu() for p in rt["tree_leaves"](params)]
    state = opt.init(params)
    if asynchronous:
        step = rt["make_async_train_step"](cfg, spec, opt)
        agg = rt["init_async_state"](spec, params, batches[0][
            "tokens"].shape[0])
    else:
        subs = []
        step = rt["make_train_step"](
            cfg, spec, opt, observe=lambda sub, res: subs.append(
                [x.cpu() for x in rt["tree_leaves"](sub)]))
    rows = []
    for b in batches:
        if asynchronous:
            params, state, _, agg = step(params, state, b, agg)
            stack = [x.cpu() for x in rt["tree_leaves"](agg.bus.grads)]
            versions = agg.bus.versions.cpu()
        else:
            params, state, _ = step(params, state, b)
            stack, versions = subs[-1], None
        rows.append(([p.cpu() for p in rt["tree_leaves"](params)], stack,
                     versions))
    del params, state, step
    torch.cuda.empty_cache()
    return init, rows


def phase_mesh_full(torch, rt, smi):
    """10a: phase 8a's gemma3-1b cut (516,705,408 parameters, 74 leaves)
    on a (1, 2) mesh of two gloo ranks sharing the card: ``bulyan-krum``
    over ``fused`` (``pallas`` under the model axis: K1 on each rank's
    slice of every leaf), ``omniscient_linf`` ("ones"), momentum SGD
    1e-2, n = 7, f = 1, 3 steps; each worker's forward and backward
    split over the model axis (one sequence per worker, so each rank
    attends for half of its queries), one worker per pass.  The peak
    allocation per rank must stay below the last run's with the whole
    tree gathered."""
    import dataclasses
    import numpy as np
    mc, cmp = rt["mesh_check"], rt["compare"]
    cfg = dataclasses.replace(rt["get_config"](LLM_ARCH),
                              n_layers=LLM_LAYERS)
    batches = [llm_batch(np, rt, cfg, t, LLM_SEQ) for t in range(LLM_STEPS)]
    spec = rt["DistByzantineSpec"](f=LLM_F, gar="bulyan-krum",
                                   attack="omniscient_linf",
                                   distance_backend="fused")
    # every process below starts with the card to itself and this one
    # holds nothing large on it while they run
    torch.cuda.empty_cache()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    print(f"  10a this process holds "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB of the card",
          flush=True)
    args = (LLM_ARCH, LLM_LAYERS, LLM_N, LLM_F, batches, LLM_STEPS, MESH_LR,
            0, 1)
    t0 = time.perf_counter()
    single = rt["run_on_mesh"](mc.single_rank, (1, 1), args=args,
                               device="cuda", backend="gloo",
                               timeout=900)[0]
    res = rt["run_on_mesh"](mc.llm_rank, MESH_FULL, args=args,
                            device="cuda", backend="gloo", timeout=900)
    wall = time.perf_counter() - t0
    losses, single_ms, after = (single["losses"], single["step_ms"],
                                single["after"])
    params = rt["init_model"](0, cfg, device="cuda")
    template = rt["tree_map"](lambda p: torch.empty(
        tuple(p.shape), dtype=p.dtype, device="meta"), params)
    init = rt["tree_leaves"](params)
    for r in res:
        for t, counts in enumerate(r["launches"]):
            expect_launches(counts, per_step({K1_ONLY: LLM_LEAVES}),
                            f"10a rank {r['coords']} step {t}")
        expect(r["losses"] == res[0]["losses"],
               f"10a: rank losses {r['losses']} vs {res[0]['losses']}")
    for a, b in zip(res[0]["losses"], losses):
        expect(abs(a - b) <= FP32_TOL * max(1.0, abs(b)),
               f"10a: losses {res[0]['losses']} vs single-device {losses}")
    gate = res[0]["step0"]
    print(f"  ok  10a step 0 on the same submissions: all-reduced (7, 7) "
          f"{gate['dists_rel']:.2e} and gathered aggregate "
          f"{gate['agg_rel']:.2e} of each leaf's largest entry off the "
          f"single-device xla backend, selected equal "
          f"{gate['selected']}", flush=True)
    for r in res:
        k = r["k1"]
        expect(k["rel_err"] <= FP32_TOL, f"10a K1 shard: {k['rel_err']}")
        print(f"  ok  10a rank {r['coords']}: K1 on its embedding slice "
              f"{k['shape']} {k['rel_err']:.2e} of the largest entry off "
              f"its float64 function (the fp32 plain version "
              f"{k['plain_rel_err']:.2e}); {k['ms']:.3f} ms (CUDA events,"
              f" the card alone), plain {k['plain_ms']:.3f} ms, torch.mm "
              f"{k['library_ms']:.3f} ms", flush=True)
    grid = mesh_grid(np, MESH_FULL)
    pspecs = rt["param_shardings"](template, grid)
    tspecs = rt["per_worker_specs"](rt["gram_shardings"](template, grid))
    for t, (a, b) in enumerate(zip(res[0]["selected"], single["selected"])):
        expect(a == b, f"10a step {t}: selected {a} vs single-device {b}")
    got = mc.gather_slices([r["params"] for r in res], pspecs)
    ties = cmp.let_off(mc.whole_windows([r["windows"] for r in res],
                                        tspecs), single["windows"])
    tied = sum(int(x.sum()) for x in ties)
    expect(tied <= 1e-3 * LLM_PARAMS, f"10a: {tied:,} window ties")
    worst = hold_run(torch, cmp, got, after, init, LLM_STEPS, ties,
                     "10a 3 steps")
    del params, init, got, after
    print(f"  ok  10a 3 steps: parameters against the single-device run, "
          f"each leaf's change at {worst:.3f} of its limit (1e-4 of its "
          f"largest change plus one ulp per step) outside {tied:,} window "
          f"ties of {LLM_PARAMS:,} coordinates; launches per step and rank "
          f"K1 {LLM_LEAVES}, select / K2 / K3 / K4 / K5 0; losses "
          f"{[round(v, 5) for v in res[0]['losses']]}", flush=True)
    for r in res:
        peak = max(r["step_peak_gib"])
        print(f"  10a rank {r['coords']}: ms per step "
              f"{[round(v, 1) for v in r['step_ms']]} (median "
              f"{r['median_step_ms']:.1f}), in collectives "
              f"{[round(v * 1e3, 1) for v in r['comm_s']]} ms "
              f"({r['comm_bytes'][-1] / 2 ** 30:.2f} GiB of results per "
              f"step), peak {peak:.2f} GiB during a step ({smi})",
              flush=True)
        print(f"  10a rank {r['coords']} collectives per step: "
              f"{kinds_line(r['comm_kinds'][-1])}", flush=True)
        expect(peak < MESH_FULL_PEAK_BEFORE_GIB, f"10a rank {r['coords']}: "
               f"peak {peak:.2f} GiB, not below the whole-tree step's "
               f"{MESH_FULL_PEAK_BEFORE_GIB} GiB")
    for r in res:
        sec = r["seconds"]
        print(f"  10a rank {r['coords']} seconds: step 0's submissions "
              f"for the gate {sec['gate_pass']:.2f}, K1 on the slice "
              f"{sec['k1']:.2f}, step 0's gate {sec['gate']:.2f}, the "
              f"window codes in each step "
              f"{[round(v, 2) for v in sec['windows']]} (out of its ms)",
              flush=True)
    print(f"  10a single-device run: the window codes in each step "
          f"{[round(v, 2) for v in single['seconds']['windows']]} s",
          flush=True)
    print(f"  10a single-device ms per step "
          f"{[round(v, 1) for v in single_ms]} (peak "
          f"{single['peak_gib']:.1f} GiB); the two runs took {wall:.1f} s",
          flush=True)
    k = res[0]["k1"]
    n, d = k["shape"]
    row = dict(ms=k["ms"], plain_ms=k["plain_ms"],
               library_ms=k["library_ms"], max_abs_err=k["max_abs_err"],
               **bound(n, d, LLM_F, K1_ONLY, 4))
    ranks = [{k: r[k] for k in ("coords", "comm_kinds", "launches",
                                 "step_peak_gib", "step_ms", "comm_s")}
             for r in res]
    return {"row": row, "launches": sum(c[K1_ONLY]
                                        for c in res[0]["launches"]),
            "ranks": ranks}


def stale_scaled(rt, leaves, versions, step: int):
    """The bus as ``stale-<base>`` hands it to its base: each worker's row
    times ``1 / (1 + staleness)`` over the freshest worker's."""
    import torch
    s = (step - versions.to(torch.int64)).clamp_min(0).to(torch.float32)
    w = 1.0 / (1.0 + s)
    w = w / w.max()
    return [x * w.reshape((-1,) + (1,) * (x.dim() - 1)) for x in leaves]


def stack_windows(torch, rt, cmp, leaves, f: int):
    """Bulyan(krum)'s picks from a step's stack's own distances, then
    ``torch_llm_compare.leaf_windows`` per leaf."""
    leaves = [x.cuda() for x in leaves]
    dist = rt["pairwise_gram_tree"](leaves)
    idx = rt["select_indices_from_dists"](dist, f, base="krum")
    return [cmp.leaf_windows(x[idx].reshape(len(idx), -1), f).cpu()
            for x in leaves]


def phase_mesh_reduced(torch, rt, smi):
    """10b: reduced llama3.2-3b with ``attn_shard="batch"`` on a (2, 2)
    mesh of four gloo ranks sharing the card, n = 8, f = 1, two
    sequences per worker (the model axis splits each attention by
    them): 2 synchronous steps, 2 asynchronous steps at tau = 2
    (``stale-bulyan-krum``) and at tau = 0, each against the
    single-device step, exact launches per step; then one synchronous
    step on a (2, 1, 2) ``("pod", "data", "model")`` mesh with four
    sequences per worker (``pod`` halves them), against one device."""
    import dataclasses
    import numpy as np
    mc, cmp = rt["mesh_check"], rt["compare"]
    cfg = dataclasses.replace(rt["get_reduced"](MESH_ARCH),
                              attn_shard="batch")
    batches = [llm_batch(np, rt, cfg, t, 64, MESH_N, MESH_PER_WORKER)
               for t in range(MESH_STEPS)]
    t0 = time.perf_counter()
    res = rt["run_on_mesh"](
        mc.reduced_rank, MESH_REDUCED, args=(MESH_ARCH, MESH_N, LLM_F,
                                             batches, MESH_STEPS, MESH_LR,
                                             1, "batch"),
        device="cuda", backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    n_leaves = len(rt["tree_leaves"](res[0]["sync"][0]["params"]))
    for r in res:
        for run in ("sync", "async", "async0"):
            for t, row in enumerate(r[run]):
                expect_launches(row["launches"],
                                per_step({K1_ONLY: n_leaves}),
                                f"10b {run} rank {r['coords']} step {t}")
                for a, b in zip(rt["tree_leaves"](row["params"]),
                                rt["tree_leaves"](res[0][run][t]["params"])):
                    expect(torch.equal(a, b), f"10b {run}: ranks differ")
        expect(r["tau0_is_sync"], "10b: tau = 0 differs from the "
               "synchronous step")
    kw = dict(f=LLM_F, attack="omniscient_linf", distance_backend="fused")
    spec = rt["DistByzantineSpec"](gar="bulyan-krum", **kw)
    aspec = rt["DistByzantineSpec"](gar="stale-bulyan-krum", async_tau=2,
                                    **kw)
    init, sync_rows = single_device_run(torch, rt, cfg, spec, batches, 1)
    _, async_rows = single_device_run(torch, rt, cfg, aspec, batches, 1,
                                      asynchronous=True)
    worst, tied = 0.0, 0
    for run, single in (("sync", sync_rows), ("async", async_rows)):
        windows = ([], [])
        for t, (row, (after, stack, versions)) in enumerate(zip(
                res[0][run], single)):
            if run == "sync":
                mine = rt["tree_leaves"](row["sub"])
            else:
                mine = stale_scaled(rt, rt["tree_leaves"](row["bus"]),
                                    row["versions"], t)
                stack = stale_scaled(rt, stack, versions, t)
            windows[0].append(stack_windows(torch, rt, cmp, mine, LLM_F))
            windows[1].append(stack_windows(torch, rt, cmp, stack, LLM_F))
            ties = cmp.let_off(*windows)
            worst = max(worst, hold_run(
                torch, cmp, rt["tree_leaves"](row["params"]), after, init,
                t + 1, ties, f"10b {run} step {t}"))
        tied += sum(int(x.sum()) for x in ties)
    expect(tied <= 2e-3 * sum(x.numel() for x in init),
           f"10b: {tied:,} window ties")
    m = res[0]["async"][-1]["metrics"]
    print(f"  ok  10b {cfg.name} on (2, 2), n = {MESH_N}, "
          f"{MESH_PER_WORKER} sequences per worker (batch-split attention):"
          f" synchronous and tau = 2 steps against the single-device ones "
          f"at {worst:.3f} of the limit ({tied} window-tie coordinates let "
          f"off), tau = 0 == synchronous bit for bit, launches K1 "
          f"{n_leaves} per step and rank (select / K2 / K3 / K4 / K5 0); "
          f"tau = 2 step 1 delivered {m['delivered']:.0f}, staleness max "
          f"{m['staleness_max']:.0f}; {wall:.1f} s", flush=True)
    for r in res:
        row = r["sync"][-1]
        print(f"  10b rank {r['coords']} synchronous step: "
              f"{row['ms']:.1f} ms, {kinds_line(row['comm_kinds'])} "
              f"({smi})", flush=True)
    phase_mesh_pod(torch, rt, cfg, spec, smi)


def phase_mesh_pod(torch, rt, cfg, spec, smi):
    """10b's (2, 1, 2) world: one synchronous step of four gloo ranks,
    ``pod`` splitting each worker's 4 sequences, ``model`` each worker's
    forward, against the single-device step on the same batch under the
    LLM rule (window ties let off), exact launches."""
    import numpy as np
    mc, cmp = rt["mesh_check"], rt["compare"]
    batch = llm_batch(np, rt, cfg, 0, 64, MESH_N, POD_PER_WORKER)
    t0 = time.perf_counter()
    res = rt["run_on_mesh"](mc.pod_rank, MESH_POD, args=(
        MESH_ARCH, MESH_N, LLM_F, batch, MESH_LR, 1), device="cuda",
        backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    n_leaves = len(rt["tree_leaves"](res[0]["params"]))
    for r in res:
        expect_launches(r["launches"], per_step({K1_ONLY: n_leaves}),
                        f"10b pod rank {r['coords']}")
        for a, b in zip(rt["tree_leaves"](r["params"]),
                        rt["tree_leaves"](res[0]["params"])):
            expect(torch.equal(a, b), "10b pod: ranks differ")
    init, rows = single_device_run(torch, rt, cfg, spec, [batch], 1)
    after, stack, _ = rows[0]
    ties = cmp.let_off(
        [stack_windows(torch, rt, cmp, rt["tree_leaves"](res[0]["sub"]),
                       LLM_F)],
        [stack_windows(torch, rt, cmp, stack, LLM_F)])
    tied = sum(int(x.sum()) for x in ties)
    expect(tied <= 2e-3 * sum(x.numel() for x in init),
           f"10b pod: {tied:,} window ties")
    worst = hold_run(torch, cmp, rt["tree_leaves"](res[0]["params"]), after,
                     init, 1, ties, "10b pod step")
    print(f"  ok  10b {cfg.name} on {MESH_POD} (pod, data, model), n = "
          f"{MESH_N}, {POD_PER_WORKER} sequences per worker: the step "
          f"against the single-device one at {worst:.3f} of the limit "
          f"({tied} window-tie coordinates let off), launches K1 "
          f"{n_leaves} per rank; {wall:.1f} s", flush=True)
    for r in res:
        print(f"  10b pod rank {r['coords']}: {r['ms']:.1f} ms, "
              f"{kinds_line(r['comm_kinds'])} ({smi})", flush=True)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 12: the launch harness (dry-run on meta, held to the card's ranks)
# ---------------------------------------------------------------------------

#: 12a: the reference's ``tests/test_dryrun.py`` cases, then gemma3-1b
#: at full width on the kernels' route
DRYRUN_CASES = (
    ("mamba2-130m train_4k", ["--arch", "mamba2-130m", "--shape",
                              "train_4k", "--reduced"]),
    ("gemma3-1b decode_32k multi-pod", ["--arch", "gemma3-1b", "--shape",
                                        "decode_32k", "--reduced",
                                        "--multi-pod"]),
    ("gemma3-1b serve-gar", ["--arch", "gemma3-1b", "--shape",
                             "decode_32k", "--reduced", "--serve-gar",
                             "bulyan-krum", "--serve-f", "1",
                             "--serve-replicas", "7"]),
    ("mamba2-130m async", ["--arch", "mamba2-130m", "--shape", "train_4k",
                           "--reduced", "--async-tau", "3",
                           "--async-schedule", "fixed", "--gar",
                           "stale-bulyan-krum", "--attack",
                           "stale_replay"]),
    ("gemma3-1b train_4k full width", ["--arch", "gemma3-1b", "--shape",
                                       "train_4k", "--distance-backend",
                                       "fused"]),
    ("gemma3-1b train_4k full width multi-pod", [
        "--arch", "gemma3-1b", "--shape", "train_4k", "--distance-backend",
        "fused", "--multi-pod"]),
    ("mixtral-8x22b decode_32k serve-gar", [
        "--arch", "mixtral-8x22b", "--shape", "decode_32k", "--serve-gar",
        "bulyan-krum", "--serve-replicas", "16"]),
)
#: the split forward's bounds on the full-width train step per rank
FULL_WIDTH_BYTES, FULL_WIDTH_USEFUL = 64 * 2 ** 30, 0.4
#: the artifact keys the reference's tests and ``summarize`` read
DRYRUN_KEYS = ("mesh", "multi_pod", "gar", "memory_analysis",
               "cost_analysis", "collectives", "top_collective_ops",
               "hlo_lines", "roofline", "kernel_launches", "lower_s",
               "compile_s", "no_effect", "overrides")


def phase_dryrun():
    """12a: ``python -m repro_torch.launch.dryrun`` on each case of
    :data:`DRYRUN_CASES`, all started together, every artifact's schema
    checked as the reference's tests check theirs.  Returns the
    artifacts by case name."""
    import tempfile
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    t0 = time.perf_counter()
    try:
        for i, (name, args) in enumerate(DRYRUN_CASES):
            path = out_dir / f"{i}.json"
            procs.append((name, path, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--out", str(path)], env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)))
        recs = {}
        for name, path, proc in procs:
            _, err = proc.communicate(timeout=300)
            expect(proc.returncode == 0, f"12a dry-run {name} exited "
                   f"{proc.returncode}: {err[-2000:]}")
            recs[name] = json.loads(path.read_text())
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in out_dir.glob("*"):
            f.unlink()
        out_dir.rmdir()
    wall = time.perf_counter() - t0
    for name, rec in recs.items():
        for key in DRYRUN_KEYS:
            expect(key in rec, f"12a {name}: no {key!r} in the artifact")
        ro = rec["roofline"]
        expect(ro["compute_s"] > 0 and rec["hlo_lines"] > 0,
               f"12a {name}: compute_s {ro['compute_s']}, hlo_lines "
               f"{rec['hlo_lines']}")
        coll = rec["collectives"]
        calls = sum(v["count"] for v in coll.values())
        print(f"  ok  12a {name}: mesh {rec['mesh']}, roofline compute "
              f"{ro['compute_s']:.4g} s / memory {ro['memory_s']:.4g} s / "
              f"collective {ro['collective_s']:.4g} s, dominant "
              f"{ro['dominant']}, useful FLOPs ratio "
              f"{ro['useful_flops_ratio']}; {rec['cost_analysis']['flops']:.4g}"
              f" FLOPs, {rec['cost_analysis']['bytes accessed']:.4g} bytes "
              f"accessed, {calls} collectives for "
              f"{ro['collective_bytes_per_chip']:,} bytes, temp "
              f"{rec['memory_analysis']['temp_size_in_bytes']:,} bytes; "
              f"launches {rec['kernel_launches']}; built in "
              f"{rec['lower_s']} s, traced in {rec['compile_s']} s",
              flush=True)
    expect(recs["mamba2-130m train_4k"]["mesh"] == "16x16"
           and sum(v["count"] for v in recs["mamba2-130m train_4k"][
               "collectives"].values()) > 0, "12a: mamba2-130m train_4k")
    expect(recs["gemma3-1b decode_32k multi-pod"]["mesh"] == "2x16x16",
           "12a: the multi-pod mesh")
    serve = recs["gemma3-1b serve-gar"]
    expect(serve["serve_gar"] == "bulyan-krum"
           and serve["serve_replicas"] == 7, "12a: the serve-gar record")
    expect(recs["mamba2-130m async"]["async_tau"] == 3, "12a: async_tau")
    full = recs["gemma3-1b train_4k full width"]
    multi = recs["gemma3-1b train_4k full width multi-pod"]
    for name, rec in (("16x16", full), ("2x16x16", multi)):
        mem = rec["memory_analysis"]
        held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        useful = rec["roofline"]["useful_flops_ratio"]
        expect(rec["kernel_launches"] == {K1_ONLY: LLM_LEAVES},
               f"12a full width {name}: launches {rec['kernel_launches']}")
        expect(held <= FULL_WIDTH_BYTES and useful >= FULL_WIDTH_USEFUL,
               f"12a full width {name}: arguments + temp {held:,} B, "
               f"useful FLOPs ratio {useful}")
        leaves = sorted({k.split(":", 1)[1] for k in rec["param_gathers"]})
        expect(all(k.startswith("model:periods/") and k.endswith(
            ("/ln/scale", "/ln_f/scale")) for k in rec["param_gathers"]),
               f"12a full width {name}: leaves gathered {leaves}")
        print(f"  12a gemma3-1b train_4k full width on {name}: "
              f"{rec['cost_analysis']['flops']:.4g} FLOPs per rank, "
              f"arguments + temp {held / 2 ** 30:.2f} GiB, useful FLOPs "
              f"ratio {useful:.4f}; parameter leaves all-gathered over "
              f"model: {len(leaves)} period norm scales, each "
              f"{sorted(set(rec['param_gathers'].values()))} times",
              flush=True)
    mix = recs["mixtral-8x22b decode_32k serve-gar"]
    lay, mem = mix["serve_layout"], mix["memory_analysis"]
    args = mem["argument_size_in_bytes"]
    expect(mix["mesh"] == "16x16" and mix["serve_replicas"] == 16
           and lay["share"] < lay["whole"] / 8 and not mix["param_gathers"],
           f"12a mixtral-8x22b: layout {lay}, gathers "
           f"{mix['param_gathers']}")
    print(f"  12a mixtral-8x22b decode_32k, 16 replicas on 16 x 16 (one "
          f"per data row, split 16 ways): per rank arguments "
          f"{args / 2 ** 30:.2f} GiB ({lay['share'] / 2 ** 30:.2f} GiB of "
          f"them parameters) + temp {mem['temp_size_in_bytes'] / 2 ** 30:.2f}"
          f" GiB; a whole replica per rank would take "
          f"{(args - lay['share'] + lay['whole']) / 2 ** 30:.2f} GiB of "
          f"arguments ({lay['whole'] / 2 ** 30:.2f} GiB of parameters; its "
          f"temp not traced); no parameter leaf gathered; the temp is "
          f"{mem['temp_size_in_bytes'] / (args - lay['share']):.3f} times "
          f"the other arguments (the KV cache, whole along model): the "
          f"step writes a new cache out of place, layer by layer, and "
          f"restacks it", flush=True)
    half = multi["cost_analysis"]["flops"] / full["cost_analysis"]["flops"]
    expect(abs(half - 0.5) <= 0.05, f"12a: multi-pod FLOPs per rank "
           f"{half:.4f} of the single pod's")
    print(f"  12a: {len(recs)} dry-runs in {wall:.1f} s (in parallel; the "
          f"roofline is H100 SXM data-sheet figures, an estimate)",
          flush=True)
    return recs


def hold_calls(pred: dict, calls, launches: dict, what: str) -> None:
    """A prediction's collectives per kind against each measured call's,
    exactly, and its launches against ``launches`` (every kernel)."""
    expect_launches(pred["launches"], per_step(launches), f"{what} "
                    f"predicted")
    for i, got in enumerate(calls):
        expect(pred["by_kind"] == got, f"{what} step {i}: predicted "
               f"collectives {pred['by_kind']}, measured {got}")


def kinds_line(by_kind: dict) -> str:
    return ", ".join(f"{k} {v['calls']} / {v['bytes']:,} B"
                     for k, v in by_kind.items() if v["calls"])


def phase_launch_hold(torch, np, rt, mesh: dict, serve: dict, smi: str):
    """12b: the dry-run's trace (``RecordingMesh``) of phase 10a's step
    and of 9d's decode steps, for each rank position, held to what the
    card's gloo ranks recorded: collectives per kind per counted step
    exactly, launches exactly; argument bytes at most the measured peak.
    """
    import dataclasses
    dr = rt["dryrun"]
    cfg = dataclasses.replace(rt["get_config"](LLM_ARCH),
                              n_layers=LLM_LAYERS)
    spec = rt["DistByzantineSpec"](f=LLM_F, gar="bulyan-krum",
                                   attack="omniscient_linf",
                                   distance_backend="fused")
    batch = {"tokens": np.zeros((LLM_N, 1, LLM_SEQ), np.int32),
             "labels": np.zeros((LLM_N, 1, LLM_SEQ), np.int32)}
    t0 = time.perf_counter()
    for rank, got in enumerate(mesh["ranks"]):
        rm = dr.RecordingMesh(MESH_FULL, rank=rank)
        expect(rm.coords == got["coords"], f"12b: rank {rank} at "
               f"{rm.coords}, 10a's at {got['coords']}")
        pred = dr.trace_train_step(cfg, spec, rt["get_optimizer"](
            "momentum", MESH_LR), rm, batch, worker_chunk=1)
        what = f"12b 10a rank {got['coords']}"
        hold_calls(pred, got["comm_kinds"], {K1_ONLY: LLM_LEAVES}, what)
        peak = max(got["step_peak_gib"]) * 2 ** 30
        expect(pred["argument_bytes"] <= peak, f"{what}: predicted "
               f"arguments {pred['argument_bytes']:,} B over the measured "
               f"peak {peak:,.0f} B")
        flops = pred["flops"]
        terms = (flops / dr.PEAK_FLOPS_FP32, pred["bytes_accessed"]
                 / dr.HBM_BW)
        print(f"  ok  {what}: predicted per step {kinds_line(pred['by_kind'])}"
              f" = measured in each of {len(got['comm_kinds'])} steps; K1 "
              f"{LLM_LEAVES} and no other kernel, as measured", flush=True)
        print(f"  {what}: predicted arguments + temp "
              f"{pred['argument_bytes'] / 2 ** 30:.2f} + "
              f"{pred['temp_bytes'] / 2 ** 30:.2f} GiB beside the measured "
              f"peak {peak / 2 ** 30:.2f} GiB; roofline compute "
              f"{terms[0] * 1e3:.1f} ms ({flops:.4g} FLOPs at 67e12) / memory"
              f" {terms[1] * 1e3:.1f} ms beside the measured ms per step "
              f"{[round(v, 1) for v in got['step_ms']]}, of it in "
              f"collectives {[round(v * 1e3, 1) for v in got['comm_s']]} ms"
              f"; traced in {pred['seconds']:.1f} s ({smi})", flush=True)
    sspec = rt["AggSpec"](f=SERVE_F, gar="bulyan-krum",
                          distance_backend="fused")
    pos = np.zeros((SERVE_SLOTS,), np.int32)
    for shape, per_call in ((SHARD_SERVE_FULL, K5_CALL),
                            (SHARD_SERVE_MODEL, K1_CALL)):
        want = call_launches(per_call, "decode", attn=attn_calls(cfg))
        for rank, got in enumerate(serve["decode_calls"][shape]):
            rm = dr.RecordingMesh(shape, rank=rank)
            expect(rm.coords == got["coords"], f"12b: rank {rank} at "
                   f"{rm.coords}, 9d's at {got['coords']}")
            pred = dr.trace_serve_step(cfg, sspec, rm, SHARD_SERVE_N,
                                       SERVE_SLOTS, SERVE_CACHE, pos=pos)
            what = f"12b 9d {shape} rank {got['coords']}"
            hold_calls(pred, [c["comm_kinds"] for c in got["calls"]], want,
                       what)
            for c in got["calls"]:
                expect_launches(c["launches"], per_step(want), what)
            peak = got["peak_gib"] * 2 ** 30
            expect(pred["argument_bytes"] <= peak, f"{what}: predicted "
                   f"arguments {pred['argument_bytes']:,} B over the "
                   f"measured peak {peak:,.0f} B")
            ms = [c["ms"] for c in got["calls"]]
            print(f"  ok  {what}: predicted per decode step "
                  f"{kinds_line(pred['by_kind'])} = measured in each of "
                  f"{len(got['calls'])} decode steps; launches "
                  f"{ {k: v for k, v in pred['launches'].items() if v} } as "
                  f"measured; arguments + temp "
                  f"{pred['argument_bytes'] / 2 ** 30:.2f} + "
                  f"{pred['temp_bytes'] / 2 ** 30:.2f} GiB beside the "
                  f"measured peak {peak / 2 ** 30:.2f} GiB; measured ms per "
                  f"decode step median {statistics.median(ms):.2f} ({smi})",
                  flush=True)
    print(f"  12b: the holds took {time.perf_counter() - t0:.1f} s",
          flush=True)

# ---------------------------------------------------------------------------
# phase 13: the grouped GEMM of the dropless expert layer
# ---------------------------------------------------------------------------

#: one worker pass of one expert layer of the ``deepseek-v2-lite-l5``
#: cell: tokens, top-k, routed experts, held experts, D and F
GMM_TOKENS, GMM_TOPK, GMM_EXPERTS, GMM_HELD = 4096, 6, 64, 8
GMM_D, GMM_F = 2048, 1408
#: the kernel against the per-group ``torch.mm`` loop, over the loop's
#: largest entry: both sum the same 2,048 (1,408; ~384 for dW) fp32
#: products per entry, in different orders
GMM_TOL = 1e-5


def gmm_bound(rows: int, groups: int, k: int, n: int) -> dict:
    """Least time of one grouped product, ``(rows, k)`` times each
    group's ``(k, n)`` (dW: the rows' ``(k, rows)`` times ``(rows, n)``
    per group): the rows of both operands or the weights read once and
    the result written once over the memory rate, ``2 rows k n`` FLOPs
    over the fp32 peak, the larger."""
    nbytes = 4 * (rows * (k + n) + groups * k * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * rows * k * n / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_grouped_gemm(torch, rt, timer, smi) -> dict:
    """13: the forward, dX and dW of the grouped GEMM at the cell's
    shapes against the per-group loop, their launches and times.
    Returns ``{"rows": {case: row}, "launches": {case: count}}``."""
    gg, build = rt["grouped_gemm"], rt["build"]
    ops = torch.ops.repro_torch
    m = GMM_TOKENS * GMM_TOPK
    g = torch.Generator().manual_seed(0)
    picks = torch.rand(GMM_TOKENS, GMM_EXPERTS, generator=g).argsort(
        dim=1)[:, :GMM_TOPK]
    sizes = [int((picks == e).sum()) for e in range(GMM_HELD)]
    held = sum(sizes)
    offs = torch.tensor([0] + torch.tensor(sizes).cumsum(0).tolist(),
                        device="cuda")
    s, e = offs[:-1], offs[1:]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(m, GMM_D, generator=gen, device="cuda")
    w = torch.randn(GMM_HELD, GMM_D, GMM_F, generator=gen,
                    device="cuda") * GMM_D ** -0.5
    dy = torch.randn(m, GMM_F, generator=gen, device="cuda")

    def loop_dw():
        return torch.stack([x[a:b].T @ dy[a:b]
                            for a, b in zip(s.tolist(), e.tolist())])

    # case: (kernel, the per-group loop, its kernel's name, (k, n))
    cases = {
        "forward": (lambda: ops.gmm(x, w, s, e, False, -1),
                    lambda: gg.grouped_mm_plain(x, w, s.tolist(),
                                                e.tolist()),
                    "gmm_rows_kernel", (GMM_D, GMM_F)),
        "dX": (lambda: ops.gmm(dy, w, s, e, True, -1),
               lambda: gg.grouped_mm_plain(dy, w, s.tolist(), e.tolist(),
                                           trans_w=True),
               "gmm_rows_kernel", (GMM_F, GMM_D)),
        "dW": (lambda: ops.gmm_dw(x, dy, s, e), loop_dw, "gmm_dw_kernel",
               (GMM_D, GMM_F)),
    }
    want_launches = dict.fromkeys(build.LAUNCHES, 0)
    want_launches["grouped_gemm"] = 1
    rows, launches = {}, {}
    for name, (kern, loop, kname, (k, n)) in cases.items():
        got, counts = counted(torch, build, kern)
        expect_launches(counts, want_launches, f"13 grouped GEMM {name}")
        launches[name] = counts["grouped_gemm"]
        want = loop()
        err, rel, scale = scaled_err(got, want)
        expect(rel <= GMM_TOL, f"13 grouped GEMM {name}: {rel:.3e} of "
               f"{scale:.3e}")
        if name != "dW":
            expect(bool(torch.all(got[held:] == 0)),
                   f"13 grouped GEMM {name}: rows of no group not 0")
        loop_ms = timer.ms(loop, 20)
        rows[name] = dict(
            ms=timer.ms(kern, 20),
            device_ms=timer.device_ms(kern, 10, only=(kname,)),
            plain_ms=loop_ms, library_ms=loop_ms,
            library_device_ms=timer.device_ms(loop, 10), max_abs_err=err,
            **gmm_bound(held, GMM_HELD, k, n))
        r = rows[name]
        print(f"  ok  13 grouped GEMM {name}: {held:,} rows in {GMM_HELD} "
              f"groups ({sizes}) of a {m:,}-row buffer, k {k}, n {n}: "
              f"{err:.3e} off the per-group loop ({rel:.2e} of {scale:.4e}); "
              f"launches {launches[name]}; kernel {r['ms']:.4f} ms "
              f"(device {r['device_ms']:.4f})  loop {r['plain_ms']:.4f} ms "
              f"(device {r['library_device_ms']:.4f})  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{100 * r['bound_ms'] / r['device_ms']:.1f}% of it ({smi})",
              flush=True)
    expect(rows["forward"]["ms"] < rows["forward"]["plain_ms"],
           f"13 grouped GEMM forward {rows['forward']['ms']:.4f} ms, not "
           f"faster than the loop's {rows['forward']['plain_ms']:.4f}")
    return {"rows": rows, "launches": launches}


# ---------------------------------------------------------------------------
# phase 14: the decode attention over the serving cache
# ---------------------------------------------------------------------------

#: the serve-chat cell's decode step: replicas, periods, slots, cache
#: positions, KV heads (= query heads) and head dim
ATTN_R, ATTN_P, ATTN_B, ATTN_L, ATTN_H, ATTN_D = 7, 4, 12, 2048, 20, 128
#: the slots' lengths: a piece's and a tile's edges and the mix's median
ATTN_LENGTHS = (1, 127, 128, 129, 1020, 2047, 2048, 1, 2048, 255, 1190,
                1500)
#: the kernel against the plain path, over the plain path's largest
#: entry: both sum up to 2,048 fp32 products per entry, in other orders
ATTN_TOL = 1e-5


def phase_decode_attention(torch, rt, timer, smi) -> dict:
    """14: the kernel at the serve-chat cell's shapes against the plain
    path, its launches, times and bound.  Returns ``{"row", "launches"}``."""
    import torch.nn.functional as F
    build = rt["build"]
    from repro_torch.models.attention import _cached_attention
    from repro_torch.models.attention import decode_attention
    r, b, length, h, d = ATTN_R, ATTN_B, ATTN_L, ATTN_H, ATTN_D
    gen = torch.Generator(device="cuda").manual_seed(14)
    k = torch.randn(r, ATTN_P, b, length, h, d, device="cuda", generator=gen)
    v = torch.randn(r, ATTN_P, b, length, h, d, device="cuda", generator=gen)
    q = torch.randn(r, b, 1, h, d, device="cuda", generator=gen)
    valid = torch.tensor(ATTN_LENGTHS, dtype=torch.int32, device="cuda")
    mask = (torch.arange(length, device="cuda")[None, :]
            < valid[:, None])[:, None, :]
    period = ATTN_P // 2

    def kern():
        return torch.func.vmap(lambda qq, kk, vv: decode_attention(
            qq, kk[period], vv[period], valid))(q, k, v)

    def plain():
        return torch.func.vmap(lambda qq, kk, vv: _cached_attention(
            qq, kk[period], vv[period], mask))(q, k, v)

    got, counts = counted(torch, build, kern)
    want_launches = dict.fromkeys(build.LAUNCHES, 0)
    want_launches["decode_attention"] = 1
    expect_launches(counts, want_launches, "14 decode attention")
    want = plain()
    err, rel, scale = scaled_err(got, want)
    expect(rel <= ATTN_TOL, f"14 decode attention: {rel:.3e} of "
           f"{scale:.3e}")
    # the library yardstick on a dense (rows, H, L, D) copy of the view
    ks, vs = (t[:, period].reshape(r * b, length, h, d).transpose(1, 2)
              .contiguous() for t in (k, v))
    qs = q.reshape(r * b, 1, h, d).transpose(1, 2).contiguous()
    smask = mask.repeat(r, 1, 1)[:, None]

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=smask)

    lib = library().transpose(1, 2).reshape(r, b, 1, h, d)
    lib_err, lib_rel, _ = scaled_err(lib, want)
    attended = r * h * int(valid.sum())
    nbytes = 4 * (2 * attended * d + 2 * r * b * h * d)
    row = dict(ms=timer.ms(kern, 20),
               # at L = 2,048 the length splits into 8 pieces: each call
               # launches the kernel and the combine
               device_ms=timer.device_ms(kern, 10,
                                         only=("decode_attention",),
                                         launches=2),
               plain_ms=timer.ms(plain, 5),
               plain_device_ms=timer.device_ms(plain, 3),
               library_ms=timer.ms(library, 10),
               library_device_ms=timer.device_ms(library, 5),
               max_abs_err=err, bound_by="bytes",
               bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
    share = 100 * row["bound_ms"] / row["device_ms"]
    print(f"  ok  14 decode attention: {r} replicas x {b} slots of a "
          f"period view of ({r}, {ATTN_P}, {b}, {length}, {h}, {d}) fp32, "
          f"lengths {list(ATTN_LENGTHS)}: {err:.3e} off the plain path "
          f"({rel:.2e} of {scale:.4e}); SDPA {lib_rel:.2e}; launches "
          f"{counts['decode_attention']}; kernel {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f})  plain {row['plain_ms']:.4f} ms (device "
          f"{row['plain_device_ms']:.4f})  SDPA {row['library_ms']:.4f} ms "
          f"(device {row['library_device_ms']:.4f})  bound "
          f"{row['bound_ms']:.4f} ms ({nbytes:,} B); {share:.1f}% of it "
          f"({smi})", flush=True)
    log = build._BUILD / "decode_attention.log"
    if log.exists():
        print_ptxas(log)
    expect(row["device_ms"] < row["plain_device_ms"],
           f"14 decode attention: device {row['device_ms']:.4f} ms, not "
           f"under the plain path's {row['plain_device_ms']:.4f}")
    expect(55.0 <= share <= 100.0, f"14 decode attention at {share:.1f}% "
           f"of its bound, not within 55-100% (over 100%: the profile "
           f"missed kernels)")
    return {"row": row, "launches": counts["decode_attention"]}


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
    # phase 10's rank functions and the tests' comparison rule; spawned
    # ranks inherit this path
    sys.path.append(str(ROOT / "tests"))

    t_start = time.perf_counter()
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
    from repro_torch.kernels import grouped_gemm
    # the package exports functions under the names of these modules, as
    # the reference's does, so the modules come from the import system
    bulyan_select, coord_stats, fused_agg, pairwise_gram = (
        importlib.import_module(f"repro_torch.kernels.{name}")
        for name in ("bulyan_select", "coord_stats", "fused_agg",
                     "pairwise_gram"))
    from repro_torch.agg.fused import FUSED_BASES
    from repro_torch.audit import leeway, sweep
    from repro_torch.models import simple
    from repro_torch.obs.buffer import drain
    from repro_torch.obs.forensics import dense_diagnostics, tree_diagnostics
    from repro_torch.optim import fading_lr, get_optimizer
    from repro_torch.training import trainer
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.dist import train as llm_train
    from repro_torch.dist import serve_robust
    from repro_torch.models import decode_step, init_model, verify_supported
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.core.pytree import tree_map
    from repro_torch.dist import async_train, sharding
    import torch_llm_compare as compare
    import torch_mesh_check as mesh_check
    import torch_serve_mesh_check as serve_mesh_check
    import torch_serving_compare as serving_compare
    from repro_torch.dist.mesh import run_on_mesh
    from repro_torch.launch import dryrun
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
              init_state=init_state, update_bus=update_bus, drain=drain,
              dense_diagnostics=dense_diagnostics,
              tree_diagnostics=tree_diagnostics, leeway=leeway,
              sweep=sweep, FUSED_BASES=FUSED_BASES,
              get_config=get_config, get_reduced=get_reduced,
              lm_batches=lm_batches, init_model=init_model,
              DistByzantineSpec=llm_train.DistByzantineSpec,
              make_train_step=llm_train.make_train_step,
              make_loss_fn=llm_train.make_loss_fn,
              byzantine_grads=llm_train.byzantine_grads,
              pairwise_gram_tree=pairwise_gram.pairwise_gram_tree,
              replicate_params=serve_robust.replicate_params,
              poison_replicas=serve_robust.poison_replicas,
              aggregate_logits=serve_robust.aggregate_logits,
              make_robust_prefill_step=serve_robust.make_robust_prefill_step,
              make_robust_serve_step=serve_robust.make_robust_serve_step,
              ServingEngine=ServingEngine, Request=Request,
              decode_step=decode_step, verify_supported=verify_supported,
              tree_map=tree_map, mesh_check=mesh_check, compare=compare,
              serve_mesh_check=serve_mesh_check,
              serving_compare=serving_compare, run_on_mesh=run_on_mesh,
              param_shardings=sharding.param_shardings,
              gram_shardings=sharding.gram_shardings,
              per_worker_specs=sharding.per_worker_specs,
              make_async_train_step=async_train.make_async_train_step,
              init_async_state=async_train.init_async_state,
              dryrun=dryrun, grouped_gemm=grouped_gemm)
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

    print(f"  phases 1-6 took {time.perf_counter() - t_start:.1f} s "
          f"({smi})", flush=True)
    print("== phase 7: telemetry and audit", flush=True)
    import numpy as np
    t7 = time.perf_counter()
    # cuDNN's default weight-gradient algorithms accumulate in no fixed
    # order, so two CNN runs from one seed differ in the last bits; the
    # deterministic ones let 7a hold telemetry off == on bit for bit
    torch.backends.cudnn.deterministic = True
    phase_telemetry(torch, np, rt, "mnist", 10)
    phase_telemetry(torch, np, rt, "cifar", 3)
    phase_telemetry_async(torch, np, rt, 5)
    phase_telemetry_tree(torch, np, rt)
    phase_report(torch, rt)
    phase_leeway(torch, rt)
    phase_sweep(torch, rt)
    print(f"  phase 7 took {time.perf_counter() - t7:.1f} s ({smi})",
          flush=True)

    print("== phase 8: the LLM path (dist/train.py over the model zoo)",
          flush=True)
    t8 = time.perf_counter()
    llm = phase_llm_full(torch, rt, ops, timer, smi)
    phase_llm_reduced(torch, rt)
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s ({smi})",
          flush=True)

    print("== phase 9: serving (the decode path, the ensemble engine, "
          "verify)", flush=True)
    t9 = time.perf_counter()
    serve = phase_serve_full(torch, np, rt, ops, timer, smi)
    phase_serve_speculative(torch, np, rt, smi)
    phase_serve_reduced(torch, np, rt)
    print(f"  phases 9a-9c took {time.perf_counter() - t9:.1f} s ({smi})",
          flush=True)
    t9d = time.perf_counter()
    shard_serve = phase_shard_serve(torch, np, rt, smi)
    print(f"  phases 9d-9e took {time.perf_counter() - t9d:.1f} s; phase 9 "
          f"{time.perf_counter() - t9:.1f} s ({smi})", flush=True)

    print("== phase 10: the multi-rank runtime (gloo ranks sharing the "
          "card)", flush=True)
    t10 = time.perf_counter()
    mesh = phase_mesh_full(torch, rt, smi)
    phase_mesh_reduced(torch, rt, smi)
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s ({smi})",
          flush=True)

    print("== phase 12: the launch harness (dry-run on meta, held to the "
          "card's ranks)", flush=True)
    t12 = time.perf_counter()
    phase_dryrun()
    phase_launch_hold(torch, np, rt, mesh, shard_serve, smi)
    print(f"  phase 12 took {time.perf_counter() - t12:.1f} s ({smi})",
          flush=True)

    print("== phase 13: the grouped GEMM (the dropless expert layer)",
          flush=True)
    gmm = phase_grouped_gemm(torch, rt, timer, smi)

    print("== phase 14: the decode attention (the serving cache)",
          flush=True)
    attn = phase_decode_attention(torch, rt, timer, smi)

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
    for name, r in llm["rows"].items():
        launches = llm["launches"][name]
        expect(launches > 0, f"{name} was not launched on the LLM path")
        kernels.append({
            "name": f"{name}@{LLM_ARCH}", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    for name, r in serve["rows"].items():
        launches = serve["launches"][name]
        expect(launches > 0, f"{name} was not launched on the serving path")
        kernels.append({
            "name": f"{name}@serve", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    expect(mesh["launches"] > 0, "K1 was not launched on the mesh path")
    r = mesh["row"]
    kernels.append({
        "name": f"{K1_ONLY}@{LLM_ARCH}-mesh", "route": "cuda",
        "source": SOURCES[K1_ONLY], "replaces": REPLACES[K1_ONLY],
        "launches": mesh["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name, tag, row, launches in (
            ("fused_aggregate", "serve-mesh", shard_serve["k5_row"],
             shard_serve["k5_launches"]["fused_aggregate"]),
            (K1_ONLY, "serve-mesh-model", shard_serve["k1_row"],
             shard_serve["k1_launches"])):
        expect(launches > 0, f"{name} was not launched on the {tag} path")
        kernels.append({
            "name": f"{name}@{tag}", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    for case, row in gmm["rows"].items():
        kernels.append({
            "name": f"grouped_gemm:{case}@deepseek-v2-lite-l5",
            "route": "cuda", "source": SOURCES["grouped_gemm"],
            "replaces": REPLACES["grouped_gemm"],
            "launches": gmm["launches"][case],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    row = attn["row"]
    kernels.append({
        "name": "decode_attention@qwen1.5-4b-l4.serve-chat", "route": "cuda",
        "source": SOURCES["decode_attention"],
        "replaces": REPLACES["decode_attention"],
        "launches": attn["launches"], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "device_ms": row["device_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(f"  the script took {time.perf_counter() - t_start:.1f} s "
          f"({smi})", flush=True)
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
