"""Driver of the training mixes: the zoo's Byzantine train step
(``repro_torch.dist.train.make_train_step``) on the cell's model, from
the seed's weights and token stream.

Set-up builds the kernels, draws the weights, makes the mix's batches,
builds the step and drives it through its first ``CHECKED`` steps, which
the check reads; the window then runs the same step on the same state
until ``--seconds`` have passed.  After the window the program's state is
freed and the plain reference follows the first steps from the same
weights and batches.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from bench import roofline, weights
from bench.trace import Profiled
from bench.reference import precision
from bench.reference import train as ref_train
from bench.traffic import train_batches

#: steps the check compares (the reference follows them)
CHECKED = 3


def walk(tree, prefix=()):
    """``(path, leaf)`` in the program's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def model_config(cell):
    from repro_torch.models.config import ModelConfig
    port = dict(cell.config["port"])
    port["layer_pattern"] = tuple(port["layer_pattern"])
    return ModelConfig(**port)


def layout_of(mcfg) -> weights.Layout:
    """The program's leaves and shapes, from its ``meta`` init."""
    from repro_torch.models import init_model
    return [(p, tuple(x.shape))
            for p, x in walk(init_model(0, mcfg, device="meta"))]


def build_program(cell, mcfg):
    """The step the window drives, and its optimizer."""
    from repro_torch.dist.train import DistByzantineSpec, make_train_step
    from repro_torch.optim import get_optimizer
    tr = cell.traffic
    spec = DistByzantineSpec(f=tr["f"], gar=tr["gar"], attack=tr["attack"],
                             distance_backend=tr["distance_backend"])
    opt = get_optimizer(tr["optimizer"], tr["lr"])
    step = make_train_step(mcfg, spec, opt,
                           worker_chunk=tr["worker_chunk"])
    return step, opt


def _norms(tree, scale: float = 1.0) -> List[float]:
    return [float(torch.linalg.vector_norm(x.double())) * scale
            for _, x in walk(tree)]


def setup(cell):
    """``(model config, layout, batches)`` of the cell on its device."""
    tr, dev = cell.traffic, cell.device
    mcfg = model_config(cell)
    layout = layout_of(mcfg)
    batches = [{"tokens": torch.as_tensor(t, device=dev),
                "labels": torch.as_tensor(l, device=dev)}
               for t, l in train_batches(tr, mcfg.vocab_size, cell.seed,
                                         tr["batches"])]
    return mcfg, layout, batches


def first_steps(cell, mcfg, layout, batches, step_fault=None):
    """Draw the weights, build the step and drive it through the first
    ``CHECKED`` steps.  Returns ``(params, state, step, opt, readings)``:
    each step's loss, each leaf's norm of the first aggregated gradient
    (from AdamW's first moment) and of its change over the steps.
    ``step_fault`` wraps the step (the check's own tests and readings
    break the timed path with it)."""
    params = weights.draw_tree(layout, cell.model.init_rule, cell.seed,
                               cell.device)
    step, opt = build_program(cell, mcfg)
    if step_fault is not None:
        step = step_fault(step)
    state = opt.init(params)
    start = [x.clone() for _, x in walk(params)]
    prog = {"losses": []}
    for t in range(CHECKED):
        params, state, m = step(params, state, batches[t])
        prog["losses"].append(float(m["loss"]))
        if t == 0:
            # AdamW's first moment after one step is (1 - b1) g
            prog["grad1"] = _norms(state["m"],
                                   1.0 / (1.0 - cell.traffic["adam_b1"]))
    prog["change"] = [float(torch.linalg.vector_norm((x - s).double()))
                      for (_, x), s in zip(walk(params), start)]
    return params, state, step, opt, prog


def run(cell, t_start: float) -> Dict:
    from repro_torch.kernels import _build
    tr, dev = cell.traffic, cell.device
    marks = [("imports", time.perf_counter())]
    if dev == "cuda":
        _build.build_all()
    marks.append(("kernels", time.perf_counter()))
    mcfg, layout, batches = setup(cell)
    marks.append(("inputs", time.perf_counter()))
    n, f = tr["workers"], tr["f"]
    params, state, step, opt, prog = first_steps(cell, mcfg, layout,
                                                 batches)
    _sync(dev)
    marks.append(("weights_and_first_steps", time.perf_counter()))
    setup_s = time.perf_counter() - t_start

    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tokens_per_step = n * tr["per_worker"] * tr["seq"]
    # traced run: device activity over steps [1, 1 + P), then one step
    # with the host's operators and the program's spans
    p_steps = tr["trace_steps"] if cell.trace else 0
    span_at = 1 + p_steps if cell.trace else -1
    prof, dev_tr, span_tr, step_s, losses = None, None, None, [], []
    t0 = time.perf_counter()
    k = 0
    while True:
        if cell.trace and k in (1, span_at):
            prof = Profiled(host=k == span_at).__enter__()
        ts = time.perf_counter()
        params, state, m = step(params, state,
                                batches[(CHECKED + k) % len(batches)])
        _sync(dev)
        losses.append(m["loss"])
        if prof is not None and k in (span_at - 1, span_at):
            got = prof.stop(lambda: _sync(dev))
            if k == span_at:
                span_tr = got
            else:
                dev_tr = got
            prof = None
        elif not 1 <= k <= span_at:
            step_s.append(time.perf_counter() - ts)
        k += 1
        if time.perf_counter() - t0 >= cell.seconds and k > span_at:
            break
    window_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    failed = sum(1 for l in losses if not math.isfinite(float(l)))
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    del params, state, step, opt, m, losses
    if dev == "cuda":
        torch.cuda.empty_cache()

    out = {"attempted": k, "failed": failed, "memory_peak_bytes": peak,
           "power": _power(dev), "setup_parts": setup_parts(t_start, marks),
           "end_to_end": {
               "setup_s": setup_s,
               "train_tokens_per_s": k * tokens_per_step / window_s}}
    flops = cell.model.train_flops(cell.config, tr["per_worker"] * n,
                                   tr["seq"])
    sizes = [math.prod(s) for _, s in layout]
    measured = {
        "peak_bytes": peak, "steps": k, "flops_per_step": flops,
        "untraced_step_s": step_s, "launches": launches,
        "k1_least_s": sum(roofline.kernel_least_s("k1", n, d, f)
                          for d in sizes),
        "k4_least_s": sum(roofline.kernel_least_s("k4", n, d, f)
                          for d in sizes),
        "traced_steps": p_steps}
    if cell.trace:
        measured.update(trace=dev_tr, traced_s=dev_tr.seconds,
                        agg_span_s=sum(span_tr.span_s.values()))
        out.update(busy_s=dev_tr.busy_s, window_s=dev_tr.seconds,
                   breakdown=dev_tr.breakdown())
    out["measured"] = measured

    t_ref = time.perf_counter()
    ref = reference(cell, layout, batches)
    out["numbers"] = ref_train.gaps(prog, ref)
    out["reference_s"] = time.perf_counter() - t_ref
    return out


def reference(cell, layout, batches, precision_name: str = "fp32"):
    """The plain reference's first ``CHECKED`` steps from the seed's
    weights, drawn again."""
    tr, dev = cell.traffic, cell.device
    tree = weights.draw_tree(layout, cell.model.init_rule, cell.seed, dev)
    leaves = [x for _, x in walk(tree)]
    paths = [p for p, _ in layout]

    def unflatten(ls):
        return weights._nest(zip(paths, ls))

    with precision.precision(precision_name, dev):
        ref = ref_train.steps(
            lambda t, tok: cell.model.reference_logits(t, tok, cell.config),
            leaves, unflatten,
            [(b["tokens"], b["labels"]) for b in batches[:CHECKED]],
            tr["workers"], tr["f"], tr["lr"], CHECKED)
    del tree, leaves
    if dev == "cuda":
        torch.cuda.empty_cache()
    return ref


def setup_parts(t_start: float, marks) -> Dict[str, float]:
    """Seconds of each part of set-up, from the process's start."""
    out, t = {}, t_start
    for name, at in marks:
        out[name] = at - t
        t = at
    return out


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _power(dev) -> str:
    if dev != "cuda":
        return "no card"
    from bench.harness import power_limit
    return power_limit()


def half_batch(step):
    """Fault: every worker's gradient over the first half of each
    sequence, the mean taken over it."""
    def broken(params, state, batch):
        half = batch["tokens"].shape[-1] // 2
        return step(params, state, {k: v[..., :half]
                                    for k, v in batch.items()})
    return broken


def altered_answer(step):
    """Fault: one coordinate of the parameters each step produces
    overwritten (the first entry of the final norm's scale set to 0)."""
    def broken(params, state, batch):
        params, state, m = step(params, state, batch)
        params["final_norm"]["scale"].view(-1)[0] = 0.0
        return params, state, m
    return broken


FAULTS = {"half_batch": half_batch, "altered_answer": altered_answer}


def readings(cell, faults: bool = True, control: bool = True) -> Dict:
    """One seed's numbers: the program's, with ``control`` the control's
    (the reference in TF32 in the program's place) and, with ``faults``,
    each fault's; all against the float32 reference.  A step that
    returns its state unchanged reads 1 on ``change`` by its definition
    and is not run.  ``looks`` names the worst leaf of each per-leaf
    number and gives each step's loss gap."""
    if cell.device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    mcfg, layout, batches = setup(cell)
    out = {}
    runs = [("program", None)] + (list(FAULTS.items()) if faults else [])
    progs = {}
    for name, fault in runs:
        prog = first_steps(cell, mcfg, layout, batches, fault)[-1]
        progs[name] = prog
        _free(cell.device)
    t0 = time.perf_counter()
    ref = reference(cell, layout, batches)
    out["reference_s"] = time.perf_counter() - t0
    for name, prog in progs.items():
        out[name] = ref_train.gaps(prog, ref)
    if control:
        ctl = reference(cell, layout, batches, "tf32")
        out["control"] = ref_train.gaps(ctl, ref)
    p = progs["program"]
    paths = ["/".join(path) for path, _ in layout]
    out["looks"] = {
        "loss_by_step": [abs(a - b) / abs(b)
                         for a, b in zip(p["losses"], ref["losses"])],
        "control_loss_by_step": ([abs(a - b) / abs(b) for a, b in
                                  zip(ctl["losses"], ref["losses"])]
                                 if control else None),
        "grad1_worst": paths[max(range(len(paths)), key=lambda k: abs(
            p["grad1"][k] - ref["grad1"][k]) / ref["grad1"][k])],
        "change_worst": paths[max(range(len(paths)), key=lambda k: abs(
            p["change"][k] - ref["change"][k]) / ref["change"][k])],
        "reference_grad1": ref["grad1"]}
    return out


def _free(dev):
    import gc
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
