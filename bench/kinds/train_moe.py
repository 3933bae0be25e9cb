"""Driver of the training mixes of a dropless expert model: the training
driver (``bench/kinds/train.py``) unchanged, between a reset and one read
of the program's counter of the rows each held expert multiplied
(``repro_torch.kernels.grouped_gemm``).

The window replays the mix's batches: every ``batches`` window steps the
step is handed again the parameters and optimizer state that the checked
steps left, so the window runs the same pass over the mix's batches from
the same state, again and again.  The cut holds 8 of the 64 experts, and
only their outputs reach the loss, so AdamW pulls the router toward them
step by step: the held rows of a step grow from the start, then, after
about a dozen steps, swing in a way each seed sets, and a window of
training on would read another rate on every seed.  Over one pass of the
batches from the checked state the steps agree across seeds.  The
window's steps are the program's own: only their inputs repeat.

Around the training driver the start-up's objects (the imports' some
270,000) are frozen out of the garbage collector (``gc.freeze``), and
thawed after: at this cell's rate of Python allocations (the custom
op's dispatch under ``torch.func``) a full collection fell in a window
or not, and each rescanned them all for some 220 ms, which spread the
rate over runs by more than the cell's noise.  Everything made after
the freeze (the weights' tree, the steps' garbage) is collected as
before, by every generation.  So the rate leaves out those full
collections, which a training loop that does not freeze pays, and
which the training driver's other cells still count.

From the counter it adds to ``measured``: ``expert_rows`` (rows per step
of each expert layer's held experts), ``expert_rows_max`` (the busiest
held expert's rows over the held experts' mean, times 100) and
``gmm_least_s`` (the least time of one step's grouped GEMMs over the
rows they multiplied, the configuration's ``gmm_least_s``).  A program
without the counter fails at once, at the import.
"""
from __future__ import annotations

import gc
from typing import Dict

from bench.kinds import train

readings = train.readings
FAULTS = train.FAULTS


def replaying(first_steps, period: int):
    """``first_steps`` whose step, from its ``period``-th call on and at
    every ``period``-th after, runs from the parameters and optimizer
    state that ``first_steps`` returned instead of those it is given."""
    def wrapped(*args, **kwargs):
        params, state, step, opt, prog = first_steps(*args, **kwargs)
        start, calls = (params, state), 0

        def replayed(params, state, batch):
            nonlocal calls
            if calls and calls % period == 0:
                params, state = start
            calls += 1
            return step(params, state, batch)
        return params, state, replayed, opt, prog
    return wrapped


def run(cell, t_start: float) -> Dict:
    from repro_torch.kernels import grouped_gemm
    grouped_gemm.reset_expert_rows()
    first_steps = train.first_steps
    train.first_steps = replaying(first_steps, cell.traffic["batches"])
    gc.collect()
    gc.freeze()
    try:
        out = train.run(cell, t_start)
    finally:
        gc.unfreeze()
        train.first_steps = first_steps
    counts = grouped_gemm.expert_rows()
    port = cell.config["port"]
    steps = train.CHECKED + out["attempted"]
    layers = range(port["n_dense_lead"], port["n_layers"])
    held = port["moe_held"]
    per_step = [[float(counts[layer, e]) / steps for e in range(held)]
                for layer in layers]
    flat = [r for row in per_step for r in row]
    mean = sum(flat) / len(flat)
    workers = cell.traffic["workers"]
    out["measured"].update(
        expert_rows=per_step,
        expert_rows_max=100.0 * max(flat) / mean if mean > 0 else None,
        gmm_least_s=cell.model.gmm_least_s(
            cell.config, [sum(row) / workers for row in per_step], workers))
    return out
