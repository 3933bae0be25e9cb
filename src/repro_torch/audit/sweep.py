"""The adversarial corner sweep: every rule x attack x (n, f, tau) grid
(counterpart of ``repro/audit/sweep.py``).

One sweep walks every rule the registry resolves (the paper's base
rules, the ``bulyan-*`` / ``buffered-*`` / ``stale-*`` / ``fused-*`` /
``reputation-*`` / ``obs-*`` composite families,
``centered_clip_momentum``) against the registered attacks over a grid
of worker counts, Byzantine bounds, staleness patterns and delay
schedules, and asserts the shared contracts at each corner, in the
reference's sections and with its violation texts:

* ``invariants`` — each rule's declared ``invariants`` tuple, checked
  against the effective stack it consumed
  (``repro_torch.audit.invariants``);
* ``quorum`` — below ``min_n(f)`` every name raises the one canonical
  ``check_quorum`` ValueError; tree-less rules raise the canonical
  KeyError only under ``distributed=True``;
* ``identity`` — a ``stale-*`` composite over a uniformly stale (or
  fresh, or clock-skewed negative-staleness) committee is bitwise its
  base rule;
* ``staleness`` — simulated delivery under every (tau, schedule) corner
  keeps ``staleness_excess`` at zero, and ``tau = 0`` delivers everyone
  every step;
* ``arbitrary-f`` — at ``f >= n/2`` every quorum-bound rule refuses with
  the canonical message, while every ``reputation-*`` composite runs,
  emits a finite aggregate and keeps its weights inside ``[0, 1]``;
* ``fp32`` — the kernels match their fp32 oracles on bf16 inputs
  (``repro_torch.kernels.probes``), and the tree engine's bf16 path
  under the ``auto`` and ``fused`` backends agrees with the fp32 flat
  rule while keeping leaf dtypes;
* ``speculative`` — robust speculative serving: per-position
  aggregation of synthetic verifier-logit blocks keeps each rule's
  invariants, and ``accept_block`` emits only tokens in the aggregate's
  support, with counts in ``[1, k]``.

Stacks are drawn on ``device`` from a ``torch.Generator`` per case,
seeded with ``zlib.crc32`` of the case's parts, so the sweep is
deterministic end to end.  Violations are collected, not raised.  CLI:
``python -m repro_torch.audit.sweep [--quick] [--device cpu]`` exits
non-zero on any violation.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.agg.registry import resolve_rule, rule_names
from repro_torch.agg.state import init_state
from repro_torch.audit.invariants import (check_finite, check_quorum_contract,
                                          check_rule_output, effective_stack,
                                          prewindow_stack)
from repro_torch.core.attacks import get_attack
from repro_torch.device import resolve_device

__all__ = ["AuditReport", "QUICK", "SweepConfig", "audit_roster", "main",
           "run_sweep"]

#: attacks whose submissions depend on their own previous ones
_DELAY_ATTACKS = ("stale_replay", "slow_drift")

#: per-attack keyword arguments used by the sweep (the omniscient
#: attacks use the paper's closed-form gamma: one cheap pass per call)
_ATTACK_KW: Dict[str, dict] = {
    "omniscient_lp": {"gamma": "closed", "margin": 1.0},
    "omniscient_linf": {"gamma": "closed", "direction": "anti"},
    "ipm": {"eps": 0.7},
    "stale_replay": {"scale": -1.5},
    "slow_drift": {"eps": 0.8},
}

@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static shape of one corner sweep.

    Args:
      d: coordinate count of the synthetic stacks.
      fs: Byzantine bounds to probe.
      extra_n: worker-count offsets above each rule's ``min_n(f)``.
      attacks: attack names (``"none"`` = all-honest committee).
      steps: aggregation steps per stateful case.
      taus: staleness bounds of the delivery simulation: ints and/or
        per-worker tuples.
      schedules: delay schedules of the delivery simulation.
      quorum_fs: Byzantine bounds of the quorum-contract section.
      seed: base seed (folded per case).
    """

    d: int = 16
    fs: Tuple[int, ...] = (1, 2)
    extra_n: Tuple[int, ...] = (0, 2)
    attacks: Tuple[str, ...] = ("none", "omniscient_lp", "omniscient_linf",
                                "alie", "ipm", "signflip", "random",
                                "zero", "mimic", "stale_replay",
                                "slow_drift")
    steps: int = 3
    taus: Tuple = (0, 2, (0, 1, 3, 0, 2, 1, 3))
    schedules: Tuple[str, ...] = ("fixed", "random")
    quorum_fs: Tuple[int, ...] = (1, 2, 3)
    seed: int = 0


#: the quick variant: one (n, f) corner, the attack families that
#: exercise distinct code paths, two steps
QUICK = SweepConfig(fs=(1,), extra_n=(2,),
                    attacks=("none", "omniscient_lp", "alie", "signflip",
                             "stale_replay"),
                    steps=2, taus=(0, 2), quorum_fs=(1, 2))


@dataclasses.dataclass
class AuditReport:
    """Outcome of one sweep: per-section case counts and violations.

    Args:
      cases: total corners evaluated.
      violations: every violation string collected across sections.
      sections: section name -> (cases, violations) counts.
    """

    cases: int = 0
    violations: List[str] = dataclasses.field(default_factory=list)
    sections: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)

    def ok(self) -> bool:
        """True when no corner violated any contract."""
        return not self.violations

    def add(self, section: str, cases: int,
            violations: Sequence[str]) -> None:
        """Fold one section's outcome into the report.

        Args:
          section: section name.
          cases: corners the section evaluated.
          violations: violations the section collected.
        """
        self.cases += cases
        self.violations.extend(violations)
        got = self.sections.get(section, (0, 0))
        self.sections[section] = (got[0] + cases,
                                  got[1] + len(violations))


def audit_roster() -> List[str]:
    """Every rule family the sweep audits, composites included.

    Returns:
      Sorted rule names, the reference's list: all statically registered
      rules plus representatives of each composite family (``bulyan-*``,
      ``buffered-*``, ``stale-*``, ``stale-exp-*``, ``fused-*``,
      ``reputation-*``, ``obs-*`` and their nestings); every name
      resolves through ``repro_torch.agg.resolve_rule``.
    """
    from repro_torch.agg.fused import FUSED_BASES
    bases = rule_names()
    roster = list(bases)
    roster += ["bulyan-krum", "bulyan-geomed"]
    roster += ["buffered-cwmed", "buffered-krum", "buffered-trimmed_mean",
               "buffered-bulyan-krum"]
    roster += [f"stale-{b}" for b in bases]
    roster += ["stale-bulyan-krum", "stale-buffered-cwmed",
               "stale-exp-krum", "stale-exp-cwmed"]
    roster += [f"fused-{b}" for b in FUSED_BASES]
    roster += ["stale-fused-krum"]
    roster += [f"reputation-{b}" for b in bases]
    roster += ["reputation-bulyan-krum", "reputation-buffered-cwmed",
               "reputation-stale-krum", "stale-reputation-krum",
               "reputation-fused-krum"]
    roster += ["obs-krum", "obs-cwmed", "obs-bulyan-krum",
               "obs-stale-krum", "obs-reputation-krum"]
    return sorted(roster)


def _stale_pattern(n: int, s: int) -> np.ndarray:
    """Deterministic non-uniform staleness pattern for step ``s``."""
    return (np.arange(n) + s) % 3


def _case_generator(device: torch.device, base_seed: int,
                    *parts) -> torch.Generator:
    """Per-case generator, seeded with crc32 (``hash()`` is salted)."""
    tag = zlib.crc32("/".join(str(p) for p in (base_seed,) + parts)
                     .encode())
    return torch.Generator(device=device).manual_seed(tag & 0x7FFFFFFF)


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """``N(1, 0.5)`` draws, the synthetic workers' distribution."""
    return torch.randn(shape, generator=gen, device=device) * 0.5 + 1.0


def _case_violations(name: str, attack: str, n: int, f: int,
                     cfg: SweepConfig, gen: torch.Generator,
                     device: torch.device) -> Tuple[int, List[str]]:
    """Run one (rule, attack, n, f) corner for ``cfg.steps`` steps."""
    rule = resolve_rule(name)
    attack_fn = None if attack == "none" else get_attack(attack)
    kw = dict(_ATTACK_KW.get(attack, {}))
    steps = cfg.steps if rule.stateful else 1
    out: List[str] = []
    state = (init_state(rule, torch.zeros((n, cfg.d), device=device))
             if rule.stateful else None)
    history: List[np.ndarray] = []
    prev = None
    for s in range(steps):
        honest = _normal(gen, (n - f, cfg.d), device)
        if attack_fn is None or f == 0:
            full = torch.cat([honest, _normal(gen, (f, cfg.d), device)])
        else:
            if attack in _DELAY_ATTACKS:
                kw.update(prev=prev, step=s)
            byz = attack_fn(honest, f, gen, **kw)
            prev = byz
            full = torch.cat([honest, byz])
        label = f"{name}/{attack}/n{n}/f{f}/s{s}"
        if rule.stateful:
            if "bus" in rule.state_fields:
                pat = _stale_pattern(n, s)
                state = state._replace(
                    step=s,
                    bus=state.bus._replace(versions=torch.as_tensor(
                        s - pat, dtype=torch.int32, device=device)))
            else:
                state = state._replace(step=s)
            res, new_state = rule.dense_fn(full, f, state)
        else:
            res = rule.dense_fn(full, f)
            new_state = state
        history.append(prewindow_stack(rule, full, state))
        eff = effective_stack(rule, full, state, history=history)
        out += check_rule_output(rule, res.gradient, res.selected, eff, f,
                                 label)
        state = new_state
    return steps, out


def _invariant_section(cfg: SweepConfig, report: AuditReport,
                       device: torch.device) -> None:
    """Rule x attack x (n, f) output-invariant grid."""
    for name in audit_roster():
        rule = resolve_rule(name)
        for f in cfg.fs:
            for extra in cfg.extra_n:
                # at least two honest workers: average's quorum is 1,
                # but attacks need a non-degenerate honest committee
                n = max(rule.min_n(f), f + 2) + extra
                for attack in cfg.attacks:
                    gen = _case_generator(device, cfg.seed, name, attack,
                                          n, f)
                    cases, violations = _case_violations(
                        name, attack, n, f, cfg, gen, device)
                    report.add("invariants", cases, violations)


def _quorum_section(cfg: SweepConfig, report: AuditReport,
                    device: torch.device) -> None:
    """Canonical quorum errors on both sides of every threshold."""
    from repro_torch.agg.specs import AggSpec, check_quorum
    for name in audit_roster():
        rule = resolve_rule(name)
        for f in cfg.quorum_fs:
            report.add("quorum", 1, check_quorum_contract(name, f))
        # distributed opt-in: tree-less rules raise the canonical
        # KeyError; rules with a tree implementation pass
        f = cfg.quorum_fs[0]
        n = rule.min_n(f)
        violations: List[str] = []
        try:
            check_quorum(name, n, f, distributed=True)
            if rule.tree_fn is None:
                violations.append(
                    f"{name}: tree-less rule accepted distributed=True")
        except KeyError as e:
            if rule.tree_fn is not None:
                violations.append(
                    f"{name}: has a tree implementation but "
                    f"distributed=True raised {e}")
        # a flat spec validated with an explicit worker count must never
        # demand a tree implementation
        try:
            AggSpec(f=f, gar=name).validate(n)
        except Exception as e:
            violations.append(
                f"{name}: flat validate(n={n}) wrongly raised "
                f"{type(e).__name__}: {e}")
        report.add("quorum", 2, violations)


def _identity_section(cfg: SweepConfig, report: AuditReport,
                      device: torch.device) -> None:
    """stale-* over a uniform committee is bitwise its base rule."""
    bases = [b for b in rule_names()
             if not resolve_rule(b).stateful] + ["bulyan-krum",
                                                 "fused-krum"]
    f = cfg.fs[0]
    # uniform staleness 0 / 3 and a clock-skewed *negative* staleness
    # (restored bus ahead of a zeroed step counter): all must clamp or
    # normalize to scale exactly 1.0
    for uniform_s in (0, 3, -2):
        for weight in ("", "exp-"):
            for base in bases:
                base_rule = resolve_rule(base)
                n = base_rule.min_n(f) + 1
                gen = _case_generator(device, cfg.seed + 1, base, weight,
                                      uniform_s)
                full = _normal(gen, (n, cfg.d), device)
                stale_name = f"stale-{weight}{base}"
                rule = resolve_rule(stale_name)
                state = init_state(rule, full)
                step = 5
                state = state._replace(
                    step=step,
                    bus=state.bus._replace(versions=torch.full(
                        (n,), step - uniform_s, dtype=torch.int32,
                        device=device)))
                got, _ = rule.dense_fn(full, f, state)
                want = base_rule.dense_fn(full, f)
                violations: List[str] = []
                if not torch.equal(got.gradient, want.gradient):
                    err = float(torch.max(torch.abs(
                        got.gradient.to(torch.float32)
                        - want.gradient.to(torch.float32))))
                    violations.append(
                        f"{stale_name}: uniform staleness {uniform_s} "
                        f"not bitwise-equal to {base} (max abs diff "
                        f"{err:.3g})")
                if not torch.equal(got.selected, want.selected):
                    violations.append(
                        f"{stale_name}: uniform staleness {uniform_s} "
                        f"changes the selection vs {base}")
                report.add("identity", 1, violations)


def _staleness_section(cfg: SweepConfig, report: AuditReport,
                       device: torch.device) -> None:
    """Delivery simulation: the declared bound is never exceeded."""
    from repro_torch.dist.async_train import (delivery_mask, init_bus,
                                              resolve_tau,
                                              staleness_excess, update_bus)
    n, steps = 7, 12
    for tau in cfg.taus:
        tau_arr = resolve_tau(tau, n, device=device)
        for schedule in cfg.schedules:
            violations: List[str] = []
            bus = init_bus(torch.zeros((n, cfg.d), device=device))
            gen = _case_generator(device, cfg.seed + 2, tau, schedule)
            for t in range(steps):
                grads = torch.randn((n, cfg.d), generator=gen,
                                    device=device)
                mask = delivery_mask(t, bus.versions, tau_arr,
                                     schedule=schedule, seed=cfg.seed)
                if int(torch.max(tau_arr)) == 0 and not bool(
                        torch.all(mask)):
                    violations.append(
                        f"tau=0/{schedule}: worker held back at step {t} "
                        f"(sync special case broken)")
                bus = update_bus(bus, grads, t, mask)
                excess = staleness_excess(bus, t, tau_arr).cpu().numpy()
                if (excess > 0).any():
                    violations.append(
                        f"tau={tau}/{schedule}: staleness bound exceeded "
                        f"at step {t} by {excess.tolist()}")
            report.add("staleness", steps, violations)


def _arbitrary_f_section(cfg: SweepConfig, report: AuditReport,
                         device: torch.device) -> None:
    """f >= n/2: quorum rules refuse canonically, reputation-* runs.

    At ``f = n/2`` and ``f = 3n/4`` every roster rule whose ``min_n(f)``
    exceeds the committee must raise the one canonical quorum
    ``ValueError``, while every ``reputation-*`` composite (``min_n``
    constant in f) must run, emit a finite aggregate, and keep its
    updated reputation weights inside ``[0, 1]``.
    """
    from repro_torch.agg.specs import check_quorum
    n = 8
    for f in (n // 2, 3 * n // 4):
        for name in audit_roster():
            rule = resolve_rule(name)
            need = rule.min_n(f)
            violations: List[str] = []
            label = f"arbitrary-f/{name}/n{n}/f{f}"
            if name.startswith("reputation-") and need > n:
                violations.append(
                    f"{label}: reputation composite lost the arbitrary-f "
                    f"contract (min_n({f}) = {need} > {n})")
            if need > n:
                want = f"{name} requires n >= {need} for f={f}, got n={n}"
                try:
                    check_quorum(name, n, f)
                    violations.append(
                        f"{label}: quorum-bound rule ran at f >= n/2 "
                        f"instead of refusing (need n >= {need})")
                except ValueError as e:
                    if str(e) != want:
                        violations.append(
                            f"{label}: non-canonical refusal {e!r} "
                            f"(want {want!r})")
            else:
                gen = _case_generator(device, cfg.seed + 5, "arbitraryf",
                                      name, n, f)
                full = _normal(gen, (n, cfg.d), device)
                state = init_state(rule, full) if rule.stateful else None
                if rule.stateful:
                    res, new_state = rule.dense_fn(full, f, state)
                else:
                    res = rule.dense_fn(full, f)
                    new_state = None
                violations += check_finite(res.gradient, label)
                if name.startswith("reputation-"):
                    rep = new_state.reputation.cpu().numpy()
                    if (rep < 0).any() or (rep > 1).any():
                        violations.append(
                            f"{label}: updated reputation outside [0, 1] "
                            f"(min {float(rep.min()):.3g}, max "
                            f"{float(rep.max()):.3g})")
            report.add("arbitrary-f", 1, violations)


def _fp32_section(cfg: SweepConfig, report: AuditReport,
                  device: torch.device) -> None:
    """bf16-input fp32-accumulation contract: kernels and tree path."""
    from repro_torch.dist.robust import distributed_aggregate
    from repro_torch.kernels.probes import (coord_fp32_contract_error,
                                            fused_fp32_contract_error,
                                            gram_fp32_contract_error)
    tol = 1e-4
    violations: List[str] = []
    for d, block_d in ((512, 256), (1536, 512)):
        # the tile width is the plain versions'; on the card each kernel
        # picks its own chunking
        tile = block_d if device.type == "cpu" else None
        err = gram_fp32_contract_error(n=8, d=d, block_d=tile,
                                       seed=cfg.seed, device=device)
        if err > tol:
            violations.append(
                f"pairwise_gram bf16 d={d} block={block_d}: rel err "
                f"{err:.3g} > {tol} — fp32 accumulation broken?")
        err = coord_fp32_contract_error(theta=9, f=2, d=d,
                                        block_d=tile, seed=cfg.seed,
                                        device=device)
        if err > tol:
            violations.append(
                f"bulyan_select bf16 d={d} block={block_d}: rel err "
                f"{err:.3g} > {tol} — fp32 accumulation broken?")
        for mode in ("bulyan-krum", "trimmed_mean"):
            err = fused_fp32_contract_error(n=11, f=2, d=d, mode=mode,
                                            block_d=tile, seed=cfg.seed,
                                            device=device)
            if err > tol:
                violations.append(
                    f"fused_aggregate[{mode}] bf16 d={d} "
                    f"block={block_d}: rel err {err:.3g} > {tol} — "
                    f"fp32 accumulation broken?")
    report.add("fp32", 8, violations)

    # the tree engine: a bf16 tree, default (fp32) accumulation, must
    # match the flat fp32 rule and keep the leaf dtype
    gen = _case_generator(device, cfg.seed + 3, "fp32-tree")
    n, f = 11, 2  # bulyan quorum: 4f + 3
    leaves = {
        "w": torch.randn((n, 24, 8), generator=gen, device=device
                         ).to(torch.bfloat16),
        "b": torch.randn((n, 40), generator=gen, device=device
                         ).to(torch.bfloat16),
    }
    flat = torch.cat(
        [leaves["b"].to(torch.float32).reshape(n, -1),
         leaves["w"].to(torch.float32).reshape(n, -1)], dim=1)
    for gar in ("krum", "cwmed", "bulyan-krum"):
        # "auto" is the plain PyTorch reference; "fused" reroutes the
        # rule onto its fused composite; both must track the flat fp32
        # rule and keep leaf dtypes
        for backend in ("auto", "fused"):
            violations = []
            agg, _ = distributed_aggregate(leaves, f, gar,
                                           distance_backend=backend)
            got = torch.cat(
                [agg["b"].to(torch.float32).reshape(-1),
                 agg["w"].to(torch.float32).reshape(-1)])
            want = resolve_rule(gar).dense_fn(flat, f).gradient
            scale = max(float(torch.max(torch.abs(want))), 1.0)
            err = float(torch.max(torch.abs(got - want))) / scale
            if err > 1e-2:  # bf16 output quantization, fp32 accumulation
                violations.append(
                    f"{gar}[{backend}]: bf16 tree path deviates from "
                    f"fp32 flat reference by rel {err:.3g}")
            for name, leaf in agg.items():
                if leaf.dtype != torch.bfloat16:
                    violations.append(
                        f"{gar}[{backend}]: leaf {name!r} came back "
                        f"{leaf.dtype}, input dtype not preserved")
            report.add("fp32", 1, violations)


def _speculative_section(cfg: SweepConfig, report: AuditReport,
                         device: torch.device) -> None:
    """Robust speculative serving: acceptance and aggregation contracts.

    For every stateless roster rule with a tree path (serving aggregates
    through ``aggregate_logits``) and every non-delay attack, a
    synthetic ``(n, B, k, vocab)`` verifier-logit stack is aggregated
    per position as ``make_robust_verify_step`` does, and two contracts
    are checked: each position's aggregate keeps the rule's declared
    invariants against the stack it consumed; and every token
    ``accept_block`` emits carries an aggregated logit within ``1e-5``
    of its position's maximum, counts lie in ``[1, k]``, a draft that
    copies the aggregate's argmax is accepted in full, and a colluding
    constant-token draft yields the aggregate's own argmax stream.
    """
    from repro_torch.dist.serve_robust import aggregate_logits
    from repro_torch.serving.speculative import accept_block
    batch, k_block, vocab = 2, 4, cfg.d
    f = cfg.fs[0]
    roster = [name for name in audit_roster()
              if resolve_rule(name).tree_fn is not None
              and not resolve_rule(name).stateful]
    attacks = [a for a in cfg.attacks if a not in _DELAY_ATTACKS]
    for name in roster:
        rule = resolve_rule(name)
        n = max(rule.min_n(f), f + 2) + cfg.extra_n[-1]
        for attack in attacks:
            violations: List[str] = []
            gen = _case_generator(device, cfg.seed + 4, "speculative", name,
                                  attack, n, f)
            honest = torch.randn((n - f, batch, k_block, vocab),
                                 generator=gen, device=device) * 0.5
            if attack == "none" or f == 0:
                byz = torch.randn((f, batch, k_block, vocab), generator=gen,
                                  device=device) * 0.5
            else:
                flat = get_attack(attack)(honest.reshape(n - f, -1), f, gen,
                                          **_ATTACK_KW.get(attack, {}))
                byz = flat.reshape(f, batch, k_block, vocab)
            stack = torch.cat([honest, byz])          # (n, B, k, V)
            aggs = []
            for j in range(k_block):
                agg, diag = aggregate_logits(stack[:, :, j, :], f, name)
                aggs.append(agg)
                violations += check_rule_output(
                    rule, agg.reshape(-1), diag.selected,
                    stack[:, :, j, :].reshape(n, -1).cpu().numpy()
                    .astype(np.float32), f,
                    f"speculative/{name}/{attack}/pos{j}")
            agg_logits = torch.stack(aggs, dim=1)      # (B, k, V)
            v = torch.argmax(agg_logits, dim=-1).cpu().numpy()
            t0 = torch.zeros((batch, 1), dtype=torch.int32, device=device)
            # a draft copying the aggregate's argmax is accepted in full;
            # a colluding constant-token draft yields the aggregate's own
            # stream (collusion costs throughput, never correctness)
            blocks = {
                "clean": torch.cat([t0, torch.as_tensor(
                    v[:, :k_block - 1], dtype=torch.int32, device=device)],
                    dim=1),
                "colluding": torch.cat([t0, torch.full(
                    (batch, k_block - 1), 3, dtype=torch.int32,
                    device=device)], dim=1),
            }
            anp = agg_logits.cpu().numpy().astype(np.float32)
            for kind, block in blocks.items():
                emitted, count, _ = accept_block(block, agg_logits)
                emitted = emitted.cpu().numpy()
                count = count.cpu().numpy()
                label = f"speculative/{name}/{attack}/{kind}"
                if ((count < 1) | (count > k_block)).any():
                    violations.append(
                        f"{label}: emission count {count.tolist()} "
                        f"outside [1, {k_block}]")
                for b in range(batch):
                    for j in range(int(count[b])):
                        gap = float(anp[b, j].max()
                                    - anp[b, j, emitted[b, j]])
                        if gap > 1e-5:
                            violations.append(
                                f"{label}: emitted token at slot {b} "
                                f"pos {j} trails the aggregate max by "
                                f"{gap:.3g} — not in the aggregate's "
                                f"support")
                if kind == "clean" and (count != k_block).any():
                    violations.append(
                        f"{label}: argmax-copying draft not fully "
                        f"accepted (counts {count.tolist()})")
                if kind == "colluding":
                    for b in range(batch):
                        got = emitted[b, :count[b]].tolist()
                        want = v[b, :count[b]].tolist()
                        if got != want:
                            violations.append(
                                f"{label}: colluding draft changed the "
                                f"accepted stream {got} vs aggregate "
                                f"argmax {want}")
            report.add("speculative", k_block + 2, violations)


#: the sections, in the reference's order
SECTIONS: Tuple[Tuple[str, Callable], ...] = (
    ("quorum", _quorum_section),
    ("identity", _identity_section),
    ("arbitrary-f", _arbitrary_f_section),
    ("staleness", _staleness_section),
    ("fp32", _fp32_section),
    ("invariants", _invariant_section),
    ("speculative", _speculative_section),
)


def run_sweep(cfg: Optional[SweepConfig] = None, device="cuda", *,
              section_hook: Optional[Callable] = None) -> AuditReport:
    """Run every ported section of the corner sweep.

    Args:
      cfg: sweep shape (``None`` = the full default grid; pass
        :data:`QUICK` for the quick variant).
      device: where the stacks live and the rules run (``"cuda"``, the
        default, raises when no card is present; ``"cpu"`` runs the
        plain PyTorch versions).
      section_hook: optional ``name -> context manager`` entered around
        each section (a caller's timer or launch counter).

    Returns:
      The populated :class:`AuditReport` (violations collected, never
      raised).
    """
    cfg = cfg or SweepConfig()
    dev = resolve_device(device)
    report = AuditReport()
    for name, section in SECTIONS:
        with (section_hook(name) if section_hook is not None
              else contextlib.nullcontext()):
            section(cfg, report, dev)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: run the sweep and report violations.

    Args:
      argv: command-line arguments (``None`` = ``sys.argv[1:]``);
        ``--quick`` selects the quick grid, ``--seed`` reseeds the
        deterministic case generators, ``--device`` picks the card or
        the CPU.

    Returns:
      Process exit code: the number of violations (0 = all contracts
      hold).
    """
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="quick grid: one (n, f) corner per rule")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed of the synthetic stacks")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(QUICK if args.quick else SweepConfig(),
                              seed=args.seed)
    report = run_sweep(cfg, device=args.device)
    for section, (cases, bad) in sorted(report.sections.items()):
        print(f"audit/{section}: {cases} cases, {bad} violations",
              flush=True)
    for v in report.violations:
        print(f"VIOLATION: {v}", flush=True)
    print(f"audit/total: {report.cases} cases, "
          f"{len(report.violations)} violations", flush=True)
    return len(report.violations)


if __name__ == "__main__":
    raise SystemExit(main())
