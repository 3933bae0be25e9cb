"""Byzantine attacks (counterpart of ``repro/core/attacks.py``).

The paper's omniscient adversary (§3.2/§3.3) waits for the n - f honest
gradients and submits ``B(gamma) = mean(honest) + gamma * E``, with ``E``
a signed one-hot coordinate (``omniscient_lp``) or a +-1 vector
(``omniscient_linf``), ``gamma`` either the paper's §B closed form, a
fixed value, or the largest value the rule still selects (growth then
bisection against the rule itself).

The extra baselines of the reference: ALIE (Baruch et al. 2019), IPM
(Xie et al. 2019), sign-flip, mimic, random noise and zero.  The
asynchronous runtime's delay-exploiting ``stale_replay`` and
``slow_drift`` read ``prev``, the adversary's previous bus rows; the
reputation runtime's ``reputation_burn`` builds trust and then spends it,
and ``colluding_majority`` submits f identical rows a bounded distance
off the honest mean.  Randomness (``random``, ``colluding_majority``'s
random direction) comes from the ``torch.Generator`` passed in, so its
stream differs from the reference's ``jax.random`` one.

All attacks have the signature
``attack(honest: (n_h, d), f, generator=None, **kw) -> (f, d)``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.core import gars

__all__ = ["ATTACKS", "alie", "colluding_majority", "find_gamma_max",
           "gamma_closed_form", "get_attack", "ipm",
           "make_selection_checker", "mimic", "omniscient_linf",
           "omniscient_lp", "random_noise", "reputation_burn", "signflip",
           "slow_drift", "stale_replay", "zero"]


def make_selection_checker(gar_name: str, f: int) -> Callable:
    """``check(full_grads) -> bool tensor``: True when one of the last f
    rows (the Byzantine submissions) carries weight in the rule's output.

    Args:
      gar_name: rule the adversary targets.
      f: Byzantine row count.

    Returns:
      The checker callable.
    """
    gar = gars.get_gar(gar_name)

    def check(full_grads: torch.Tensor) -> torch.Tensor:
        res = gar(full_grads, f)
        return torch.sum(res.selected[-f:]) > 0

    return check


def find_gamma_max(honest: torch.Tensor, f: int, direction: torch.Tensor,
                   check: Callable, gamma0: float = 1e-3,
                   n_grow: int = 26, n_bisect: int = 30) -> torch.Tensor:
    """Largest gamma such that ``mean(honest) + gamma * direction`` is still
    selected (per ``check``): geometric growth to bracket, then bisection.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      direction: ``(d,)`` attack direction.
      check: selection checker (:func:`make_selection_checker`).
      gamma0: first probed gamma.
      n_grow: growth steps (gamma doubles each step).
      n_bisect: bisection steps.

    Returns:
      0-d tensor, the largest selected gamma found.
    """
    mean = torch.mean(honest, dim=0)
    dt = honest.dtype

    def selected(gamma):
        byz = mean[None, :] + gamma * direction[None, :]
        full = torch.cat([honest, byz.expand(f, -1)], dim=0)
        return check(full)

    lo = torch.zeros((), dtype=dt, device=honest.device)
    hi = torch.full((), float("inf"), dtype=dt, device=honest.device)
    g = torch.full((), gamma0, dtype=dt, device=honest.device)
    for _ in range(n_grow):
        sel = selected(g)
        lo = torch.where(sel & (g > lo), g, lo)
        hi = torch.where((~sel) & (g < hi), g, hi)
        g = g * 2.0
    hi = torch.where(torch.isfinite(hi), hi, lo * 2.0 + gamma0)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        sel = selected(mid)
        lo, hi = torch.where(sel, mid, lo), torch.where(sel, hi, mid)
    return lo


def gamma_closed_form(rule: str, d: int, f: int, delta_bar: float,
                      p: int = 2) -> float:
    """The paper's §B approximations of gamma_m (order of magnitude only).

    Args:
      rule: ``"brute"``, ``"krum"`` or ``"geomed"``.
      d: dimension.
      f: Byzantine count.
      delta_bar: average folded per-coordinate spread.
      p: norm order.

    Returns:
      The estimate as a Python float.
    """
    if rule == "brute":
        return float(((1.0 - 2.0 ** (-p / 2.0)) * d) ** (1.0 / p) * delta_bar)
    q = 2.0 if rule == "krum" else 1.0
    b = 0.0
    inner = ((f + 1.0 - b) / (2.0 - b)) ** (p / q) - 2.0 ** (-p / 2.0)
    return float(max(inner, 1e-9) ** (1.0 / p) * d ** (1.0 / p) * delta_bar)


def _delta_bar(honest: torch.Tensor) -> torch.Tensor:
    """Paper §B.1: mean folded std per coordinate, 2 sigma / sqrt(pi).
    ``jnp.std`` is the population std, hence ``correction=0``."""
    c = 2.0 / torch.sqrt(torch.tensor(math.pi, dtype=torch.float32))
    return c.to(honest.device) * torch.mean(
        torch.std(honest, dim=0, correction=0))


def _closed_rule(gar_name: str) -> str:
    base = (gar_name.split("-", 1)[1] if gar_name.startswith("bulyan-")
            else gar_name)
    return base if base in ("krum", "geomed", "brute") else "krum"


def _closed_gamma(rule: str, d: int, f: int, db: torch.Tensor,
                  p: int = 2) -> torch.Tensor:
    rule = _closed_rule(rule)
    if rule == "brute":
        return ((1.0 - 2.0 ** (-p / 2.0)) * d) ** (1.0 / p) * db
    q = 2.0 if rule == "krum" else 1.0
    inner = max(((f + 1.0) / 2.0) ** (p / q) - 2.0 ** (-p / 2.0), 1e-9)
    return inner ** (1.0 / p) * d ** (1.0 / p) * db


def _gamma(honest, f, e, gamma, gar_name, margin, closed):
    if gamma is None:
        return find_gamma_max(honest, f, e,
                              make_selection_checker(gar_name, f)) * margin
    if gamma == "closed":
        return closed() * margin
    return torch.tensor(gamma, dtype=honest.dtype, device=honest.device)


def omniscient_lp(honest: torch.Tensor, f: int, generator=None, *,
                  coord=0, gamma=None, gar_name: str = "krum",
                  margin: float = 1.0, step=None) -> torch.Tensor:
    """§3.2: one poisoned coordinate just inside the selection margin.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      coord: int, ``"rotate"`` (``step mod d``) or ``"top"`` (the largest
        honest-mean coordinate, attacked against its sign).
      gamma: ``None`` (search), ``"closed"`` (§B estimate) or a float.
      gar_name: rule the adversary targets.
      margin: factor applied to the found or estimated gamma.
      step: training step (for ``coord="rotate"``).

    Returns:
      ``(f, d)`` identical Byzantine rows.
    """
    del generator
    d = honest.shape[1]
    mean = torch.mean(honest, dim=0)
    sign = 1.0
    if coord == "rotate":
        c = (0 if step is None else int(step)) % d
    elif coord == "top":
        c = int(torch.argmax(torch.abs(mean)))
        sign = -torch.sign(mean[c])
    else:
        c = int(coord)
    e = torch.zeros((d,), dtype=honest.dtype, device=honest.device)
    e[c] = 1.0
    e = e * sign
    g = _gamma(honest, f, e, gamma, gar_name, margin,
               lambda: _closed_gamma(gar_name, d, f, _delta_bar(honest)))
    byz = mean[None, :] + g * e[None, :]
    return byz.repeat(f, 1)


def _anti_or_ones(mean: torch.Tensor, direction: str) -> torch.Tensor:
    """``"anti"``: against the sign of the honest mean, a zero mean
    counting as +1; otherwise the all-ones vector."""
    if direction == "anti":
        e = -torch.sign(mean)
        return torch.where(e == 0, torch.ones_like(e), e)
    return torch.ones_like(mean)


def omniscient_linf(honest: torch.Tensor, f: int, generator=None, *,
                    gamma=None, gar_name: str = "krum",
                    margin: float = 1.0, step=None,
                    direction: str = "ones") -> torch.Tensor:
    """§3.3: poison every coordinate by gamma.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      gamma: ``None`` (search), ``"closed"`` (per-coordinate leeway
        ``delta_bar``) or a float.
      gar_name: rule the adversary targets.
      margin: factor applied to the found or estimated gamma.
      step: unused (signature parity).
      direction: ``"ones"`` or ``"anti"`` (against the sign of the honest
        mean; a zero sign counts as +1, as ``jnp.sign(0) = 0`` is mapped
        to +1 in the reference).

    Returns:
      ``(f, d)`` identical Byzantine rows.
    """
    del generator, step
    mean = torch.mean(honest, dim=0)
    e = _anti_or_ones(mean, direction)
    g = _gamma(honest, f, e, gamma, gar_name, margin,
               lambda: _delta_bar(honest))
    byz = mean[None, :] + g * e[None, :]
    return byz.repeat(f, 1)


def _alie_z(n: int, f: int) -> float:
    """ALIE's default z: the normal quantile that leaves a corrupted
    majority of supporters, computed in fp32 as the reference does."""
    s = (n // 2) + 1 - f
    phi = max(min((n - f - s) / float(n - f), 1.0 - 1e-6), 1e-6)
    return float(torch.special.ndtri(torch.tensor(phi, dtype=torch.float32)))


def alie(honest: torch.Tensor, f: int, generator=None, *,
         z: Optional[float] = None) -> torch.Tensor:
    """"A Little Is Enough": shift every coordinate by z standard
    deviations (the population std, as ``jnp.std``).

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      z: the shift in standard deviations (default :func:`_alie_z`).

    Returns:
      ``(f, d)`` identical Byzantine rows.
    """
    del generator
    if z is None:
        z = _alie_z(honest.shape[0] + f, f)
    mu = torch.mean(honest, dim=0)
    sd = torch.std(honest, dim=0, correction=0)
    return (mu - z * sd)[None, :].repeat(f, 1)


def ipm(honest: torch.Tensor, f: int, generator=None, *,
        eps: float = 0.5) -> torch.Tensor:
    """Inner-product manipulation: submit ``-eps * mean(honest)``.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      eps: the factor.

    Returns:
      ``(f, d)`` identical Byzantine rows.
    """
    del generator
    return (-eps * torch.mean(honest, dim=0))[None, :].repeat(f, 1)


def signflip(honest: torch.Tensor, f: int, generator=None, *,
             scale: float = 1.0) -> torch.Tensor:
    """Submit ``-scale * mean(honest)``.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      scale: flip magnitude.

    Returns:
      ``(f, d)`` identical Byzantine rows.
    """
    del generator
    byz = -scale * torch.mean(honest, dim=0)
    return byz[None, :].repeat(f, 1)


def zero(honest: torch.Tensor, f: int, generator=None) -> torch.Tensor:
    """Submit zeros.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).

    Returns:
      ``(f, d)`` zeros.
    """
    del generator
    return torch.zeros((f, honest.shape[1]), dtype=honest.dtype,
                       device=honest.device)


def random_noise(honest: torch.Tensor, f: int, generator=None, *,
                 scale: float = 10.0) -> torch.Tensor:
    """Submit ``scale`` times standard normal noise.

    Args:
      honest: ``(n_h, d)`` honest rows (only the width, dtype and device
        are read).
      f: Byzantine row count.
      generator: the ``torch.Generator`` the noise is drawn from.
      scale: noise magnitude.

    Returns:
      ``(f, d)`` noise rows.
    """
    return scale * torch.randn((f, honest.shape[1]), generator=generator,
                               dtype=honest.dtype, device=honest.device)


def mimic(honest: torch.Tensor, f: int, generator=None, *,
          target: int = 0) -> torch.Tensor:
    """Copy one honest worker.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      target: the copied worker.

    Returns:
      ``(f, d)`` copies of ``honest[target]``.
    """
    del generator
    return honest[target][None, :].repeat(f, 1)


def _step(step) -> int:
    return 0 if step is None else int(step)


def stale_replay(honest: torch.Tensor, f: int, generator=None, *,
                 prev: Optional[torch.Tensor] = None, step=None,
                 hold: int = 0, scale: float = 1.0) -> torch.Tensor:
    """Replay a once-credible gradient: record ``scale * mean(honest)``
    at step 0 (and every ``hold`` steps when ``hold > 0``), resubmit
    ``prev`` otherwise.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      prev: ``(f, d)`` the adversary's previous bus rows (``None``: the
        synchronous runtime, which records every step).
      step: the bus step.
      hold: re-record period (0: freeze after step 0).
      scale: factor on the recorded mean.

    Returns:
      ``(f, d)`` Byzantine rows.
    """
    del generator
    rec = (scale * torch.mean(honest, dim=0))[None, :].repeat(f, 1)
    if prev is None:
        return rec
    t = _step(step)
    refresh = t == 0 or (hold > 0 and t % hold == 0)
    return rec if refresh else prev.to(honest.dtype)


def slow_drift(honest: torch.Tensor, f: int, generator=None, *,
               prev: Optional[torch.Tensor] = None, step=None,
               eps: float = 0.5, direction: str = "anti") -> torch.Tensor:
    """Drift from the honest mean by ``eps * delta_bar`` per step along
    ``direction`` (``"anti"``: against the sign of the honest mean,
    ``"ones"``: the all-ones vector).

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      prev: ``(f, d)`` the adversary's previous bus rows (``None``: one
        drift step off the mean).
      step: the bus step (step 0 submits the mean).
      eps: drift per step in units of delta_bar.
      direction: ``"anti"`` or ``"ones"``.

    Returns:
      ``(f, d)`` Byzantine rows.
    """
    del generator
    mean = torch.mean(honest, dim=0)
    rec = mean[None, :].repeat(f, 1)
    e = _anti_or_ones(mean, direction)
    db = _delta_bar(honest)
    if prev is None:
        return rec + eps * db * e[None, :]
    if _step(step) == 0:
        return rec
    drifted = prev.to(torch.float32) + eps * db * e[None, :]
    return drifted.to(honest.dtype)


def reputation_burn(honest: torch.Tensor, f: int, generator=None, *,
                    prev: Optional[torch.Tensor] = None, step=None,
                    build: int = 5, scale: float = 3.0) -> torch.Tensor:
    """Build trust with the honest mean for ``build`` steps, then submit
    ``-scale * mean``.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: unused (signature parity).
      prev: unused (signature parity with the delay attacks).
      step: the training step.
      build: length of the trust-building phase.
      scale: the flip's magnitude.

    Returns:
      ``(f, d)`` identical Byzantine rows.
    """
    del generator, prev
    mean = torch.mean(honest, dim=0)
    byz = mean if _step(step) < build else -scale * mean
    return byz[None, :].repeat(f, 1)


def colluding_majority(honest: torch.Tensor, f: int, generator=None, *,
                       eps: float = 4.0,
                       direction: str = "random") -> torch.Tensor:
    """f identical colluders at ``mean + eps * delta_bar * u``, ``u`` a
    unit direction.

    Args:
      honest: ``(n_h, d)`` honest rows.
      f: Byzantine row count.
      generator: the ``torch.Generator`` of the ``"random"`` direction
        (``None``: one seeded with 0).
      eps: offset in units of delta_bar.
      direction: ``"random"`` (a normal draw, normalized) or ``"anti"``
        (``-mean / |mean|``).

    Returns:
      ``(f, d)`` identical Byzantine rows.
    """
    d = honest.shape[1]
    mean = torch.mean(honest, dim=0)
    if direction == "anti":
        u = -(mean / (torch.linalg.vector_norm(mean) + 1e-12))
    elif direction == "random":
        if generator is None:
            generator = torch.Generator(honest.device).manual_seed(0)
        u = torch.randn((d,), generator=generator, dtype=torch.float32,
                        device=honest.device)
        u = (u / (torch.linalg.vector_norm(u) + 1e-12)).to(honest.dtype)
    else:
        raise ValueError(
            f"colluding_majority direction must be 'random' or 'anti', "
            f"got {direction!r}")
    byz = mean + eps * _delta_bar(honest) * u
    return byz[None, :].repeat(f, 1)


ATTACKS = {
    "none": None,
    "omniscient_lp": omniscient_lp,
    "omniscient_linf": omniscient_linf,
    "alie": alie,
    "ipm": ipm,
    "signflip": signflip,
    "random": random_noise,
    "zero": zero,
    "mimic": mimic,
    "stale_replay": stale_replay,
    "slow_drift": slow_drift,
    "reputation_burn": reputation_burn,
    "colluding_majority": colluding_majority,
}


def get_attack(name: str):
    """Resolve an attack by name.

    Args:
      name: a key of :data:`ATTACKS`.

    Returns:
      The attack callable (``None`` for ``"none"``).  Raises ``KeyError``
      for an unknown name.
    """
    if name not in ATTACKS:
        raise KeyError(f"unknown attack {name!r}; have {sorted(ATTACKS)}")
    return ATTACKS[name]
