"""Byzantine-robust aggregation core (counterpart of ``repro/core``).

Public API::

    from repro_torch.core import get_gar, get_attack, aggregate_pytree
    agg = get_gar("bulyan-krum")(grads, f)        # grads: (n, d)
    byz = get_attack("omniscient_lp")(honest, f, generator, gar_name="krum")
"""
from repro_torch.core.gars import (REGISTRY, average, brute, centered_clip,
                                   cwmed, geomed, get_gar, krum, multikrum,
                                   pairwise_sq_dists, quorum, trimmed_mean)
from repro_torch.core.bulyan import (coordinate_phase, coordinate_phase_ref,
                                     make_bulyan, select_indices)
from repro_torch.core.attacks import (ATTACKS, find_gamma_max,
                                      gamma_closed_form, get_attack,
                                      make_selection_checker)
from repro_torch.core.pytree import aggregate_pytree, stack_flatten, unflatten
from repro_torch.core.types import AggResult, AttackResult, GarSpec

__all__ = [
    "REGISTRY", "ATTACKS", "AggResult", "AttackResult", "GarSpec",
    "aggregate_pytree", "average", "brute", "centered_clip",
    "coordinate_phase", "coordinate_phase_ref", "cwmed", "find_gamma_max",
    "gamma_closed_form", "geomed", "get_attack", "get_gar", "krum",
    "make_bulyan", "make_selection_checker", "multikrum",
    "pairwise_sq_dists", "quorum", "select_indices", "stack_flatten",
    "trimmed_mean", "unflatten",
]
