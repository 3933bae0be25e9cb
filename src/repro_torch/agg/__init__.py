"""The aggregation-rule registry (counterpart of ``repro/agg``).

Public API::

    from repro_torch.agg import resolve_rule, AggSpec, AggState, init_state

    rule = resolve_rule("bulyan-krum")          # one string resolver
    res = rule.dense_fn(grads, f)               # flat (n, d) path

    rule = resolve_rule("buffered-cwmed")       # stateful history rule
    state = init_state(rule, grads)             # zeroed AggState
    res, state = rule.dense_fn(grads, f, state)
"""
from repro_torch.agg.registry import (AggregatorRule, TreeAgg, TreeContext,
                                      quorum, register_rule,
                                      register_tree_impl, resolve_rule,
                                      rule_names)
from repro_torch.agg.specs import AggSpec, check_quorum
from repro_torch.agg.state import AggState, init_state
from repro_torch.agg.buffered import centered_clip_momentum, make_buffered
from repro_torch.agg.staleness import make_stale, stale_scale, stale_weights
from repro_torch.agg.reputation import (make_reputation, reputation_scale,
                                        reputation_scores,
                                        step_size_multiplier,
                                        tree_reputation_scores,
                                        update_reputation)

__all__ = [
    "AggSpec", "AggState", "AggregatorRule", "TreeAgg", "TreeContext",
    "centered_clip_momentum", "check_quorum", "init_state",
    "make_buffered", "make_reputation", "make_stale", "quorum",
    "register_rule", "register_tree_impl", "reputation_scale",
    "reputation_scores", "resolve_rule", "rule_names", "stale_scale",
    "stale_weights", "step_size_multiplier", "tree_reputation_scores",
    "update_reputation",
]
