"""Hand-written CUDA kernels for the aggregation hot path, each with its
plain PyTorch version beside it (counterpart of ``repro/kernels``).

  pairwise_gram  — K1: the (n, n) squared-distance matrix, per slab or
                   over a gradient tree.
  bulyan_select  — K2: Bulyan's coordinate phase (sort + window).
  coord_stats    — K3: coordinate-wise median + f-trimmed mean from one
                   sort.
  fused_agg      — the selection kernel, K4 (select-combine +
                   coordinate phase) and K5 (the whole rule).

``ops`` dispatches between the kernels and the oracles of ``ref``;
``probes`` holds the fp32-accumulation contract probes.  The reference's
``resolve_interpret`` (Pallas interpret mode) has no counterpart: a CPU
tensor takes a kernel's plain version.
"""
from repro_torch.kernels.bulyan_select import bulyan_select
from repro_torch.kernels.coord_stats import coord_stats
from repro_torch.kernels.fused_agg import (fused_aggregate, fused_coordinate,
                                           select_weights)
from repro_torch.kernels.pairwise_gram import (pairwise_gram,
                                               pairwise_gram_partial,
                                               pairwise_gram_tree)
from repro_torch.kernels import ops, probes, ref

__all__ = ["bulyan_select", "coord_stats", "fused_aggregate",
           "fused_coordinate", "ops", "pairwise_gram",
           "pairwise_gram_partial", "pairwise_gram_tree", "probes", "ref",
           "select_weights"]
