"""Single-host serving (counterpart of ``repro/serving``): the
continuous-batching engine and robust speculative decoding.

``ServingEngine`` drives the model zoo's prefill / decode path with
fixed-slot continuous batching; its ``ensemble=`` mode is the
Byzantine-resilient ensemble server of ``repro_torch.dist.serve_robust``
(robust logits aggregation per decode step), and
``ensemble.speculative_k`` switches it to robust speculative decoding
(``repro_torch.serving.speculative``: a draft replica proposes, the
aggregate verifies).
"""
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.speculative import (accept_block, draft_cache_view,
                                             make_draft_propose)

__all__ = ["Request", "ServingEngine", "accept_block", "draft_cache_view",
           "make_draft_propose"]
