"""Robust speculative decoding: draft proposal and Byzantine-safe
acceptance (counterpart of ``repro/serving/speculative.py``).

The draft is one replica of the ensemble (``spec.draft_replica``)
decoding ``k - 1`` tokens greedily; the ensemble then scores the whole
block in one ``make_robust_verify_step`` call, aggregated per position
through the registry.  The Byzantine contract lives in the acceptance
rule (:func:`accept_block`): a draft token is emitted only if it
survives the robustly aggregated distribution, never a single
replica's, so a poisoned draft costs throughput (rejected blocks) but
never changes the accepted stream.

Block convention: a verify block of length ``k`` is ``[t0, d1, ...,
d_{k-1}]``, the last emitted token and the draft's proposals.  Fed at
positions ``p .. p+k-1``, the aggregates ``A_0 .. A_{k-1}`` predict the
tokens at ``p+1 .. p+k``; ``d_{j+1}`` is accepted iff it survives
``A_j``, and the first rejected position takes the aggregate's own
argmax.  Every block emits 1 to ``k`` tokens, and at ``k = 1`` the block
is ``[t0]`` with no draft at all, which makes the ``k = 1`` stream the
per-token stream bit for bit.  Ties in ``argmax`` go to the first
index, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.pytree import tree_map
from repro_torch.models import decode_step
from repro_torch.models.config import ModelConfig

__all__ = ["accept_block", "draft_cache_view", "make_draft_propose"]


def make_draft_propose(cfg: ModelConfig, k: int) -> Callable:
    """Build the greedy draft proposer for block length ``k``.

    Entries the draft writes for later-rejected proposals sit above the
    slot's accepted position, where ``decode_step``'s ``valid_len``
    masks them until the next block overwrites them, so the draft cache
    needs no rollback.

    Args:
      cfg: the draft's model configuration (the ensemble's).
      k: verify-block length (``>= 1``).

    Returns:
      ``propose(draft_params, draft_cache, token, pos) -> (block,
      new_draft_cache)``: ``k - 1`` greedy ``decode_step`` calls from the
      last emitted ``token`` (``(B,)`` int32 at positions ``pos``), and
      the ``(B, k)`` block ``[t0, d1, ..., d_{k-1}]``.  At ``k = 1`` no
      draft runs: the block is ``token[:, None]`` and the cache passes
      through untouched.
    """
    if k < 1:
        raise ValueError(f"speculative block length must be >= 1, got {k}")
    if k == 1:
        def propose_identity(draft_params, draft_cache, token, pos):
            del draft_params, pos
            return token[:, None], draft_cache
        return propose_identity

    def propose(draft_params, draft_cache, token, pos):
        tok = token
        p = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
        block = [token]
        for _ in range(k - 1):
            logits, draft_cache = decode_step(draft_params, cfg, draft_cache,
                                              tok[:, None], p)
            tok = torch.argmax(logits[:, 0, :], dim=-1).to(token.dtype)
            block.append(tok)
            p = p + 1
        return torch.stack(block, dim=1), draft_cache

    return propose


def accept_block(block: torch.Tensor, agg_logits: torch.Tensor, *,
                 margin: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Byzantine-safe acceptance of draft tokens against the aggregate.

    ``agg_logits[:, j]`` is the robust distribution of the token at
    ``p + j + 1``; proposal ``block[:, j+1]`` is accepted iff its
    aggregated logit is within ``margin`` of that distribution's maximum
    (``margin = 0``: it must be an argmax).  The emission is the longest
    accepted prefix plus one correction, the aggregate's argmax at the
    first rejected position.

    Args:
      block: ``(B, k)`` verify block ``[t0, d1, ..., d_{k-1}]``.
      agg_logits: ``(B, k, V)`` aggregated verifier logits.
      margin: acceptance slack in logit units (only widens acceptance;
        every emitted token still lies within ``margin`` of its
        position's aggregated maximum).

    Returns:
      ``(emitted, count, verifier_argmax)``: ``emitted`` ``(B, k)``
      int32 whose first ``count[b]`` entries are slot ``b``'s tokens,
      ``count`` ``(B,)`` int32 in ``[1, k]``, and the ``(B, k)`` argmax
      of ``agg_logits``.
    """
    b, k = block.shape
    v = torch.argmax(agg_logits, dim=-1).to(torch.int32)     # (B, k)
    if k == 1:
        return v, torch.ones((b,), dtype=torch.int32,
                             device=block.device), v
    drafts = block[:, 1:].to(torch.int64)                    # (B, k-1)
    scored = agg_logits[:, :-1, :]                           # (B, k-1, V)
    top = torch.amax(scored, dim=-1)
    dscore = torch.gather(scored, -1, drafts[..., None])[..., 0]
    ok = dscore >= top - torch.tensor(margin, dtype=torch.float32)
    prefix = torch.cumprod(ok.to(torch.int32), dim=1)
    m = torch.sum(prefix, dim=1)                             # 0..k-1
    cols = torch.arange(k, device=block.device)[None, :]
    drafts_pad = torch.cat([drafts, drafts[:, -1:]], dim=1).to(torch.int32)
    emitted = torch.where(cols < m[:, None], drafts_pad, v)
    return emitted, (m + 1).to(torch.int32), v


def draft_cache_view(stacked_cache: Any, replica: int, mesh=None,
                     n_replicas: Optional[int] = None) -> Any:
    """One replica's slice of a replica-stacked cache tree (the engine
    splices the draft replica's prefilled cache into the draft's own).

    Args:
      stacked_cache: a cache tree with a leading ``(n_replicas,)`` axis
        on every leaf (under a mesh, this rank's replicas').
      replica: which replica (its index in the whole ensemble).
      mesh: a rank's ``Mesh``, or ``None``.  When ``data`` splits the
        ensemble, the rank holding ``replica`` broadcasts its slice over
        ``data``, so every rank's draft starts from the same cache.
      n_replicas: the ensemble's size (needed with ``mesh``).

    Returns:
      The cache tree without the replica axis.
    """
    if mesh is not None:
        from repro_torch.dist.sharding import replica_rows
        rows, split = replica_rows(n_replicas, mesh)
        if split:
            owner, local = divmod(replica, rows.stop - rows.start)
            mine = mesh.index("data") == owner
            # a rank without the replica receives into a slice-shaped
            # buffer
            return tree_map(lambda x: mesh.broadcast(
                x[local if mine else 0], "data", owner), stacked_cache)
    return tree_map(lambda x: x[replica], stacked_cache)
