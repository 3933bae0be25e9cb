"""The one traffic generator: every mix under ``bench/traffic/`` is a
file of parameters that these functions read.

``lm_batches`` is a frozen copy of ``repro_torch.data.synthetic.
lm_batches`` (a Markov-chain token stream), so the program's copy can
change without moving the benchmark's inputs.  ``request_pool`` draws
chat requests with heavy-tailed lengths.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np


def _transition_table(vocab: int, seed: int, branch: int = 4) -> np.ndarray:
    """Each token's ``branch`` likely successors: ``(vocab, branch)``."""
    rng = np.random.default_rng(seed + 13)
    return rng.integers(0, vocab, size=(vocab, branch)).astype(np.int32)


def lm_batches(vocab: int, batch: int, seq: int, step: int, *,
               seed: int = 0, branch: int = 4, noise_p: float = 0.05
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Markov-chain token stream: ``(tokens (B, S), labels (B, S))``
    int32, labels the next tokens; ``step`` is the stream position and
    ``seed`` fixes the transition table and the sampling."""
    table = _transition_table(vocab, seed, branch)
    rng = np.random.default_rng((seed, step, 3))
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    choices = rng.integers(0, branch, size=(batch, seq))
    noise = rng.random((batch, seq)) < noise_p
    rand_tok = rng.integers(0, vocab, size=(batch, seq))
    for t in range(seq):
        nxt = table[toks[:, t], choices[:, t]]
        toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))


def train_batches(traffic: dict, vocab: int, seed: int, count: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``count`` distinct step batches of a training mix, each
    ``(tokens, labels)`` of shape ``(workers, per_worker, seq)``.

    Every step's rows come from the stream at their own positions, so
    no two rows of any step, or of two steps, are alike."""
    n, per, seq = traffic["workers"], traffic["per_worker"], traffic["seq"]
    out = []
    for step in range(count):
        tok, lab = lm_batches(vocab, n * per, seq, step, seed=seed)
        out.append((tok.reshape(n, per, seq), lab.reshape(n, per, seq)))
    return out


def _lognormal_quantiles(median: float, sigma: float, lo: int, hi: int,
                         count: int) -> np.ndarray:
    """``count`` lengths at the mid-quantiles of a lognormal clipped to
    ``[lo, hi]``: the same multiset for every seed."""
    nd = NormalDist()
    q = [math.exp(math.log(median) + sigma * nd.inv_cdf((i + 0.5) / count))
         for i in range(count)]
    return np.clip(np.rint(q), lo, hi).astype(np.int64)


def request_pool(traffic: dict, vocab: int, seed: int):
    """The chat mix's requests, client by client.

    Prompt and output lengths are the mid-quantiles of their clipped
    lognormals (``traffic["prompt"]`` / ``["output"]``: ``median``,
    ``sigma``, ``min``, ``max``), paired and dealt into one sequence per
    client by a fixed shuffle (``traffic["deal"]``), the same for every
    seed: a closed loop then meets the same sizes in the same order
    whatever the seed, so the seed does not change the work (dealing
    the sequences to other clients would: requests that finish in one
    step are admitted in client order, each behind the prefills before
    it).  The seed draws the prompts' tokens, uniform over the
    vocabulary.

    Returns:
      ``clients`` lists, each of ``(prompt int32 array, max_new_tokens)``
      in the order the client sends them.
    """
    count, clients = traffic["pool"], traffic["clients"]
    p, o = traffic["prompt"], traffic["output"]
    plen = _lognormal_quantiles(p["median"], p["sigma"], p["min"], p["max"],
                                count)
    olen = _lognormal_quantiles(o["median"], o["sigma"], o["min"], o["max"],
                                count)
    fixed = np.random.default_rng(traffic["deal"])
    plen, olen = plen[fixed.permutation(count)], olen[fixed.permutation(count)]
    sequences = [list(zip(plen[c::clients], olen[c::clients]))
                 for c in range(clients)]
    rng = np.random.default_rng((seed, 11))
    return [[(rng.integers(0, vocab, size=int(pl)).astype(np.int32), int(ol))
             for pl, ol in seq] for seq in sequences]
