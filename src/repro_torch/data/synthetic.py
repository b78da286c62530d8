"""Synthetic LM corpora with PTB-like statistics.

A deterministic Zipf-distributed token stream stands in for the PTB
corpus of the paper's Fixed-/Var-LSTM experiments and for the LM archs'
training loop.  Determinism: the stream is a pure function of
(seed, position), so any worker/shard can regenerate any slice — this
is what makes the loader's hot-spare shard takeover (straggler guard)
free of coordination.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def synthetic_corpus(num_tokens: int, vocab: int, seed: int = 0,
                     alpha: float = 1.1) -> np.ndarray:
    """Zipf(alpha) token ids in ``[0, vocab)`` — heavy-tailed like text."""
    rng = np.random.default_rng(seed)
    # Inverse-CDF sampling over a truncated Zipf.
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    u = rng.random(num_tokens)
    return np.searchsorted(cdf, u).astype(np.int32)


def lm_batches(corpus: np.ndarray, batch: int, seq: int, *,
               seed: int = 0, shard: int = 0, num_shards: int = 1,
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless ``{tokens, labels}`` batches: next-token prediction windows.

    Sharded: worker ``shard`` of ``num_shards`` sees a disjoint window
    stream (round-robin by batch index), so data parallelism at any
    scale never duplicates samples within an epoch-equivalent.
    """
    n = corpus.shape[0] - seq - 1
    rng = np.random.default_rng(seed + shard)
    while True:
        starts = rng.integers(0, n, size=batch)
        toks = np.stack([corpus[s: s + seq] for s in starts])
        labs = np.stack([corpus[s + 1: s + seq + 1] for s in starts])
        yield {"tokens": toks, "labels": labs}


def token_batch_specs(batch: int, seq: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    return {"tokens": ((batch, seq), "int32"),
            "labels": ((batch, seq), "int32")}
