"""Synthetic token streams for the LM architectures (a copy of
``repro.data.lm_data``: numpy only, the same draws from the same seed).

Per-source streams with distinct token statistics (different Zipf exponents
and source-tag prefixes) so the multi-task LM setup has genuinely different
per-source distributions — the LM analogue of multi-fidelity data.
"""
from __future__ import annotations

import numpy as np


def zipf_tokens(rng, n, vocab, alpha=1.2, offset=0):
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return ((rng.choice(vocab, size=n, p=p) + offset) % vocab).astype(np.int32)


def make_lm_source(seed: int, n_seqs: int, seq_len: int, vocab: int,
                   alpha: float = 1.2, offset: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = zipf_tokens(rng, n_seqs * (seq_len + 1), vocab, alpha, offset)
    toks = toks.reshape(n_seqs, seq_len + 1)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def make_lm_sources(n_tasks: int, n_seqs: int, seq_len: int, vocab: int,
                    seed: int = 0) -> list[dict]:
    return [make_lm_source(seed + t, n_seqs, seq_len, vocab,
                           alpha=1.05 + 0.15 * t, offset=t * (vocab // max(n_tasks, 1)))
            for t in range(n_tasks)]
