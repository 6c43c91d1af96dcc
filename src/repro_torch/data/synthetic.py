"""Deterministic synthetic corpus + the paper's calibration protocol.

Offline container => no C4/WikiText. The corpus is a mixture of affine
(mod-vocab) Markov chains with controllable noise: documents follow
``next = (a·cur + b + ε) mod V`` with (a, b) drawn per-document from a
small family and ε a geometric-ish small step. An LM can learn this
structure (ppl well below uniform), pruning damages it measurably, and
generation is pure-numpy fast at any vocab size.

Determinism / fault tolerance: every batch is a pure function of
(seed, step, host). After a failover the pipeline replays identically
from the restored step — no iterator state to checkpoint.

Calibration follows SparseGPT/Wanda: 128 sequences of length 2048
(the "first shard of C4" protocol, §III-A2), same sampler for every
method being compared.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

N_CHAINS = 8        # mixture size
NOISE_W = 4         # ε ∈ [0, NOISE_W)
UNIFORM_P = 0.1     # fraction of pure-noise tokens (loss floor)


def _chain_params(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.choice(np.arange(1, min(vocab, 97), 2), size=N_CHAINS)
    b = rng.integers(0, vocab, size=N_CHAINS)
    return np.stack([a, b], axis=1)                     # (N_CHAINS, 2)


def _gen_tokens(vocab: int, seed: int, n_seq: int, seq_len: int,
                salt: int) -> np.ndarray:
    """(n_seq, seq_len+1) int32 — +1 so inputs/labels can be shifted."""
    rng = np.random.default_rng((seed * 0x9E3779B9 + salt) % (2 ** 63))
    chains = _chain_params(vocab, seed)
    which = rng.integers(0, N_CHAINS, size=n_seq)
    a = chains[which, 0][:, None]
    b = chains[which, 1][:, None]
    s = seq_len + 1
    eps = rng.integers(0, NOISE_W, size=(n_seq, s))
    uni = rng.random((n_seq, s)) < UNIFORM_P
    rand_tok = rng.integers(0, vocab, size=(n_seq, s))
    toks = np.empty((n_seq, s), dtype=np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=n_seq)
    for t in range(1, s):
        nxt = (a[:, 0] * toks[:, t - 1] + b[:, 0] + eps[:, t]) % vocab
        toks[:, t] = np.where(uni[:, t], rand_tok[:, t], nxt)
    return toks.astype(np.int32)


class SyntheticCorpus:
    """Stateless batch source: batch(step) is deterministic."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int,
              host: int = 0) -> Dict[str, np.ndarray]:
        salt = step * 1_000_003 + host * 7_919 + 1
        toks = _gen_tokens(self.vocab, self.seed, batch_size, seq_len, salt)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def eval_batches(self, n_batches: int, batch_size: int, seq_len: int):
        """Held-out split (disjoint salt space from training steps)."""
        for i in range(n_batches):
            salt = -(i + 1) * 104_729
            toks = _gen_tokens(self.vocab, self.seed, batch_size, seq_len,
                               salt)
            yield {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def host_shard(batch: Dict[str, np.ndarray], host: int, n_hosts: int
               ) -> Dict[str, np.ndarray]:
    """Slice a global batch for one host (multi-host input pipeline)."""
    def cut(x):
        per = x.shape[0] // n_hosts
        return x[host * per:(host + 1) * per]
    return {k: cut(v) for k, v in batch.items()}


def calibration_batch(vocab: int, seed: int = 0, n_seq: int = 128,
                      seq_len: int = 2048) -> np.ndarray:
    """The SparseGPT/Wanda calibration protocol: 128 × 2048 tokens."""
    return _gen_tokens(vocab, seed, n_seq, seq_len - 1, salt=0xCA1B)[:, :seq_len]
