"""Deterministic synthetic LM data pipeline with per-host sharding (the
JAX package's ``data/pipeline.py``, numpy only, kept as the port's own copy
so that the port imports nothing of the reference).

Produces packed (tokens, labels) batches: documents with lognormal lengths
are concatenated with EOS separators; labels are next-token targets with -1
at padding and document boundaries.  Determinism: batch ``i`` of host ``h``
is a pure function of (seed, i, h) — a restarted job resumes bit-identically
from the step counter alone (no iterator state in checkpoints), and a
re-sharded (elastic) job stays deterministic per global batch index.  The
batches are bit for bit the reference's for every (seed, index, host_id,
n_hosts).

The "dataset" is a seeded token-level Markov sampler — enough structure that
cross-entropy drops measurably during the example runs (unlike uniform
noise), with zero external data dependencies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

EOS = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: float = 256.0
    n_hosts: int = 1
    host_id: int = 0


def _markov_row(rng: np.random.Generator, vocab: int, branch: int = 8):
    """Per-state successor table: each token has `branch` likely successors."""
    return rng.integers(1, vocab, size=branch)


class SyntheticLM:
    """Markov-chain token stream, packed into fixed-length sequences."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        base = np.random.default_rng(cfg.seed)
        # a small transition table shared by all hosts (the "corpus")
        self.branch = 8
        self.table = base.integers(
            1, cfg.vocab, size=(min(cfg.vocab, 4096), self.branch))

    def _sample_doc(self, rng: np.random.Generator) -> np.ndarray:
        n = max(2, int(rng.lognormal(np.log(self.cfg.mean_doc_len), 0.6)))
        out = np.empty(n, np.int32)
        tok = int(rng.integers(1, self.cfg.vocab))
        for i in range(n):
            out[i] = tok
            row = self.table[tok % self.table.shape[0]]
            tok = int(row[rng.integers(0, self.branch)]) if rng.random() > 0.1 \
                else int(rng.integers(1, self.cfg.vocab))
        return out

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """Global batch ``index`` — this host's shard of it."""
        cfg = self.cfg
        s = cfg.seq_len
        toks = np.zeros((self.local_batch, s + 1), np.int32)
        for b in range(self.local_batch):
            gi = index * cfg.global_batch + cfg.host_id * self.local_batch + b
            rng = np.random.default_rng((cfg.seed, 1, gi))
            pos = 0
            while pos < s + 1:
                doc = self._sample_doc(rng)
                take = min(len(doc), s + 1 - pos)
                toks[b, pos:pos + take] = doc[:take]
                pos += take
                if pos < s + 1:
                    toks[b, pos] = EOS
                    pos += 1
        tokens = toks[:, :-1]
        labels = toks[:, 1:].astype(np.int32)
        labels = np.where(tokens == EOS, -1, labels)   # no loss across docs
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1
