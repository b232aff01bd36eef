"""Deterministic, shardable, resumable synthetic-token data pipeline (port
of ``repro.data.pipeline``, numpy only: its batches are the reference's bit
for bit).

Design mirrors a production loader even though the token source is
synthetic (the repo ships no dataset):

* **determinism** — batch ``i`` is a pure function of (seed, i); every
  host computes only its slice, so a restart at step ``k`` reproduces the
  exact stream without replaying.
* **sharding** — ``host_slice(batch, host_index, host_count)`` returns
  this process's batch rows.
* **resumability** — :class:`PipelineState` is a (seed, step) pair stored
  inside every checkpoint; restore = construct + ``seek(step)`` (O(1)).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(int(d["seed"]), int(d["step"]))


class DataPipeline:
    """Synthetic next-token-prediction batches with markov-ish structure
    (so losses actually decrease and overfitting tests are meaningful)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_docs: int = 64):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.state = PipelineState(seed=seed, step=0)
        # fixed fake corpus: a bank of repeating "documents"
        rng = np.random.default_rng(seed ^ 0x5EED)
        self._docs = rng.integers(0, vocab, size=(n_docs, seq_len + 1),
                                  dtype=np.int32)

    def seek(self, step: int):
        self.state.step = step

    def _batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.state.seed << 20) ^ step)
        doc_ids = rng.integers(0, self._docs.shape[0], size=self.global_batch)
        seqs = self._docs[doc_ids]
        # light noise so batches differ but remain learnable
        noise_pos = rng.integers(0, self.seq_len, size=(self.global_batch, 4))
        for b in range(self.global_batch):
            seqs[b, noise_pos[b]] = rng.integers(0, self.vocab, size=4)
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def __next__(self):
        b = self._batch_at(self.state.step)
        self.state.step += 1
        return b

    def __iter__(self):
        return self

    def host_slice(self, batch: dict, host_index: int, host_count: int) -> dict:
        rows = self.global_batch // host_count
        lo = host_index * rows
        return {k: v[lo:lo + rows] for k, v in batch.items()}
