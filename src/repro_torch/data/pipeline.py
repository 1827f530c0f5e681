"""Deterministic, shardable synthetic LM data pipeline (the JAX package's
``data/pipeline.py``, copied so that the port imports nothing of it: the
same Philox streams, so ``batch_at(step)`` gives the same arrays, ``==``).

Every batch is a pure function of (seed, step, shard) via counter-based RNG
(Philox), which gives the properties a 1000+-node training fleet needs:

* **restart tolerance** — a restored worker regenerates exactly the batch
  stream it would have seen (skip-ahead is O(1), no state to checkpoint
  beyond the step counter, which Aquifer snapshots anyway);
* **elastic resharding** — shards are pure index math, so changing the
  data-parallel degree re-partitions the same global stream;
* **straggler decoupling** — no ordered queue between hosts.

Token stream: a mixture of Zipfian unigrams and short Markov motifs, enough
structure for the loss to fall measurably during the e2e example runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Synthetic LM data-stream parameters (vocab, geometry, seed)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class SyntheticLMData:
    """Deterministic sharded token-batch generator for training runs."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.cfg.seed, counter=[step, self.shard, 0, 0])
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The shard-local batch for `step` (O(1) skip-ahead)."""
        cfg = self.cfg
        rng = self._rng(step)
        b, s = self.local_batch, cfg.seq_len
        # Zipf unigrams clipped to vocab
        toks = rng.zipf(cfg.zipf_a, size=(b, s + 1)).astype(np.int64)
        toks = np.minimum(toks - 1, cfg.vocab - 1)
        # overlay motifs: each sequence repeats a short pattern at random slots
        motif_len = 8
        motif = rng.integers(0, cfg.vocab, size=(b, motif_len))
        starts = rng.integers(0, max(1, s - motif_len), size=(b, 4))
        for i in range(b):
            for st in starts[i]:
                toks[i, st : st + motif_len] = motif[i]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
