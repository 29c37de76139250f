"""Deterministic synthetic LM data pipeline (a copy of the JAX package's
``data/lm.py``: numpy only, the same token streams from the same seed).

Affine-recurrent token streams with segment structure: learnable by a
small LM (loss drops fast), fully seeded, and the iterator state is a
single step counter — checkpoint/restart resumes the stream exactly
(tested in tests/test_checkpoint.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class LMStreamState:
    step: int = 0


class LMDataPipeline:
    """Yields {tokens (B, S) int32, labels (B, S) int32} batches.

    labels[t] = tokens[t+1] (next-token prediction). Deterministic in
    (seed, step): batch i is a pure function of its index, so resuming
    from a checkpointed step reproduces the exact stream."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, microbatches: int = 1):
        self.vocab = max(vocab, 8)
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.microbatches = microbatches
        self.state = LMStreamState()

    def _sequence(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed * 1_000_003 + idx) % 2**63)
        a = int(rng.integers(1, 17)) * 2 + 1   # odd multiplier
        b = int(rng.integers(0, self.vocab))
        x = int(rng.integers(0, self.vocab))
        out = np.empty(self.seq + 1, np.int32)
        for t in range(self.seq + 1):
            out[t] = x
            x = (a * x + b) % self.vocab
            if rng.random() < 0.02:  # segment reset (keeps entropy up)
                x = int(rng.integers(0, self.vocab))
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        i0 = self.state.step * self.batch
        seqs = np.stack([self._sequence(i0 + i) for i in range(self.batch)])
        self.state.step += 1
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        if self.microbatches > 1:
            mb = self.microbatches
            batch = {k: v.reshape(mb, self.batch // mb, self.seq)
                     for k, v in batch.items()}
        return batch

    # -- checkpointable iterator state --
    def state_dict(self) -> Dict:
        return {"step": self.state.step}

    def load_state_dict(self, d: Dict) -> None:
        self.state.step = int(d["step"])
