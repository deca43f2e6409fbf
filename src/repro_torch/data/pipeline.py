"""Deterministic synthetic token stream (numpy port of
`repro.data.pipeline`'s Markov stream): prompts and calibration batches.

Every batch is a pure function of (seed, step). The draws come from
numpy's generator, so they differ from the JAX package's; parity tests
hand both packages the same numpy tokens instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_states: int = 64          # markov states of the synthetic stream


def markov_tokens(cfg: DataConfig, batch: int, step: int,
                  offset: int = 0) -> np.ndarray:
    """[batch, seq_len] int32 tokens: each state maps to 8 candidate next
    tokens (a fixed per-seed table), so the stream is low-entropy."""
    table = np.random.default_rng(cfg.seed).integers(
        0, cfg.vocab_size, (cfg.n_states, 8))
    rng = np.random.default_rng([cfg.seed, step, offset])
    state = rng.integers(0, cfg.n_states, batch)
    choice = rng.integers(0, 8, (cfg.seq_len, batch))
    out = np.empty((batch, cfg.seq_len), np.int32)
    for t in range(cfg.seq_len):
        tok = table[state % cfg.n_states, choice[t]]
        out[:, t] = tok
        state = tok % cfg.n_states
    return out


@dataclasses.dataclass
class Batcher:
    cfg: DataConfig

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        return {"tokens": markov_tokens(self.cfg, self.cfg.global_batch,
                                        step)}

    def calib_batches(self, n: int,
                      batch: Optional[int] = None) -> List[Dict]:
        """Calibration set: `n` batches of min(global_batch, 8) rows."""
        b = batch or min(self.cfg.global_batch, 8)
        return [{"tokens": markov_tokens(self.cfg, b, 10_000_000 + i)}
                for i in range(n)]
