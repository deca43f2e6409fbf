"""Deterministic synthetic token stream (numpy port of
`repro.data.pipeline`'s Markov stream): training batches with their
labels, prompts and calibration batches.

Every batch is a pure function of (seed, step, shard), so a restarted
training run replays the exact stream with no loader state to
checkpoint. The draws come from numpy's generator, so they differ from
the JAX package's; parity tests hand both packages the same numpy tokens
instead.
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
    """`global_batch(step)` builds the whole batch; `local_batch(step)`
    only this host's shard (global_batch // n_hosts rows, its own draws).
    A batch holds "tokens" and "labels", the tokens shifted left by one
    with a final -1 (ignored by the loss)."""
    cfg: DataConfig
    host_id: int = 0
    n_hosts: int = 1

    def _batch(self, step: int, batch: int,
               offset: int) -> Dict[str, np.ndarray]:
        toks = markov_tokens(self.cfg, batch, step, offset)
        labels = np.concatenate(
            [toks[:, 1:], np.full((batch, 1), -1, toks.dtype)], 1)
        return {"tokens": toks, "labels": labels}

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        return self._batch(step, self.cfg.global_batch, 0)

    def local_batch(self, step: int) -> Dict[str, np.ndarray]:
        per = self.cfg.global_batch // self.n_hosts
        return self._batch(step, per, self.host_id * 1009)

    def calib_batches(self, n: int,
                      batch: Optional[int] = None) -> List[Dict]:
        """Calibration set: `n` batches of min(global_batch, 8) rows."""
        b = batch or min(self.cfg.global_batch, 8)
        return [self._batch(10_000_000 + i, b, 0) for i in range(n)]
