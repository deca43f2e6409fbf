"""Chunked ragged prefill (port of `repro.launch.prefill.PrefillScheduler`).

Pending prompts are packed into fixed-size chunks of a token stream with
per-token (seq_id, pos) metadata; each chunk runs through
`Model.prefill_chunk`, whose K/V quantize straight into the slots' pages.

Stream layout (C = chunk_size tokens, bq = query-tile alignment):

      tokens   [ p0 p1 p2 p3 | p4 p5 .. .. | q0 q1 q2 q3 | .. .. .. .. ]
      seq_id   [  2  2  2  2 |  2  2 -1 -1 |  0  0  0  0 | -1 -1 -1 -1 ]
      pos      [  8  9 10 11 | 12 13  0  0 |  0  1  2  3 |  0  0  0  0 ]
      tile_seq [      2      |      2      |      0      |     -1      ]

Prompts split at fixed segment boundaries (`seg` tokens) and the packer
places whole segments only, with `hist = segment start`: a prompt's cache
bytes and greedy tokens then depend on (prompt, seg) alone, not on how the
chunks were packed — which is why the port's scheduler may pack in its own
order and still match the JAX engine token for token. Page allocation
stays with the engine (`plan` calls back into its `grant`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.paging import ChunkMeta


@dataclasses.dataclass
class _Job:
    """One pending prompt: admitted to a slot, not yet fully prefilled."""
    slot: int
    rid: int
    tokens: np.ndarray
    done: int = 0                       # prompt tokens already written

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.done


class ChunkPlan(NamedTuple):
    """Host-side description of one packed chunk (module docstring)."""
    tokens: np.ndarray      # [C] stream token ids (0 = padding)
    seq_id: np.ndarray      # [C] slot per token (-1 = padding)
    pos: np.ndarray         # [C] absolute position per token
    hist: np.ndarray        # [C] per-token history boundary
    tile_seq: np.ndarray    # [C/bq] slot per query tile (-1 = padding)
    last_rows: np.ndarray   # [S] stream row of the slot's final prompt
                            #     token (-1: prefill incomplete)
    completed: List[Tuple[int, int]]    # (slot, rid)
    advanced: Dict[int, int]            # slot -> prompt tokens written


class PrefillScheduler:
    """Packs ragged pending prompts into fixed-shape chunks (FIFO) and
    runs each through the model's chunk program."""

    def __init__(self, model, ctx=None, scales_groups=None, *,
                 chunk_size: int = 32, align: int = 8, page_size: int,
                 n_slots: int, seg: Optional[int] = None):
        if chunk_size % align:
            raise ValueError(f"chunk_size {chunk_size} must be a multiple "
                             f"of the query-tile alignment {align}")
        seg = chunk_size if seg is None else seg
        if not 0 < seg <= chunk_size:
            raise ValueError(f"segment quantum {seg} must be in "
                             f"(0, chunk_size={chunk_size}]")
        self.model = model
        self.ctx = ctx
        self.scales_groups = scales_groups
        self.C = chunk_size
        self.bq = align
        self.seg = seg
        self.ps = page_size
        self.S = n_slots
        self.jobs: List[_Job] = []          # FIFO

    def reset(self) -> None:
        self.jobs = []

    def add(self, slot: int, rid: int, tokens: np.ndarray) -> None:
        assert not self.has(slot), f"slot {slot} already mid-prefill"
        self.jobs.append(_Job(slot=slot, rid=rid, tokens=np.asarray(tokens)))

    def has(self, slot: int) -> bool:
        return any(j.slot == slot for j in self.jobs)

    def job(self, slot: int) -> _Job:
        return next(j for j in self.jobs if j.slot == slot)

    @property
    def pending(self) -> bool:
        return bool(self.jobs)

    def pages_outstanding(self, slot: int, host_bt: np.ndarray) -> int:
        """Pages this mid-prefill slot still needs to finish its prompt."""
        job = self.job(slot)
        last_blk = (len(job.tokens) - 1) // self.ps
        row = host_bt[slot]
        return sum(1 for b in range(last_blk + 1) if row[b] < 0)

    def _seg_floor(self, job: _Job, n: int) -> int:
        """Largest segment-atomic token count <= n from the job's position
        (whole segments, or everything that remains)."""
        if n >= job.remaining:
            return job.remaining
        return (n // self.seg) * self.seg

    def plan(self, budget: Callable[[], int],
             grant: Callable[[int, List[int]], None],
             host_bt: np.ndarray) -> Optional[ChunkPlan]:
        """Pack the next chunk, FIFO over pending jobs. `budget()` is the
        pages prefill may take now; `grant(slot, blocks)` allocates pages
        for those logical blocks. A run shrinks segment-atomically to the
        budget before granting, so every granted page is written by this
        very chunk. Returns None when nothing could be packed."""
        C, bq, ps = self.C, self.bq, self.ps
        used = 0
        runs: List[Tuple[_Job, int, int]] = []       # (job, n, at)
        for job in list(self.jobs):
            if used >= C:
                break
            n = self._seg_floor(job, C - used)
            first_blk = job.done // ps

            def missing(n_tok):
                last_blk = (job.done + n_tok - 1) // ps
                return [b for b in range(first_blk, last_blk + 1)
                        if host_bt[job.slot, b] < 0]

            while n > 0:
                need = missing(n)
                if len(need) <= budget():
                    break
                n = self._seg_floor(job, need[budget()] * ps - job.done)
            if n <= 0:
                continue                             # stalled: no page
            grant(job.slot, missing(n))
            runs.append((job, n, used))
            used += -(-n // bq) * bq                 # align run to bq
        if not runs:
            return None

        tokens = np.zeros(C, np.int64)
        seq_id = np.full(C, -1, np.int64)
        pos = np.zeros(C, np.int64)
        hist = np.zeros(C, np.int64)
        tile_seq = np.full(C // bq, -1, np.int64)
        last_rows = np.full(self.S, -1, np.int64)
        completed: List[Tuple[int, int]] = []
        advanced: Dict[int, int] = {}
        for job, n, at in runs:
            tokens[at:at + n] = job.tokens[job.done:job.done + n]
            seq_id[at:at + n] = job.slot
            p = np.arange(job.done, job.done + n)
            pos[at:at + n] = p
            hist[at:at + n] = (p // self.seg) * self.seg
            tile_seq[at // bq: (at + n + bq - 1) // bq] = job.slot
            advanced[job.slot] = n
            job.done += n
            if job.remaining == 0:
                last_rows[job.slot] = at + n - 1
                completed.append((job.slot, job.rid))
                self.jobs.remove(job)
        return ChunkPlan(tokens=tokens, seq_id=seq_id, pos=pos, hist=hist,
                         tile_seq=tile_seq, last_rows=last_rows,
                         completed=completed, advanced=advanced)

    def run(self, params, caches, plan: ChunkPlan,
            seq_pos_after: np.ndarray) -> torch.Tensor:
        """Execute one planned chunk on the model's device (the caches are
        written in place). Returns tok0 [S] int32 on the device."""
        dev = self.model.device
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        meta = ChunkMeta(seq_id=i32(plan.seq_id), pos=i32(plan.pos),
                         hist=i32(plan.hist), tile_seq=i32(plan.tile_seq),
                         seq_pos_after=i32(seq_pos_after))
        return self.model.prefill_chunk(
            params, i32(plan.tokens)[None], caches, meta,
            i32(plan.last_rows), ctx=self.ctx,
            scales_groups=self.scales_groups)
