"""Serving engines (port of `repro.launch.serve`): the scan engine over a
contiguous cache, and paged continuous batching.

  DecodeEngine (`--engine scan`, the default)
      Uniform batch, one contiguous (k, v, pos) cache per layer, fp or
      §5.1 packed. A prefill, then a Python loop of decode steps (the
      JAX package's `lax.scan`) that never reads a device value: the
      positions and tokens stay on the device, and the generated tokens
      come back in one copy at the end. With the sparq layout every step
      quantizes its K/V through K4 and attends through K5.

  ContinuousBatchingEngine (`--engine paged`)
      Ragged requests share one pool of fixed-size §5.1 packed pages per
      layer (page ids shared across layers, one block table). The host
      loop only schedules — admission, page grants, growth pages at block
      boundaries, eviction — between device steps; every decode step is
      one call over all slots (inactive slots are masked inside the
      kernels), and its greedy tokens come back in one device-to-host
      copy. Admission is `prefill="sequential"` (the default: each prompt
      prefills alone into a batch-1 contiguous cache whose packed pages
      `paging.adopt_prefill` copies into the pool) or `"chunked"`
      (prompts stream through fixed-size chunks, `launch.prefill`,
      interleaved with decode steps). With a `SchedulerPolicy` the pool
      may be oversubscribed: when decode growth finds it dry, a victim is
      preempted (requeued and rebuilt by re-prefill plus a teacher-forced
      replay, or swapped to host memory) and resumed ahead of new
      admissions. With `prefix_cache` (chunked only) prompts that share a
      prefix share its full pages.

Not ported yet: tensor parallelism, the async front-end, the live
mailboxes and telemetry; their flags raise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --reduced --batch 4 --prompt-len 64 --gen 16 --sparq 5opt \\
        --kv-cache sparq --prequantize --device cuda           # scan engine
    ... --engine paged --prefill sequential|chunked             # paged engine
    ... --engine paged --prefill chunked --preempt swap --oversubscribe 0.5 \\
        --prefix-cache                            # oversubscribed, shared
"""
from __future__ import annotations

import argparse
import dataclasses
import heapq
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.sparq import SparqConfig
from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.launch.prefill import PrefillScheduler
from repro_torch.models import cache as cache_mod
from repro_torch.models import paging
from repro_torch.models.cache import CacheConfig
from repro_torch.models.common import QuantCtx
from repro_torch.models.model import Model

SPARQ_PRESETS = {
    "off": None,
    "a8w8": SparqConfig(enabled=False, signed=True),
    "5opt": SparqConfig.opt5(signed=True),
    "3opt": SparqConfig.opt3(signed=True),
    "2opt": SparqConfig.opt2(signed=True),
    "6opt": SparqConfig.opt6(signed=True),
    "7opt": SparqConfig.opt7(signed=True),
}


def make_cache_config(layout: str,
                      sparq: Optional[SparqConfig]) -> CacheConfig:
    """`--kv-cache` flag -> CacheConfig. The sparq layout reuses the active
    SPARQ preset as its codec (plain int8 when the preset is off)."""
    if layout == "fp32":
        return CacheConfig.fp32()
    if layout == "bf16":
        return CacheConfig.bf16()
    if layout == "sparq":
        if sparq is None:
            return CacheConfig(layout="sparq")
        return CacheConfig.sparq_cache(sparq)
    raise ValueError(layout)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeEngine:
    """Greedy batched generation over a contiguous cache on the model's
    device: a prefill, then `gen - 1` decode steps. With the sparq layout
    each step quantizes on write (K4) and attends through the fused
    packed-cache decode kernel (K5); no plane is dequantized whole."""

    def __init__(self, model: Model, cache_cfg: Optional[CacheConfig] = None,
                 ctx: Optional[QuantCtx] = None, scales_groups=None):
        self.model = model
        self.device = model.device
        self.cache_cfg = cache_cfg or CacheConfig.fp32()
        self.ctx = ctx
        self.scales_groups = scales_groups

    def init_cache(self, batch: int, max_len: int) -> list:
        return self.model.init_cache(batch, max_len,
                                     cache_cfg=self.cache_cfg)

    def _prefill(self, params, tokens, caches) -> torch.Tensor:
        logits = self.model.prefill(params, {"tokens": tokens}, caches,
                                    ctx=self.ctx,
                                    scales_groups=self.scales_groups)
        return torch.argmax(logits, -1)[:, None].to(torch.int32)

    def _decode(self, params, tok, caches, pos0: int,
                steps: int) -> torch.Tensor:
        """`steps` greedy steps from tok [B, 1] at position pos0. The loop
        reads nothing back: pos is a device scalar, each step's argmax
        feeds the next. Returns the tokens [B, steps] on the device."""
        pos = torch.tensor(pos0, dtype=torch.int32, device=self.device)
        out = []
        for _ in range(steps):
            logits = self.model.decode_step(
                params, tok, caches, pos, ctx=self.ctx,
                scales_groups=self.scales_groups)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok)
            pos = pos + 1
        return torch.cat(out, 1)

    def generate(self, params, batch, gen: int, pad: int = 8,
                 max_len: Optional[int] = None, warmup: bool = True):
        """Returns (tokens int32 [B, gen] numpy, stats).

        `max_len` caps the cache capacity (default: prompt + gen + pad
        slots). The capacity check runs on the host before any work: the
        cache write clamps its start, so an overflowing decode would
        overwrite the newest slots instead of failing.

        `warmup` runs prefill + decode once untimed first (on a cache of
        its own; the kernels build at first use), reported as compile_s,
        so prefill_s and decode_tok_s measure steady-state execution."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 device=self.device)
        B, pos0 = tokens.shape
        max_len = max_len if max_len is not None else pos0 + gen + pad
        if pos0 + gen > max_len:
            raise ValueError(
                f"KV-cache overflow: prompt ({pos0} slots) + generation "
                f"({gen}) needs {pos0 + gen} cache slots but capacity is "
                f"{max_len}; the cache write would clamp and overwrite the "
                f"newest entries")
        with torch.no_grad():
            compile_s = 0.0
            if warmup:
                t0 = time.perf_counter()
                caches = self.init_cache(B, max_len)
                tok_w = self._prefill(params, tokens, caches)
                if gen > 1:
                    self._decode(params, tok_w, caches, pos0, gen - 1)
                _sync(self.device)
                compile_s = time.perf_counter() - t0
            caches = self.init_cache(B, max_len)
            _sync(self.device)
            t0 = time.perf_counter()
            tok0 = self._prefill(params, tokens, caches)
            _sync(self.device)
            t_prefill = time.perf_counter() - t0
            t0 = time.perf_counter()
            toks = tok0
            if gen > 1:
                toks = torch.cat([tok0, self._decode(params, tok0, caches,
                                                     pos0, gen - 1)], 1)
            _sync(self.device)
            t_decode = time.perf_counter() - t0
        self.last_caches = caches      # the timed pass's caches (read-back)
        tally = cache_mod.modeled_cache_bytes(caches)
        stats = {
            "device": str(self.device),
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "compile_s": compile_s,
            "decode_tok_s": (B * (gen - 1) / max(t_decode, 1e-9))
                            if gen > 1 else 0.0,
            "cache_bytes_per_value":
                cache_mod.bytes_per_value(self.cache_cfg),
            "cache_ctrl_bytes_per_value":
                cache_mod.ctrl_bytes_per_value(self.cache_cfg),
            "cache_data_bytes": tally["data_bytes"],
            "cache_total_bytes": tally["total_bytes"],
        }
        return toks.cpu().numpy(), stats


def serve(model: Model, params, batch, gen: int,
          ctx: Optional[QuantCtx], scales_groups=None,
          cache_cfg: Optional[CacheConfig] = None, warmup: bool = True):
    """Greedy batched generation. Returns (tokens [B, gen], stats)."""
    engine = DecodeEngine(model, cache_cfg, ctx, scales_groups)
    return engine.generate(params, batch, gen, warmup=warmup)


@dataclasses.dataclass
class Request:
    """A prompt and a total token budget (`gen` includes the token the
    prefill emits). `arrive_at` delays admission until the engine's step
    clock (decode steps, plus idle fast-forwards) reaches it; it changes
    when a request is served, never its tokens."""
    tokens: np.ndarray
    gen: int
    arrive_at: float = 0.0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens)
        assert self.tokens.ndim == 1 and self.tokens.size >= 1
        assert self.gen >= 1
        assert self.arrive_at >= 0


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """What to do when decode-time page allocation finds the pool dry.

    preempt  "requeue": drop the victim's pages; on resume, re-prefill its
             prompt and replay its emitted tokens teacher-forced through
             the decode path (recompute, no host traffic). Exact: both
             passes are the programs that wrote the original bytes.
             "swap": copy the victim's packed pages verbatim to a host
             `SwapStore` and scatter them back on resume (host traffic,
             no recompute).
             "auto": per victim, the cheaper of the two by
             `estimate_cost`.
    victim   "last_joined": the most recently admitted sequence first.
             "fewest_pages": the sequence owning the fewest pages; ties
             broken last-joined first.

    Resumes take strict priority over new admissions. The cost model's
    knobs are modeled microseconds (the reference's), not measurements: a
    requeue pays prefill per prompt token and one sequential decode step
    per emitted token, a swap pays its bytes twice over the host link."""
    preempt: str = "requeue"        # requeue | swap | auto
    victim: str = "last_joined"     # last_joined | fewest_pages
    prefill_tok_us: float = 2.0     # re-prefill, parallel over the prompt
    replay_tok_us: float = 60.0     # teacher-forced decode replay, per step
    swap_gb_s: float = 8.0          # host <-> device link bandwidth

    def __post_init__(self):
        if self.preempt not in ("requeue", "swap", "auto"):
            raise ValueError(f"unknown preempt mode {self.preempt!r}")
        if self.victim not in ("last_joined", "fewest_pages"):
            raise ValueError(f"unknown victim rule {self.victim!r}")

    def estimate_cost(self, prompt_len: int, generated: int,
                      swap_bytes: int) -> Tuple[float, float]:
        """Modeled (requeue_us, swap_us) to evict and resume one victim
        with `prompt_len` prompt tokens, `generated` tokens emitted and
        `swap_bytes` packed bytes in its pages (out and back in)."""
        requeue = self.prefill_tok_us * prompt_len \
            + self.replay_tok_us * max(generated - 1, 0)
        swap = 2.0 * swap_bytes / (self.swap_gb_s * 1e3)   # bytes -> us
        return requeue, swap

    def resolve(self, prompt_len: int, generated: int,
                swap_bytes: int) -> str:
        """The concrete mode for one victim ("requeue" or "swap")."""
        if self.preempt != "auto":
            return self.preempt
        requeue, swap = self.estimate_cost(prompt_len, generated,
                                           swap_bytes)
        return "requeue" if requeue <= swap else "swap"


@dataclasses.dataclass
class _Slot:
    """Host-side state of one active sequence slot."""
    rid: int
    target: int                 # total tokens to emit (== Request.gen)
    generated: int              # tokens emitted so far (tok0 counts)
    pages: List[int]            # physical pages the sequence references
    joined: int = 0             # admission sequence number (victim order)
    replay: List[int] = dataclasses.field(default_factory=list)
    # ^ chunked requeue resume: emitted tokens still to feed teacher-forced
    #   through the ordinary decode steps once the re-prefill completes


@dataclasses.dataclass
class _Preempted:
    """A preempted request waiting on the resume queue."""
    rid: int
    req: Request
    toks: List[int]             # greedy tokens emitted before preemption
    swapped: bool               # its packed pages are in the SwapStore


class ContinuousBatchingEngine:
    """Greedy generation over ragged requests with a paged SPARQ cache.
    `max_active` slots share `n_pages` pages of `page_size` slots.
    `prefill` picks the admission: "sequential" (each prompt prefills
    alone into a batch-1 contiguous cache, adopted page by page) or
    "chunked" (prompts stream through fixed-size chunks written straight
    into pages). With `policy=None` decode-time pool exhaustion raises
    `PoolExhausted`; with a `SchedulerPolicy` it preempts a victim, which
    resumes bit-exactly before any new admission. `prefix_cache` (chunked
    only) shares the full pages of cached prompt prefixes;
    `prefill_priority` meters chunks per decode step. Runs on the model's
    device; `device` (default `cuda`) must name it, so a CPU run is
    always asked for explicitly."""

    def __init__(self, model: Model, cache_cfg: CacheConfig,
                 ctx: Optional[QuantCtx] = None, scales_groups=None, *,
                 page_size: int = 16, n_pages: int = 64,
                 max_active: int = 4, max_seq_len: int = 512,
                 policy: Optional[SchedulerPolicy] = None,
                 prefill: str = "sequential", chunk_size: int = 32,
                 chunk_align: int = 8, chunk_seg: Optional[int] = None,
                 prefix_cache: bool = False, prefix_min_pages: int = 1,
                 prefill_priority: float = 1.0, device=None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} != model device "
                             f"{model.device}")
        if cache_cfg.layout != "sparq":
            raise ValueError("the paged engine stores packed §5.1 pages; "
                             "use --kv-cache sparq")
        if any(k != "dense" for k in model.kinds):
            raise ValueError("paged serving is ported for dense stacks only")
        if max_seq_len % page_size:
            raise ValueError(f"max_seq_len {max_seq_len} must be a multiple "
                             f"of page_size {page_size}")
        if prefill not in ("sequential", "chunked"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        if prefill_priority <= 0:
            raise ValueError("--prefill-priority must be > 0: it is the "
                             "mean prefill chunks run per scheduler "
                             "iteration (1.0 = one chunk per decode step)")
        if prefill_priority != 1.0 and prefill != "chunked":
            raise ValueError("--prefill-priority only meters the chunked "
                             "prefill stream; add --prefill chunked")
        if prefix_cache and prefill != "chunked":
            raise ValueError(
                "--prefix-cache requires --prefill chunked: only the "
                "chunked path's segment-granular scale freezing makes "
                "packed prefill bytes a pure function of (prompt, seg)")
        self.model = model
        self.cc = cache_cfg
        self.ctx = ctx
        self.scales_groups = scales_groups
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_active = max_active
        self.n_blocks = max_seq_len // page_size
        self.policy = policy
        self.prefill_mode = prefill
        cfg = model.cfg
        # host bytes one resident page moves on a swap (four int8 planes
        # per layer), the figure the "auto" cost model charges
        self._page_bytes = int(4 * cfg.n_layers * page_size
                               * cfg.n_kv_heads * cfg.head_dim)
        self._sched = None
        if prefill == "chunked":
            self._sched = PrefillScheduler(
                model, ctx, scales_groups, chunk_size=chunk_size,
                align=chunk_align, page_size=page_size, n_slots=max_active,
                seg=chunk_seg)
        self.prefix_cache = prefix_cache
        self.prefix_min_pages = max(1, prefix_min_pages)
        # prefix-match granularity: whole pages and whole prefill segments
        self._quantum = math.lcm(page_size, self._sched.seg) \
            if prefix_cache else 0
        # a sequential requeue replays its tokens through a contiguous
        # cache whose decode tile is the page size (K5 at bk = ps), so
        # the replay reads the bytes as the paged decode (K2) read them
        self._cc_replay = dataclasses.replace(cache_cfg, attn_bk=page_size)
        self.prefill_priority = float(prefill_priority)
        self._debug_state: dict = {}     # last run's allocator/slots (tests)

    # ------------------------------------------------------------ device
    def _init_stores(self) -> Tuple[list, torch.Tensor]:
        """One store per layer; every layer shares one block table."""
        cfg = self.model.cfg
        bt = torch.full((self.max_active, self.n_blocks), -1,
                        dtype=torch.int32, device=self.device)
        stores = [paging.PagedCacheStore.init(
            self.max_active, self.n_pages, self.page_size, self.n_blocks,
            cfg.n_kv_heads, cfg.head_dim, self.cc, self.device,
            block_table=bt) for _ in range(cfg.n_layers)]
        return stores, bt

    def _prefill_alone(self, params, tokens: np.ndarray, caches: list,
                       slot: int, pages: List[int],
                       replay: Sequence[int] = ()) -> torch.Tensor:
        """Sequential admission of one prompt: prefill it into a batch-1
        contiguous sparq cache of len(pages) pages, then adopt every
        layer's packed bytes, scales and position into the pool at `slot`.
        A requeue resume passes its emitted tokens but the last as
        `replay`: they are fed teacher-forced through the contiguous
        decode path (K5 at bk = page size) before adoption. Returns the
        first greedy token, int32 [1] on the device."""
        ps = self.page_size
        cc = self._cc_replay if replay else self.cc
        tmp = self.model.init_cache(1, len(pages) * ps, cache_cfg=cc)
        logits = self.model.prefill(
            params, {"tokens": tokens[None]}, tmp, ctx=self.ctx,
            scales_groups=self.scales_groups)
        if replay:
            toks = torch.as_tensor(np.asarray(replay, np.int32),
                                   device=self.device)
            pos = torch.tensor(len(tokens), dtype=torch.int32,
                               device=self.device)
            for i in range(len(replay)):
                self.model.decode_step(params, toks[i:i + 1, None], tmp,
                                       pos, ctx=self.ctx,
                                       scales_groups=self.scales_groups)
                pos = pos + 1
        pages_dev = torch.tensor(pages, dtype=torch.int64,
                                 device=self.device)
        for store, cs in zip(caches, tmp):
            paging.adopt_prefill(store, cs, slot, pages_dev)
        return torch.argmax(logits, -1).to(torch.int32)

    def _step(self, params, tok, caches, pos):
        logits = self.model.decode_step(params, tok, caches, pos,
                                        ctx=self.ctx,
                                        scales_groups=self.scales_groups)
        return torch.argmax(logits, -1)[:, None].to(torch.int32)

    @staticmethod
    def _snapshot(n_steps, allocator, slots, host_bt, host_pos, caches,
                  queue, resume_q, swap, prefilling=(), replaying=(),
                  prefix=None) -> dict:
        """Scheduler state handed to `run(trace_hook=...)` before each
        decode step: the JAX engine's snapshot. Host fields are copies;
        `caches` is the live device state."""
        return {
            "step": n_steps,
            "n_pages": allocator.n_pages,
            "free_pages": allocator.free_pages,
            "peak_pages": allocator.peak_used,
            "slots": {s: {"rid": st.rid, "pages": list(st.pages),
                          "pos": int(host_pos[s]),
                          "generated": st.generated, "target": st.target,
                          "joined": st.joined}
                      for s, st in enumerate(slots) if st is not None},
            "host_bt": host_bt.copy(),
            "queued": [rid for _, rid, _ in sorted(queue,
                                                   key=lambda e: e[:2])],
            "resume_rids": [rec.rid for rec in resume_q],
            "swapped_rids": sorted(rec.rid for rec in resume_q
                                   if rec.swapped),
            "swap_resident_bytes": swap.resident_bytes,
            "prefilling": tuple(prefilling),
            "replaying": tuple(replaying),
            "page_refcounts": allocator.refcounts,
            "prefix": dict(prefix) if prefix is not None else None,
            "caches": caches,
        }

    def _validate_request(self, req: Request, label: str) -> None:
        need = len(req.tokens) + req.gen - 1
        ps = self.page_size
        if need > self.n_blocks * ps or math.ceil(need / ps) > self.n_pages:
            raise ValueError(
                f"{label} needs {need} slots ({math.ceil(need / ps)} pages) "
                f"but the engine serves at most {self.n_blocks * ps} "
                f"slots/sequence from {self.n_pages} pages")

    # ------------------------------------------------------------ public
    def run(self, params, requests: Sequence[Request], trace_hook=None
            ) -> Tuple[Dict[int, np.ndarray], dict]:
        """Serve every request to completion. Returns ({request index:
        int32 [gen] greedy tokens}, stats). Each run starts from a fresh
        pool, fresh (uncalibrated) cache scales and a fresh prefix index.
        `trace_hook`, if given, gets a scheduler-state snapshot before
        every decode step."""
        with torch.no_grad():
            return self._run(params, requests, trace_hook)

    def _run(self, params, requests, trace_hook):
        requests = {i: (r if hasattr(r, "tokens") else Request(*r))
                    for i, r in enumerate(requests)}
        ps, NB, S = self.page_size, self.n_blocks, self.max_active
        dev = self.device
        sched = self._sched
        if sched is not None:
            sched.reset()
        for i, r in requests.items():
            self._validate_request(r, f"request {i}")

        allocator = paging.PageAllocator(self.n_pages)
        index = paging.PrefixIndex(self._quantum, ps) \
            if self.prefix_cache else None
        caches, bt_dev = self._init_stores()
        tok = torch.zeros((S, 1), dtype=torch.int32, device=dev)
        slots: List[Optional[_Slot]] = [None] * S
        host_bt = np.full((S, NB), -1, np.int64)
        host_pos = np.full((S,), -1, np.int64)
        queue = [(float(r.arrive_at), rid, r) for rid, r in requests.items()]
        heapq.heapify(queue)
        resume_q: List[_Preempted] = []
        swap = paging.SwapStore()
        first_tok: Dict[int, torch.Tensor] = {}   # rid -> device scalar
        outputs: Dict[int, List[int]] = {rid: [] for rid in requests}
        # replay-divergence checks, read after the loop in one fetch
        deferred_checks: List[torch.Tensor] = []
        deferred_expect: List[Tuple[int, str]] = []
        n = dict(steps=0, tokens=0, chunks=0, requeue=0, swap=0, resumes=0,
                 replay=0, refusals=0, hits=0, misses=0, hit_tokens=0,
                 shared_pages=0, cow=0, peak=0)
        join_seq = 0
        clock = 0.0
        prefill_s = resume_s = 0.0
        chunk_credit = 0.0          # fractional prefill chunks banked
        self._debug_state = {"allocator": allocator, "slots": slots,
                             "swap": swap, "prefix_index": index}

        def note_peak():
            n["peak"] = max(n["peak"], allocator.used_count)

        def prefilling(s: int) -> bool:
            return sched is not None and sched.has(s)

        def push_block_table():
            bt_dev.copy_(torch.as_tensor(host_bt, dtype=torch.int32))

        # ------------------------------------------ preemption machinery
        def emitted_toks(rid: int) -> List[int]:
            """Every greedy token rid has emitted, in order: the first
            token's one device fetch, then the host copies of the decode
            steps' tokens."""
            return [int(first_tok[rid].item())] + outputs[rid]

        def drop_pages(pages: List[int]):
            """Release one reference per page; index entries naming a
            page that reached zero are invalidated."""
            freed = allocator.release(pages)
            if index is not None and freed:
                index.invalidate(freed)

        def evict(s: int):
            drop_pages(slots[s].pages)
            paging.evict_slot(caches, s)
            host_bt[s] = -1
            host_pos[s] = -1
            slots[s] = None

        def finished_slot() -> Optional[int]:
            return next((s for s, st in enumerate(slots)
                         if st is not None and st.generated >= st.target),
                        None)

        def select_victim(exclude=()):
            cands = [(s, st) for s, st in enumerate(slots)
                     if st is not None and s not in exclude]
            if not cands or self.policy is None:
                return None
            if self.policy.victim == "fewest_pages":
                key = lambda c: (len(c[1].pages), -c[1].joined)
            else:                                   # last_joined
                key = lambda c: (-c[1].joined,)
            return min(cands, key=key)[0]

        def preempt(s: int):
            st = slots[s]
            mid_prefill = prefilling(s)
            toks = emitted_toks(st.rid) if st.rid in first_tok else []
            assert mid_prefill or len(toks) == st.generated, \
                (st.rid, len(toks))
            # a slot mid-prefill or mid-replay holds a partial cache only:
            # it always requeues
            if mid_prefill or st.replay or not toks:
                mode = "requeue"
            else:
                mode = self.policy.resolve(
                    len(requests[st.rid].tokens), st.generated,
                    len(st.pages) * self._page_bytes)
            if mode == "swap" and any(allocator.refcount(p) > 1
                                      for p in st.pages):
                # pages shared with other sequences stay live in the pool:
                # parking them would fork their bytes, so requeue instead
                mode = "requeue"
                n["refusals"] += 1
            if mid_prefill:
                sched.cancel(s)
            rec = _Preempted(rid=st.rid, req=requests[st.rid], toks=toks,
                             swapped=mode == "swap")
            if rec.swapped:
                pages_dev = torch.tensor(st.pages, dtype=torch.int64,
                                         device=dev)
                swap.put(st.rid, [paging.gather_slot_pages(c, s, pages_dev)
                                  for c in caches], int(host_pos[s]))
            paging.evict_slot(caches, s)
            drop_pages(st.pages)
            host_bt[s] = -1
            host_pos[s] = -1
            slots[s] = None
            resume_q.append(rec)
            n["swap" if rec.swapped else "requeue"] += 1

        def bind_slot(s: int, rid: int, req: Request, pages: List[int],
                      pos: int, generated: int, last_tok):
            nonlocal join_seq
            tok[s, 0] = last_tok
            slots[s] = _Slot(rid=rid, target=req.gen, generated=generated,
                             pages=list(pages), joined=join_seq)
            join_seq += 1
            host_bt[s] = -1
            host_bt[s, :len(pages)] = pages
            host_pos[s] = pos

        def bind_prefilling(s: int, rid: int, req: Request, *,
                            recorded=(), start: int = 0, pages=()):
            """Bind a slot whose prompt streams through the chunk path
            from `start` (pages granted chunk by chunk; positions below
            `start` are backed by `pages`, a shared prefix). `recorded`
            (requeue resume): the emitted tokens; the re-prefill's tok0
            is checked against the first, the rest replay through the
            decode steps."""
            nonlocal join_seq
            recorded, pages = list(recorded), list(pages)
            slots[s] = _Slot(rid=rid, target=req.gen,
                             generated=len(recorded), pages=pages,
                             joined=join_seq, replay=recorded[1:])
            join_seq += 1
            host_bt[s] = -1
            host_bt[s, :len(pages)] = pages
            host_pos[s] = start
            sched.add(s, rid, req.tokens,
                      expect_tok0=recorded[0] if recorded else None,
                      start=start)

        def resume(s: int, rec: _Preempted):
            """Rebuild a preempted sequence in slot s; the caller checked
            that the pool holds `resume_need(rec)` pages."""
            nonlocal resume_s
            t0 = time.perf_counter()
            n["resumes"] += 1
            if rec.swapped:
                pages = allocator.alloc(swap.n_pages(rec.rid))
                planes, pos = swap.pop(rec.rid, dev)
                pages_dev = torch.tensor(pages, dtype=torch.int64,
                                         device=dev)
                for c, pl in zip(caches, planes):
                    paging.restore_slot_pages(c, pl, s, pages_dev, pos)
            elif sched is not None:
                # chunked requeue: the prompt re-streams through the chunk
                # path, then the emitted tokens replay through the decode
                # steps: the programs that wrote the original bytes
                bind_prefilling(s, rec.rid, rec.req, recorded=rec.toks)
                resume_s += time.perf_counter() - t0
                return
            else:
                L, done = len(rec.req.tokens), len(rec.toks)
                pos = L + done - 1
                pages = allocator.alloc(math.ceil(pos / ps))
                tok0 = self._prefill_alone(params, rec.req.tokens, caches,
                                           s, pages, replay=rec.toks[:-1])
                deferred_checks.append(tok0[0])
                deferred_expect.append((
                    rec.toks[0], "requeue replay diverged at prefill — "
                    "greedy decode is no longer deterministic"))
                n["replay"] += done - 1
            bind_slot(s, rec.rid, rec.req, pages, pos,
                      generated=len(rec.toks), last_tok=rec.toks[-1])
            _sync(dev)
            resume_s += time.perf_counter() - t0

        def growth_debt() -> int:
            """Pages the running sequences need before the next step."""
            debt = 0
            for s in range(S):
                st = slots[s]
                if st is None or st.generated >= st.target or prefilling(s):
                    continue
                if host_bt[s, host_pos[s] // ps] < 0:
                    debt += 1
            return debt

        def prefill_debt() -> int:
            """Pages mid-prefill sequences still need, plus the first growth
            page of any whose prompt ends on a block boundary."""
            debt = 0
            for j in (sched.jobs if sched is not None else ()):
                debt += sched.pages_outstanding(j.slot, host_bt)
                if slots[j.slot].target > 1 and len(j.tokens) % ps == 0:
                    debt += 1
            return debt

        def resume_need(rec: _Preempted) -> int:
            """Pages a resume must find free: the restored pages plus the
            growth page when the next write starts a new block."""
            if rec.swapped:
                nbp, pos = swap.n_pages(rec.rid), swap.pos(rec.rid)
            elif not rec.toks:          # mid-prefill victim: whole prompt
                L = len(rec.req.tokens)
                return math.ceil(L / ps) + (
                    1 if rec.req.gen > 1 and L % ps == 0 else 0)
            else:
                pos = len(rec.req.tokens) + len(rec.toks) - 1
                nbp = math.ceil(pos / ps)
            return nbp + (1 if pos // ps >= nbp else 0)

        def match_prefix(tokens):
            """Longest usable cached prefix: None, or (T, shared pages,
            the donor page to copy-on-write when T is mid-page, scales).
            T is a segment boundary below the prompt's end, so at least
            its last segment re-runs to give the first token."""
            L = len(tokens)
            M, pages, scales = index.match(tokens)
            if M <= 0:
                return None
            T = ((L - 1) // sched.seg) * sched.seg if M >= L else M
            K = T // ps
            if K < self.prefix_min_pages:
                return None
            cow_src = pages[K] if T % ps else None
            return T, list(pages[:K]), cow_src, scales

        def register_prefix(s: int, rid: int):
            """Index a freshly prefilled prompt's whole-quantum prefix
            with the slot's frozen scales (copies: the store's change)."""
            toks = requests[rid].tokens
            reg = (len(toks) // self._quantum) * self._quantum
            if reg <= 0:
                return
            pages_reg = [int(p) for p in host_bt[s, :reg // ps]]
            scales_reg = [(c.k_scale[s].clone(), c.v_scale[s].clone())
                          for c in caches]
            index.insert(toks[:reg], pages_reg, scales_reg)

        def check_page_accounting():
            mult: Dict[int, int] = {}
            for st in slots:
                for p in (st.pages if st is not None else ()):
                    mult[p] = mult.get(p, 0) + 1
            assert mult == allocator.refcounts, \
                "page refcounts disagree with block-table references"
            assert allocator.free_count + len(mult) == self.n_pages, \
                "free-list conservation violated (pages leaked)"
            allocator.assert_consistent()
            for s, st in enumerate(slots):
                if st is None:
                    continue
                row = host_bt[s][host_bt[s] >= 0]
                assert list(row) == st.pages, \
                    f"slot {s}: block table disagrees with owned pages"
                assert 0 <= host_pos[s] <= len(st.pages) * ps, \
                    f"slot {s}: position outside its allocated blocks"
                # a write lands mid-page only in an exclusively owned page
                blk = host_pos[s] // ps
                if host_pos[s] % ps and blk < NB and host_bt[s, blk] >= 0:
                    assert allocator.refcount(int(host_bt[s, blk])) == 1, \
                        f"slot {s}: next write targets shared page " \
                        f"{int(host_bt[s, blk])}"

        def arrived():
            return bool(queue) and queue[0][0] <= clock

        def prefix_stats():
            return {"prefix_hits": n["hits"], "prefix_misses": n["misses"],
                    "prefix_hit_tokens": n["hit_tokens"],
                    "prefix_shared_pages": n["shared_pages"],
                    "cow_copies": n["cow"], "swap_refusals": n["refusals"]}

        t_run0 = time.perf_counter()
        while True:
            # ---- evict finished sequences: references dropped
            while (fin := finished_slot()) is not None:
                evict(fin)

            # ---- resume preempted sequences, then admit arrivals. While
            # a preempted sequence waits, nothing younger is admitted.
            # Watermark: the pages asked for, plus the running and
            # prefilling sequences' debt.
            while None in slots and (resume_q or arrived()):
                s = slots.index(None)
                if resume_q:
                    rec = resume_q[0]
                    if allocator.free_count < resume_need(rec) \
                            + growth_debt() + prefill_debt():
                        break                           # wait for pages
                    resume_q.pop(0)
                    resume(s, rec)
                    continue
                _, rid, req = queue[0]
                L = len(req.tokens)
                nbp = math.ceil(L / ps)
                hit = match_prefix(req.tokens) if index is not None \
                    else None
                nbp_fresh = nbp - (len(hit[1]) if hit is not None else 0)
                own = 1 if (req.gen > 1 and L % ps == 0) else 0
                if allocator.free_count < nbp_fresh + own + growth_debt() \
                        + prefill_debt():
                    if not any(slots):
                        allocator.alloc(nbp_fresh + own)  # PoolExhausted
                    break                               # wait for pages
                heapq.heappop(queue)
                if sched is not None:
                    if hit is not None:
                        T, shared, cow_src, sc = hit
                        allocator.share(shared)
                        hit_pages = list(shared)
                        if cow_src is not None:
                            # the tail starts mid-page: it rewrites a
                            # private copy of the donor's boundary page
                            (pg,) = allocator.alloc(1)
                            for c in caches:
                                paging.copy_page(c, cow_src, pg)
                            hit_pages.append(pg)
                            n["cow"] += 1
                        for c, (k_sc, v_sc) in zip(caches, sc):
                            paging.adopt_prefix_scales(c, s, k_sc, v_sc)
                        bind_prefilling(s, rid, req, start=T,
                                        pages=hit_pages)
                        n["hits"] += 1
                        n["hit_tokens"] += T
                        n["shared_pages"] += len(shared)
                        continue
                    if index is not None:
                        n["misses"] += 1
                    bind_prefilling(s, rid, req)
                    continue
                # sequential: the whole prompt now, alone, then adoption
                pages = allocator.alloc(nbp)
                t0 = time.perf_counter()
                tok0 = self._prefill_alone(params, req.tokens, caches, s,
                                           pages)
                first_tok[rid] = tok0[0]
                bind_slot(s, rid, req, pages, pos=L, generated=1,
                          last_tok=tok0[0])
                _sync(dev)
                prefill_s += time.perf_counter() - t0
            note_peak()

            # ---- chunked prefill, metered by prefill_priority: each
            # iteration banks that many chunk credits (capped at
            # max(priority, 1)), each whole credit runs one chunk
            chunk_ran = chunk_gated = False
            if sched is not None and sched.pending:
                def budget() -> int:
                    return max(allocator.free_count - growth_debt(), 0)

                def grant(slot_want: int, blocks: List[int]) -> None:
                    for b in blocks:
                        (pg,) = allocator.alloc(1)
                        slots[slot_want].pages.append(pg)
                        host_bt[slot_want, b] = pg

                chunk_credit = min(chunk_credit + self.prefill_priority,
                                   max(self.prefill_priority, 1.0))
                chunk_gated = chunk_credit < 1.0
                while chunk_credit >= 1.0 and sched.pending:
                    plan = sched.plan(budget, grant, host_bt)
                    if plan is None:
                        break
                    chunk_credit -= 1.0
                    push_block_table()
                    spa = np.full((S,), -1, np.int64)
                    for s2 in range(S):
                        if slots[s2] is not None and not sched.has(s2):
                            spa[s2] = host_pos[s2]
                    for s2, _, _ in plan.completed:
                        spa[s2] = host_pos[s2] + plan.advanced[s2]
                    t0 = time.perf_counter()
                    am = sched.run(params, caches, plan, spa)
                    _sync(dev)
                    prefill_s += time.perf_counter() - t0
                    n["chunks"] += 1
                    chunk_ran = True
                    for s2, adv in plan.advanced.items():
                        host_pos[s2] += adv
                    for s2, rid2, expect in plan.completed:
                        if expect is not None:
                            deferred_checks.append(am[s2])
                            deferred_expect.append((
                                expect, "chunked re-prefill diverged from "
                                "the recorded first token — greedy decode "
                                "is no longer deterministic"))
                        else:
                            first_tok[rid2] = am[s2]
                            slots[s2].generated = 1
                        tok[s2, 0] = am[s2]
                        if index is not None:
                            register_prefix(s2, rid2)
                    note_peak()

            if not any(slots):
                if resume_q or arrived():
                    continue
                if queue:
                    clock = max(clock, queue[0][0])     # idle fast-forward
                    continue
                break                                   # drained

            # ---- allocate the page each next token is written into; a dry
            # pool evicts a finished slot, else preempts a victim
            dirty = False
            for s in range(S):
                st = slots[s]
                if st is None or st.generated >= st.target or prefilling(s):
                    continue
                blk = host_pos[s] // ps
                if host_bt[s, blk] >= 0:
                    continue
                while allocator.free_count < 1:
                    fin = finished_slot()
                    if fin is not None:
                        evict(fin)
                        dirty = True
                        continue
                    victim = select_victim(exclude=(s,))
                    if victim is None:
                        check_page_accounting()
                        raise paging.PoolExhausted(
                            f"page pool exhausted growing slot {s} and no "
                            f"victim left to preempt — grow --n-pages or "
                            f"enable --preempt requeue|swap"
                            if self.policy is None else
                            f"page pool exhausted growing slot {s}: every "
                            f"other sequence is already preempted")
                    preempt(victim)
                    dirty = True
                (pg,) = allocator.alloc(1)
                st.pages.append(pg)
                host_bt[s, blk] = pg
                dirty = True
            note_peak()
            if dirty:
                push_block_table()
            check_page_accounting()

            # ---- one decode step over every slot. Mid-prefill slots ride
            # along inactive; replaying slots (chunked requeue resume)
            # feed their recorded tokens, and the step's token is dropped
            in_prefill = tuple(s for s in range(S) if prefilling(s))
            replaying = tuple(s for s in range(S)
                              if slots[s] is not None and slots[s].replay
                              and s not in in_prefill)
            active = tuple((s, slots[s].rid) for s in range(S)
                           if slots[s] is not None
                           and slots[s].generated < slots[s].target
                           and s not in in_prefill and s not in replaying)
            if not active and not replaying:
                if chunk_gated and sched is not None and sched.pending:
                    chunk_credit = 1.0      # nothing to decode: no meter
                    continue
                if sched is not None and sched.pending and not chunk_ran:
                    # every live slot is a stalled prefill: preempt one
                    first_slot = sched.jobs[0].slot
                    victim = select_victim(exclude=(first_slot,))
                    if victim is None:
                        check_page_accounting()
                        raise paging.PoolExhausted(
                            f"page pool exhausted mid-prefill of slot "
                            f"{first_slot} and no victim left to preempt "
                            f"— grow --n-pages or enable --preempt "
                            f"requeue|swap")
                    preempt(victim)
                continue
            if trace_hook is not None:
                trace_hook(self._snapshot(
                    n["steps"], allocator, slots, host_bt, host_pos, caches,
                    queue, resume_q, swap, prefilling=in_prefill,
                    replaying=replaying,
                    prefix=prefix_stats() if index is not None else None))

            tok = self._step(params, tok, caches, caches[0].seq_pos)
            toks = tok[:, 0].tolist()                   # one D2H copy
            n["steps"] += 1
            clock += 1
            n["tokens"] += len(active)
            for s, rid in active:
                outputs[rid].append(toks[s])
                slots[s].generated += 1
                host_pos[s] += 1
            for s in replaying:
                host_pos[s] += 1
                tok[s, 0] = slots[s].replay.pop(0)
                n["replay"] += 1

        _sync(dev)
        t_total = time.perf_counter() - t_run0
        if deferred_checks:
            got = torch.stack(deferred_checks).tolist()
            for g, (want, msg) in zip(got, deferred_expect):
                assert g == want, msg
        firsts = dict(zip(first_tok, torch.stack(list(first_tok.values()))
                          .tolist())) if first_tok else {}
        results = {rid: np.asarray([firsts[rid]] + outputs[rid], np.int32)
                   for rid in requests}
        for rid, req in requests.items():
            assert len(results[rid]) == req.gen, (rid, len(results[rid]))
        decode_s = max(t_total - prefill_s - resume_s, 1e-9)
        pool = paging.modeled_pool_bytes(caches)
        pstats = prefix_stats()
        stats = {
            "device": str(dev),
            "prefill_mode": self.prefill_mode,
            "prefill_priority": self.prefill_priority,
            "prefill_s": prefill_s,
            "prefill_chunks": n["chunks"],
            "run_s": t_total,
            "resume_s": resume_s,
            "decode_s": decode_s,
            "decode_steps": n["steps"],
            "decode_tokens": n["tokens"],
            "decode_tok_s": n["tokens"] / decode_s,
            "pool_pages": self.n_pages,
            "page_size": ps,
            "peak_pages_used": n["peak"],
            "free_pages_after": allocator.free_count,
            "total_tokens_served": sum(len(r.tokens) + r.gen - 1
                                       for r in requests.values()),
            "preemptions": n["requeue"] + n["swap"],
            "preempt_requeue": n["requeue"],
            "preempt_swap": n["swap"],
            "resumes": n["resumes"],
            "replay_steps": n["replay"],
            "swap_bytes_out": swap.bytes_out,
            "swap_bytes_in": swap.bytes_in,
            "swap_peak_bytes": swap.peak,
            "prefix_cache": self.prefix_cache,
            **pstats,
            "prefix_hit_rate": pstats["prefix_hits"] / max(
                pstats["prefix_hits"] + pstats["prefix_misses"], 1),
            "cache_bytes_per_value": cache_mod.bytes_per_value(self.cc),
            "cache_total_bytes": pool["total_bytes"],
        }
        return results, stats


_NOT_PORTED = {
    "tp": 1, "serve": "sync", "metrics_dump": None, "trace_out": None,
    "metrics_port": None,
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="SPARQ serving, scan or paged engine (PyTorch/CUDA)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sparq", choices=list(SPARQ_PRESETS), default="5opt")
    ap.add_argument("--kv-cache", choices=("fp32", "bf16", "sparq"),
                    default="sparq")
    ap.add_argument("--engine", choices=("scan", "paged"), default="scan",
                    help="scan: uniform batch over a contiguous cache; "
                         "paged: continuous batching over the page pool")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=64)
    ap.add_argument("--max-active", type=int, default=0,
                    help="concurrent sequence slots (default: --batch)")
    ap.add_argument("--prefill", choices=("sequential", "chunked"),
                    default="sequential",
                    help="paged engine admission: sequential (each prompt "
                         "alone, then adopted into pages) or chunked")
    ap.add_argument("--chunk-size", type=int, default=32)
    ap.add_argument("--chunk-align", type=int, default=8)
    ap.add_argument("--chunk-seg", type=int, default=0,
                    help="segment quantum (0 = chunk size)")
    ap.add_argument("--calibrate", type=int, default=2,
                    help="calibration batches (0 = dynamic scales)")
    ap.add_argument("--prequantize", action="store_true",
                    help="deploy int8 weight codes (offline quantization)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--preempt", choices=("off", "requeue", "swap", "auto"),
                    default="off",
                    help="paged engine: on decode-time pool exhaustion, "
                         "preempt a victim: requeue (drop pages, replay on "
                         "resume), swap (packed pages to host, verbatim "
                         "restore) or auto (per-victim cost model); off "
                         "raises PoolExhausted")
    ap.add_argument("--victim", choices=("last_joined", "fewest_pages"),
                    default="last_joined",
                    help="paged engine: preemption victim selection")
    ap.add_argument("--oversubscribe", type=float, default=0.0,
                    metavar="FRAC",
                    help="paged engine: shrink the pool to FRAC of the "
                         "batch's uncontended working set (needs --preempt "
                         "requeue|swap|auto; overrides --n-pages)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged engine: share the packed pages of cached "
                         "prompt prefixes (needs --prefill chunked)")
    ap.add_argument("--prefix-min-pages", type=int, default=1,
                    help="prefix cache: fewest whole shared pages a match "
                         "must give to be taken")
    ap.add_argument("--prefill-priority", type=float, default=1.0,
                    help="paged engine, chunked prefill: prefill chunks per "
                         "decode-loop iteration (< 1 favours decode, > 1 "
                         "the first token)")
    # flags of the JAX CLI that this port does not serve yet: each raises
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--serve", default="sync")
    ap.add_argument("--metrics-dump", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--metrics-port", type=int, default=None)
    args = ap.parse_args(argv)

    for name, default in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not yet ported to "
                f"repro_torch (see ROADMAP.md)")
    if args.engine == "paged":
        if args.prefix_cache and args.prefill != "chunked":
            ap.error("--prefix-cache relies on the chunked path's "
                     "scheduling-invariant packed bytes; add "
                     "--prefill chunked")
        if args.oversubscribe and args.preempt == "off":
            ap.error("--oversubscribe deliberately undersizes the pool; "
                     "pick --preempt requeue|swap|auto so the engine can "
                     "evict victims instead of raising")

    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    model = Model(cfg, device=device)
    params = model.init_params(args.seed)
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size,
                              seq_len=args.prompt_len,
                              global_batch=args.batch, seed=args.seed))
    batch = data.global_batch(0)

    scfg = SPARQ_PRESETS[args.sparq]
    ctx, scales = None, None
    if scfg is not None:
        scales = model.calibrate(params, data.calib_batches(args.calibrate)) \
            if args.calibrate else None
        ctx = QuantCtx(mode="quantized", cfg=scfg)
        if args.prequantize:
            from repro_torch.models.quantize import quantize_params
            params = quantize_params(params, scfg.weight_bits)
    cache_cfg = make_cache_config(args.kv_cache, scfg)
    print(f"arch={cfg.name} sparq={args.sparq} kv-cache={args.kv_cache} "
          f"engine={args.engine} device={device} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")

    if args.engine == "scan":
        toks, stats = serve(model, params, batch, args.gen, ctx, scales,
                            cache_cfg)
        print(f"compile {stats['compile_s']:.1f} s | "
              f"prefill {stats['prefill_s']*1e3:.1f} ms | decode "
              f"{stats['decode_tok_s']:.1f} tok/s | cache "
              f"{stats['cache_bytes_per_value']:.4f} B/value data "
              f"(+{stats['cache_ctrl_bytes_per_value']:.4f} ctrl), "
              f"{stats['cache_total_bytes']/1e6:.2f} MB modeled")
        print("sample:", toks[0, :16])
        return {**stats, "tokens": toks}

    need = args.prompt_len + args.gen - 1
    max_seq = -(-need // args.page_size) * args.page_size
    pages_per_seq = max_seq // args.page_size
    n_pages = args.n_pages
    if args.oversubscribe:
        n_pages = max(pages_per_seq, math.ceil(
            args.oversubscribe * args.batch * pages_per_seq))
    policy = None if args.preempt == "off" else SchedulerPolicy(
        preempt=args.preempt, victim=args.victim)
    engine = ContinuousBatchingEngine(
        model, cache_cfg, ctx, scales, page_size=args.page_size,
        n_pages=n_pages, max_active=args.max_active or args.batch,
        max_seq_len=max_seq, policy=policy, prefill=args.prefill,
        chunk_size=args.chunk_size, chunk_align=args.chunk_align,
        chunk_seg=args.chunk_seg or None, prefix_cache=args.prefix_cache,
        prefix_min_pages=args.prefix_min_pages,
        prefill_priority=args.prefill_priority, device=device)
    reqs = [Request(batch["tokens"][b], args.gen) for b in range(args.batch)]
    engine.run(params, reqs)            # warm-up: builds kernels, untimed
    results, stats = engine.run(params, reqs)
    print(f"prefill {stats['prefill_s']*1e3:.1f} ms | decode "
          f"{stats['decode_tok_s']:.1f} tok/s | pool "
          f"{stats['peak_pages_used']}/{stats['pool_pages']} pages "
          f"({stats['page_size']} slots) peak, "
          f"{stats['cache_total_bytes']/1e6:.2f} MB modeled")
    if args.prefix_cache:
        print(f"prefix-cache: {stats['prefix_hits']} hits / "
              f"{stats['prefix_misses']} misses "
              f"({stats['prefix_hit_rate']:.0%}), "
              f"{stats['prefix_hit_tokens']} prompt tokens from cache, "
              f"{stats['prefix_shared_pages']} pages shared, "
              f"{stats['cow_copies']} CoW copies")
    if policy is not None:
        print(f"preempt={args.preempt} victim={args.victim}: "
              f"{stats['preemptions']} preemptions, {stats['resumes']} "
              f"resumes, {stats['replay_steps']} replay steps, swap "
              f"{stats['swap_bytes_out']/1e6:.2f} MB out / "
              f"{stats['swap_bytes_in']/1e6:.2f} MB in")
    print("sample:", results[0][:16])
    return {**stats, "tokens": results}


if __name__ == "__main__":
    main()
