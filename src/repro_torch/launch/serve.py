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
      interleaved with decode steps).

Not ported yet: preemption (pool exhaustion raises `PoolExhausted`), the
prefix cache, tensor parallelism, the async front-end and telemetry;
their flags raise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --reduced --batch 4 --prompt-len 64 --gen 16 --sparq 5opt \\
        --kv-cache sparq --prequantize --device cuda           # scan engine
    ... --engine paged --prefill sequential|chunked             # paged engine
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


@dataclasses.dataclass
class _Slot:
    """Host-side state of one active sequence slot."""
    rid: int
    target: int                 # total tokens to emit (== Request.gen)
    generated: int              # tokens emitted so far (tok0 counts)
    pages: List[int]            # physical pages owned by this sequence


class ContinuousBatchingEngine:
    """Greedy generation over ragged requests with a paged SPARQ cache.
    `max_active` slots share `n_pages` pages of `page_size` slots;
    decode-time pool exhaustion raises `PoolExhausted`. `prefill` picks the
    admission: "sequential" (each prompt prefills alone into a batch-1
    contiguous cache, adopted page by page) or "chunked" (prompts stream
    through fixed-size chunks written straight into pages). Runs on the
    model's device; `device` (default `cuda`) must name it, so a CPU run is
    always asked for explicitly."""

    def __init__(self, model: Model, cache_cfg: CacheConfig,
                 ctx: Optional[QuantCtx] = None, scales_groups=None, *,
                 page_size: int = 16, n_pages: int = 64,
                 max_active: int = 4, max_seq_len: int = 512,
                 prefill: str = "sequential", chunk_size: int = 32,
                 chunk_align: int = 8, chunk_seg: Optional[int] = None,
                 device=None):
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
        self.model = model
        self.cc = cache_cfg
        self.ctx = ctx
        self.scales_groups = scales_groups
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_active = max_active
        self.n_blocks = max_seq_len // page_size
        self.prefill_mode = prefill
        self._sched = None
        if prefill == "chunked":
            self._sched = PrefillScheduler(
                model, ctx, scales_groups, chunk_size=chunk_size,
                align=chunk_align, page_size=page_size, n_slots=max_active,
                seg=chunk_seg)

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
                       slot: int, pages: List[int]) -> torch.Tensor:
        """Sequential admission of one prompt: prefill it into a batch-1
        contiguous sparq cache of len(pages) pages, then adopt every
        layer's packed bytes, scales and position into the pool at `slot`.
        Returns the first greedy token, int32 [1] on the device."""
        ps = self.page_size
        tmp = self.model.init_cache(1, len(pages) * ps, cache_cfg=self.cc)
        logits = self.model.prefill(
            params, {"tokens": tokens[None]}, tmp, ctx=self.ctx,
            scales_groups=self.scales_groups)
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
    def _snapshot(n_steps, allocator, slots, host_bt, host_pos,
                  prefilling) -> dict:
        """Scheduler state handed to `run(trace_hook=...)` before each
        decode step (the keys of the JAX engine's snapshot that this
        configuration has)."""
        return {
            "step": n_steps,
            "n_pages": allocator.n_pages,
            "free_pages": allocator.free_pages,
            "peak_pages": allocator.peak_used,
            "slots": {s: {"rid": st.rid, "pages": list(st.pages),
                          "pos": int(host_pos[s]),
                          "generated": st.generated, "target": st.target}
                      for s, st in enumerate(slots) if st is not None},
            "host_bt": host_bt.copy(),
            "prefilling": tuple(prefilling),
            "page_refcounts": allocator.refcounts,
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
        pool and fresh (uncalibrated) cache scales. `trace_hook`, if given,
        gets a scheduler-state snapshot before every decode step."""
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
        caches, bt_dev = self._init_stores()
        tok = torch.zeros((S, 1), dtype=torch.int32, device=dev)
        slots: List[Optional[_Slot]] = [None] * S
        host_bt = np.full((S, NB), -1, np.int64)
        host_pos = np.full((S,), -1, np.int64)
        queue = [(float(r.arrive_at), rid, r) for rid, r in requests.items()]
        heapq.heapify(queue)
        first_tok: Dict[int, torch.Tensor] = {}   # rid -> device scalar
        outputs: Dict[int, List[int]] = {rid: [] for rid in requests}
        n_steps = 0
        clock = 0.0
        prefill_s = 0.0
        n_chunks = 0
        n_tokens = 0

        def evict(s: int):
            allocator.release(slots[s].pages)
            paging.evict_slot(caches, s)
            host_bt[s] = -1
            host_pos[s] = -1
            slots[s] = None

        def push_block_table():
            bt_dev.copy_(torch.as_tensor(host_bt, dtype=torch.int32))

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

        def check_page_accounting():
            mult: Dict[int, int] = {}
            for st in slots:
                for p in (st.pages if st is not None else ()):
                    mult[p] = mult.get(p, 0) + 1
            assert mult == allocator.refcounts, \
                "page refcounts disagree with block-table references"
            assert allocator.free_count + len(mult) == self.n_pages, \
                "free-list conservation violated (pages leaked)"
            for s, st in enumerate(slots):
                if st is None:
                    continue
                row = host_bt[s][host_bt[s] >= 0]
                assert list(row) == st.pages, \
                    f"slot {s}: block table disagrees with owned pages"
                assert 0 <= host_pos[s] <= len(st.pages) * ps, \
                    f"slot {s}: position outside its allocated blocks"

        def arrived():
            return bool(queue) and queue[0][0] <= clock

        def prefilling(s: int) -> bool:
            return sched is not None and sched.has(s)

        t_run0 = time.perf_counter()
        while True:
            # ---- evict finished sequences: pages back to the free list
            for s in range(S):
                st = slots[s]
                if st is not None and st.generated >= st.target:
                    evict(s)

            # ---- admit arrivals: a host-side bind; pages are granted
            # chunk by chunk. Watermark: fresh prompt pages, plus the
            # request's own first growth page when its prompt ends on a
            # block boundary, plus running and prefilling sequences' debt.
            while None in slots and arrived():
                s = slots.index(None)
                _, rid, req = queue[0]
                L = len(req.tokens)
                own = 1 if (req.gen > 1 and L % ps == 0) else 0
                need = math.ceil(L / ps) + own
                if allocator.free_count < need + growth_debt() \
                        + prefill_debt():
                    if not any(slots):
                        allocator.alloc(need)           # PoolExhausted
                    break                               # wait for evictions
                heapq.heappop(queue)
                if sched is not None:
                    slots[s] = _Slot(rid=rid, target=req.gen, generated=0,
                                     pages=[])
                    host_bt[s] = -1
                    host_pos[s] = 0
                    sched.add(s, rid, req.tokens)
                    continue
                # sequential: the whole prompt now, alone, then adoption
                pages = allocator.alloc(math.ceil(L / ps))
                t0 = time.perf_counter()
                tok0 = self._prefill_alone(params, req.tokens, caches, s,
                                           pages)
                _sync(dev)
                prefill_s += time.perf_counter() - t0
                first_tok[rid] = tok0[0]
                tok[s, 0] = tok0[0]
                slots[s] = _Slot(rid=rid, target=req.gen, generated=1,
                                 pages=list(pages))
                host_bt[s] = -1
                host_bt[s, :len(pages)] = pages
                host_pos[s] = L

            # ---- one prefill chunk of the packed prompt stream
            chunk_ran = False
            if sched is not None and sched.pending:
                def budget() -> int:
                    return max(allocator.free_count - growth_debt(), 0)

                def grant(slot_want: int, blocks: List[int]) -> None:
                    for b in blocks:
                        (pg,) = allocator.alloc(1)
                        slots[slot_want].pages.append(pg)
                        host_bt[slot_want, b] = pg

                plan = sched.plan(budget, grant, host_bt)
                if plan is not None:
                    push_block_table()
                    spa = np.full((S,), -1, np.int64)
                    for s2 in range(S):
                        if slots[s2] is not None and not sched.has(s2):
                            spa[s2] = host_pos[s2]
                    for s2, _ in plan.completed:
                        spa[s2] = host_pos[s2] + plan.advanced[s2]
                    t0 = time.perf_counter()
                    am = sched.run(params, caches, plan, spa)
                    _sync(dev)
                    prefill_s += time.perf_counter() - t0
                    n_chunks += 1
                    chunk_ran = True
                    for s2, n in plan.advanced.items():
                        host_pos[s2] += n
                    for s2, rid2 in plan.completed:
                        first_tok[rid2] = am[s2]
                        slots[s2].generated = 1
                        tok[s2, 0] = am[s2]

            if not any(slots):
                if arrived():
                    continue
                if queue:
                    clock = max(clock, queue[0][0])     # idle fast-forward
                    continue
                break                                   # drained

            # ---- allocate the page each next token is written into
            dirty = False
            for s in range(S):
                st = slots[s]
                if st is None or st.generated >= st.target or prefilling(s):
                    continue
                blk = host_pos[s] // ps
                if host_bt[s, blk] >= 0:
                    continue
                if allocator.free_count < 1:
                    check_page_accounting()
                    raise paging.PoolExhausted(
                        f"page pool exhausted growing slot {s}; preemption "
                        f"is not ported — grow --n-pages")
                (pg,) = allocator.alloc(1)
                st.pages.append(pg)
                host_bt[s, blk] = pg
                dirty = True
            if dirty:
                push_block_table()
            check_page_accounting()

            in_prefill = tuple(s for s in range(S) if prefilling(s))
            active = tuple((s, slots[s].rid) for s in range(S)
                           if slots[s] is not None
                           and slots[s].generated < slots[s].target
                           and s not in in_prefill)
            if not active:
                if sched is not None and sched.pending and not chunk_ran:
                    check_page_accounting()
                    raise paging.PoolExhausted(
                        f"page pool exhausted mid-prefill of slot "
                        f"{sched.jobs[0].slot}; preemption is not ported")
                continue
            if trace_hook is not None:
                trace_hook(self._snapshot(n_steps, allocator, slots, host_bt,
                                          host_pos, in_prefill))

            # ---- one decode step over every slot; one D2H copy
            tok = self._step(params, tok, caches, caches[0].seq_pos)
            toks = tok[:, 0].tolist()
            n_steps += 1
            clock += 1
            n_tokens += len(active)
            for s, rid in active:
                outputs[rid].append(toks[s])
                slots[s].generated += 1
                host_pos[s] += 1

        _sync(dev)
        t_total = time.perf_counter() - t_run0
        firsts = dict(zip(first_tok, torch.stack(list(first_tok.values()))
                          .tolist())) if first_tok else {}
        results = {rid: np.asarray([firsts[rid]] + outputs[rid], np.int32)
                   for rid in requests}
        for rid, req in requests.items():
            assert len(results[rid]) == req.gen, (rid, len(results[rid]))
        decode_s = max(t_total - prefill_s, 1e-9)
        pool = paging.modeled_pool_bytes(caches)
        stats = {
            "device": str(dev),
            "prefill_mode": self.prefill_mode,
            "prefill_s": prefill_s,
            "prefill_chunks": n_chunks,
            "run_s": t_total,
            "decode_s": decode_s,
            "decode_steps": n_steps,
            "decode_tokens": n_tokens,
            "decode_tok_s": n_tokens / decode_s,
            "pool_pages": self.n_pages,
            "page_size": ps,
            "peak_pages_used": allocator.peak_used,
            "free_pages_after": allocator.free_count,
            "total_tokens_served": sum(len(r.tokens) + r.gen - 1
                                       for r in requests.values()),
            "cache_bytes_per_value": cache_mod.bytes_per_value(self.cc),
            "cache_total_bytes": pool["total_bytes"],
        }
        return results, stats


_NOT_PORTED = {
    "preempt": "off", "prefix_cache": False, "tp": 1, "serve": "sync",
    "metrics_dump": None, "trace_out": None, "metrics_port": None,
    "oversubscribe": 0.0, "prefill_priority": 1.0,
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
    # flags of the JAX CLI that this port does not serve yet: each raises
    ap.add_argument("--preempt", default="off")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--serve", default="sync")
    ap.add_argument("--metrics-dump", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--oversubscribe", type=float, default=0.0)
    ap.add_argument("--prefill-priority", type=float, default=1.0)
    args = ap.parse_args(argv)

    for name, default in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not yet ported to "
                f"repro_torch (see ROADMAP.md)")

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
    engine = ContinuousBatchingEngine(
        model, cache_cfg, ctx, scales, page_size=args.page_size,
        n_pages=args.n_pages, max_active=args.max_active or args.batch,
        max_seq_len=max_seq, prefill=args.prefill,
        chunk_size=args.chunk_size, chunk_align=args.chunk_align,
        chunk_seg=args.chunk_seg or None, device=device)
    reqs = [Request(batch["tokens"][b], args.gen) for b in range(args.batch)]
    engine.run(params, reqs)            # warm-up: builds kernels, untimed
    results, stats = engine.run(params, reqs)
    print(f"prefill {stats['prefill_s']*1e3:.1f} ms | decode "
          f"{stats['decode_tok_s']:.1f} tok/s | pool "
          f"{stats['peak_pages_used']}/{stats['pool_pages']} pages "
          f"({stats['page_size']} slots) peak, "
          f"{stats['cache_total_bytes']/1e6:.2f} MB modeled")
    print("sample:", results[0][:16])
    return {**stats, "tokens": results}


if __name__ == "__main__":
    main()
