"""Paged continuous-batching server (port of `repro.launch.serve`'s
`ContinuousBatchingEngine`, chunked-prefill configuration).

Ragged requests share one pool of fixed-size §5.1 packed pages per layer
(page ids shared across layers, one block table). The host loop only
schedules — admission, chunk planning and page grants, growth pages at
block boundaries, eviction — between device steps. Prompts stream through
fixed-size prefill chunks (`launch.prefill`) interleaved with decode steps;
every decode step is one call over all slots (inactive slots are masked
inside the kernels), and its greedy tokens come back to the host in one
device-to-host copy (one `.tolist()`).

Ported configuration: `--prefill chunked`, no preemption (pool
exhaustion raises `PoolExhausted`), no prefix cache, one device, a
synchronous run. The other features of the JAX engine are not ported yet;
their flags raise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --reduced --batch 4 --prompt-len 64 --gen 16 --sparq 5opt \\
        --kv-cache sparq --prefill chunked --prequantize --device cuda
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
    if layout == "sparq":
        if sparq is None:
            return CacheConfig(layout="sparq")
        return CacheConfig.sparq_cache(sparq)
    if layout in ("fp32", "bf16"):
        raise NotImplementedError(
            f"--kv-cache {layout} serves through the scan engine, which is "
            f"not yet ported; the paged engine stores sparq pages")
    raise ValueError(layout)


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ContinuousBatchingEngine:
    """Greedy generation over ragged requests with a paged SPARQ cache and
    chunked prefill. `max_active` slots share `n_pages` pages of
    `page_size` slots; decode-time pool exhaustion raises
    `PoolExhausted`. Runs on the model's device; `device` (default
    `cuda`) must name it, so a CPU run is always asked for explicitly."""

    def __init__(self, model: Model, cache_cfg: CacheConfig,
                 ctx: Optional[QuantCtx] = None, scales_groups=None, *,
                 page_size: int = 16, n_pages: int = 64,
                 max_active: int = 4, max_seq_len: int = 512,
                 prefill: str = "chunked", chunk_size: int = 32,
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
        if prefill != "chunked":
            raise NotImplementedError(
                f"prefill={prefill!r} (sequential admission + "
                f"adopt_prefill) is not yet ported; use prefill='chunked'")
        self.model = model
        self.cc = cache_cfg
        self.ctx = ctx
        self.scales_groups = scales_groups
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_active = max_active
        self.n_blocks = max_seq_len // page_size
        self.prefill_mode = prefill
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
                if st is None or st.generated >= st.target or sched.has(s):
                    continue
                if host_bt[s, host_pos[s] // ps] < 0:
                    debt += 1
            return debt

        def prefill_debt() -> int:
            """Pages mid-prefill sequences still need, plus the first growth
            page of any whose prompt ends on a block boundary."""
            debt = 0
            for j in sched.jobs:
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
                slots[s] = _Slot(rid=rid, target=req.gen, generated=0,
                                 pages=[])
                host_bt[s] = -1
                host_pos[s] = 0
                sched.add(s, rid, req.tokens)

            # ---- one prefill chunk of the packed prompt stream
            chunk_ran = False
            if sched.pending:
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
                if st is None or st.generated >= st.target or sched.has(s):
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

            prefilling = tuple(s for s in range(S) if sched.has(s))
            active = tuple((s, slots[s].rid) for s in range(S)
                           if slots[s] is not None
                           and slots[s].generated < slots[s].target
                           and s not in prefilling)
            if not active:
                if sched.pending and not chunk_ran:
                    check_page_accounting()
                    raise paging.PoolExhausted(
                        f"page pool exhausted mid-prefill of slot "
                        f"{sched.jobs[0].slot}; preemption is not ported")
                continue
            if trace_hook is not None:
                trace_hook(self._snapshot(n_steps, allocator, slots, host_bt,
                                          host_pos, prefilling))

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
        description="paged chunked-prefill SPARQ serving (PyTorch/CUDA)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sparq", choices=list(SPARQ_PRESETS), default="5opt")
    ap.add_argument("--kv-cache", choices=("fp32", "bf16", "sparq"),
                    default="sparq")
    ap.add_argument("--engine", choices=("scan", "paged"), default="paged")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=64)
    ap.add_argument("--max-active", type=int, default=0,
                    help="concurrent sequence slots (default: --batch)")
    ap.add_argument("--prefill", choices=("sequential", "chunked"),
                    default="chunked")
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
    if args.engine != "paged":
        raise NotImplementedError("--engine scan is not yet ported")
    if args.prefill != "chunked":
        raise NotImplementedError("--prefill sequential is not yet ported")

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
          f"device={device} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")

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
    return stats


if __name__ == "__main__":
    main()
