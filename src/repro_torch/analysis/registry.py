"""The registered hot programs the program auditor runs (port of
`repro.analysis.registry`).

The reference traces abstract shapes; the port runs each program on small
real tensors (`program_audit`). The geometry is the reference registry's:
reduced tinyllama in f32, page 16, 24 pages, 4 active slots, max sequence
80, chunk 32, query tiles of 8, SPARQ 5opt on the activations (calibrated
spans, every projection through K1) and on the KV cache. The programs run
on `device`: the CPU (the kernels' plain versions) or the card (the CUDA
kernels, `chip_smoke.py`'s audit phase). Each program's state (weights,
prefilled caches and pages) is built by its makers outside the recorder,
through the engines' own paths.

Programs (the reference's names):
  decode_step.scan     `DecodeEngine._decode`, the scan engine's greedy
                       loop over the contiguous packed cache (K1, K4, K5),
                       at two prompt lengths.
  decode_step.paged    `ContinuousBatchingEngine._step` over the paged
                       store after a chunked prefill (K1, K4, K2;
                       page_size declared: JX104).
  prefill_chunk        `PrefillScheduler.step`; its shape set comes from
                       driving the real packer over a ragged prompt mix
                       (multi-chunk prompts, mid-chunk joins, a short
                       prompt), so JX106 asserts one signature for every
                       join pattern (K1, K4, K3).
  decode_replay        `_prefill_alone` with `replay`: the requeue
                       resume's prefill, teacher-forced replay through K5
                       at `attn_bk = page_size` and adoption into pages;
                       `audit_cache=False` (it runs per recorded-token
                       count), page_size declared (JX104).
  ops.*                each dispatcher of `kernels.ops.HOT_DISPATCHERS`
                       alone, on packed planes shaped like the engines'
                       (K1 .. K6).
  decode_step.paged_tp2 / prefill_chunk_tp2
                       the paged step and the chunk program of a
                       tensor-parallel engine of 2 shards (the port's
                       one-process mesh: both shards on `device`, so they
                       are registered on one device too).
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from repro_torch.analysis.program_audit import ProgramSpec
from repro_torch.core.quantizer import QScale
from repro_torch.core.sparq import SparqConfig

# serving geometry (the reference registry's)
PAGE_SIZE = 16
N_PAGES = 24
MAX_ACTIVE = 4
MAX_SEQ_LEN = 80
CHUNK = 32
ALIGN = 8
# the packer's ragged prompt mix and the scan engine's prompts
PROMPTS = (17, 33, 46, 9)
SCAN_PROMPTS = (8, 12)
SEED = 0


def _codec() -> SparqConfig:
    return SparqConfig.opt5(signed=True)


@functools.lru_cache(maxsize=2)
def _model(device: str):
    """(model, params, ctx, scales): reduced tinyllama in f32 on `device`,
    its params from a seed, 5opt with spans calibrated on one batch."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.common import QuantCtx
    from repro_torch.models.model import Model
    cfg = get_reduced_config("tinyllama-1.1b").replace(
        dtype=torch.float32, remat=False)
    model = Model(cfg, device=torch.device(device))
    params = model.init_params(SEED)
    rng = np.random.default_rng(SEED)
    calib = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}]
    scales = model.calibrate(params, calib)
    return model, params, QuantCtx(mode="quantized", cfg=_codec()), scales


def _prompt(n: int, salt: int) -> np.ndarray:
    return (np.arange(n, dtype=np.int64) * 7 + 3 * salt) % 97 + 1


def _scan_engine_specs(device) -> List[ProgramSpec]:
    from repro_torch.launch.serve import DecodeEngine
    from repro_torch.models.cache import CacheConfig
    model, params, ctx, scales = _model(str(device))
    eng = DecodeEngine(model, CacheConfig.sparq_cache(_codec()), ctx,
                       scales)
    B, L = 2, 64

    def at(n):
        def make():
            caches = eng.init_cache(B, L)
            batch = {"tokens": torch.as_tensor(np.stack(
                [_prompt(n, b) for b in range(B)]), device=model.device)}
            with torch.no_grad():
                tok = eng._prefill(params, batch, caches)
            pos = torch.tensor(n, dtype=torch.int32, device=model.device)
            return params, tok, caches, pos, 4
        return make
    return [ProgramSpec("decode_step.scan", eng._decode,
                        [at(n) for n in SCAN_PROMPTS])]


def _engine(device, mesh=None):
    from repro_torch.launch.serve import ContinuousBatchingEngine
    from repro_torch.models.cache import CacheConfig
    model, params, ctx, scales = _model(str(device))
    cc = CacheConfig.sparq_cache(_codec())
    return ContinuousBatchingEngine(
        model, cc, ctx, scales, page_size=PAGE_SIZE, n_pages=N_PAGES,
        max_active=MAX_ACTIVE, max_seq_len=MAX_SEQ_LEN, prefill="chunked",
        chunk_size=CHUNK, chunk_align=ALIGN, device=device, mesh=mesh)


def _chunk_set(eng):
    """Drive the engine's packer over the ragged prompt mix: (fresh stores
    and block tables, every planned chunk's program arguments and its
    seq_pos_after), as the engine's loop grants pages and fills the
    block tables."""
    sched = eng._sched
    sched.reset()
    stores, bts = eng._init_stores()
    n_blocks = MAX_SEQ_LEN // PAGE_SIZE
    host_bt = np.full((MAX_ACTIVE, n_blocks), -1, np.int64)
    next_page = [0]

    def grant(slot, blocks):
        for b in blocks:
            host_bt[slot, b] = next_page[0]
            next_page[0] += 1

    for slot, n_tok in enumerate(PROMPTS):
        sched.add(slot, slot, _prompt(n_tok, slot))
    host_pos = np.zeros(MAX_ACTIVE, np.int64)     # tokens written a slot
    chunks = []
    while True:
        plan = sched.plan(lambda: N_PAGES - next_page[0], grant, host_bt)
        if plan is None:
            break
        # the engine's seq_pos_after: a decoding slot's position, a slot
        # whose prompt this chunk completes its length, -1 elsewhere
        spa = np.full(MAX_ACTIVE, -1, np.int64)
        for s in range(MAX_ACTIVE):
            if not sched.has(s) and s not in plan.advanced:
                spa[s] = host_pos[s]
        for s, _, _ in plan.completed:
            spa[s] = host_pos[s] + plan.advanced[s]
        for s, n in plan.advanced.items():
            host_pos[s] += n
        chunks.append((plan, host_bt.copy(), spa))
    assert chunks, "the packer produced no chunks"
    return stores, bts, chunks


def _set_tables(bts, host_bt):
    for bt in bts:
        bt.copy_(torch.as_tensor(host_bt, dtype=torch.int32))


def _paged_specs(device, mesh=None, suffix="") -> List[ProgramSpec]:
    model, params, _, _ = _model(str(device))
    eng = _engine(device, mesh)
    sched = eng._sched

    def chunk_entry(state, i):
        def make():
            if i == 0:
                state.clear()
                state.update(zip(("stores", "bts", "chunks"),
                                 _chunk_set(eng)))
            plan, host_bt, spa = state["chunks"][i]
            _set_tables(state["bts"], host_bt)
            tokens, meta, last = sched.inputs(plan, spa)
            return params, tokens, state["stores"], meta, last
        return make

    def step_entry(k):
        def make():
            stores, bts, chunks = _chunk_set(eng)
            with torch.no_grad():
                for plan, host_bt, spa in chunks:
                    _set_tables(bts, host_bt)
                    sched.run(params, stores, plan, spa)
            tok = torch.as_tensor(
                [[_prompt(n, s)[-1]] for s, n in enumerate(PROMPTS)],
                dtype=torch.int32, device=model.device)
            for _ in range(k):      # the k-th step of the loop
                with torch.no_grad():
                    tok = eng._step(params, tok, stores, stores[0].seq_pos)
            return params, tok, stores, stores[0].seq_pos
        return make

    n_chunks = len(_chunk_set(eng)[2])
    state: dict = {}
    return [
        ProgramSpec("decode_step.paged" + suffix, eng._step,
                    [step_entry(0), step_entry(1)], page_size=PAGE_SIZE),
        ProgramSpec("prefill_chunk" + suffix, sched.step,
                    [chunk_entry(state, i) for i in range(n_chunks)],
                    page_size=PAGE_SIZE)]


def _replay_specs(device) -> List[ProgramSpec]:
    eng = _engine(device)
    _, params, _, _ = _model(str(device))

    def at(n_replay):
        def make():
            stores, _ = eng._init_stores()
            prompt = _prompt(21, 5)
            pages = list(range(-(-(len(prompt) + n_replay + 1)
                                 // PAGE_SIZE)))
            replay = _prompt(n_replay, 9).tolist()
            return params, prompt, stores, 1, pages, replay
        return make
    return [ProgramSpec("decode_replay", eng._prefill_alone,
                        [at(4), at(7)], page_size=PAGE_SIZE,
                        audit_cache=False)]


def _dispatcher_specs(device) -> List[ProgramSpec]:
    from repro_torch.kernels import ops
    model, _, _, _ = _model(str(device))
    cfg = model.cfg
    codec = _codec()
    KV, hd, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    P, ps, NB, S = 8, PAGE_SIZE, MAX_SEQ_LEN // PAGE_SIZE, MAX_ACTIVE
    dev = torch.device(device)
    f32, i32 = torch.float32, torch.int32

    def rand(*shape, seed=0):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g, dtype=f32).to(dev)

    def packed(*shape, seed=0):
        """A §5.1 packed plane pair of `shape` (store, meta) and its f32
        scale, quantized from a seeded normal with the codec."""
        x = rand(*shape, seed=seed)
        scale = torch.amax(torch.abs(x)) / codec.max_val
        codes, meta = ops.sparq_quantize(x, scale.reshape(1), codec)
        return ops.sparq_pack(codes, meta), meta, scale

    def qm():
        w = torch.clamp(torch.round(rand(64, 32, seed=1) * 40), -127, 127)
        act = QScale(scale=torch.tensor(0.02, device=dev), bits=8,
                     signed=True)
        return (rand(8, 64), w.to(torch.int8), act,
                torch.full((32,), 0.01, device=dev), codec)

    def quant():
        return rand(32, 64), torch.full((1,), 0.02, device=dev), codec

    def dequant():
        store, meta, _ = packed(32, 64, seed=2)
        return store, meta

    def contiguous():
        kd, km, ks = packed(2, 32, KV, hd, seed=3)
        vd, vm, vs = packed(2, 32, KV, hd, seed=4)
        kpos = torch.arange(32, dtype=i32, device=dev).repeat(2, 1)
        return (rand(2, 1, H, hd, seed=5), kd, km, ks, vd, vm, vs, kpos,
                torch.tensor(29, dtype=i32, device=dev), 0, ps)

    def pools():
        kd, km, ks = packed(P, ps, KV, hd, seed=6)
        vd, vm, vs = packed(P, ps, KV, hd, seed=7)
        bt = torch.full((S, NB), -1, dtype=i32, device=dev)
        bt[:, :2] = torch.arange(S * 2, dtype=i32,
                                 device=dev).reshape(S, 2) % P
        return kd, km, ks.repeat(S), vd, vm, vs.repeat(S), bt

    def chunked():
        kd, km, ks, vd, vm, vs, bt = pools()
        seq = torch.arange(CHUNK, device=dev) // (CHUNK // S)
        pos = 32 + torch.arange(CHUNK, device=dev) % (CHUNK // S)
        return (rand(CHUNK, H, hd, seed=8), rand(CHUNK, KV, hd, seed=9),
                rand(CHUNK, KV, hd, seed=10), kd, km, ks, vd, vm, vs, bt,
                seq.to(i32), pos.to(i32), torch.full_like(pos, 32).to(i32),
                torch.arange(CHUNK // ALIGN, device=dev).to(i32)
                // (CHUNK // ALIGN // S), 0, ALIGN)

    def paged():
        kd, km, ks, vd, vm, vs, bt = pools()
        cur = torch.tensor([31, 20, 5, -1], dtype=i32, device=dev)
        return (rand(S, 1, H, hd, seed=11), kd, km, ks, vd, vm, vs, bt,
                cur)

    specs = [
        ProgramSpec("ops.quantized_matmul", ops.quantized_matmul, [qm]),
        ProgramSpec("ops.sparq_quantize", ops.sparq_quantize, [quant]),
        ProgramSpec("ops.sparq_dequantize", ops.sparq_dequantize,
                    [dequant]),
        ProgramSpec("ops.sparq_decode_attention", ops.sparq_decode_attention,
                    [contiguous]),
        ProgramSpec("ops.sparq_chunked_prefill_attention",
                    ops.sparq_chunked_prefill_attention, [chunked],
                    page_size=PAGE_SIZE),
        ProgramSpec("ops.sparq_paged_decode_attention",
                    ops.sparq_paged_decode_attention, [paged],
                    page_size=PAGE_SIZE),
    ]
    missing = set(ops.HOT_DISPATCHERS) - {s.name.split(".", 1)[1]
                                          for s in specs}
    assert not missing, f"dispatchers registered but not audited: {missing}"
    return specs


def default_programs(device="cpu") -> List[ProgramSpec]:
    """Every registered hot program, on `device` ("cpu": the kernels'
    plain versions; "cuda": the kernels)."""
    from repro_torch.launch.mesh import make_tp_mesh
    device = torch.device(device)
    specs: List[ProgramSpec] = []
    specs += _scan_engine_specs(device)
    specs += _paged_specs(device)
    specs += _replay_specs(device)
    specs += _paged_specs(device, make_tp_mesh(2, devices=[device] * 2),
                          "_tp2")
    specs += _dispatcher_specs(device)
    # the reference's order: engines, replay, TP variants, dispatchers
    order = ("decode_step.scan", "decode_step.paged", "prefill_chunk",
             "decode_replay", "decode_step.paged_tp2", "prefill_chunk_tp2")
    head = sorted((s for s in specs if s.name in order),
                  key=lambda s: order.index(s.name))
    return head + [s for s in specs if s.name not in order]

