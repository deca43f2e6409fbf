"""Port parity for preemption: the port's paged engine against
`repro.launch.serve.ContinuousBatchingEngine` on the oversubscribed trace
of tests/test_scheduler.py (`_make_trace(seed=0, n_req=6)`, pages of 4,
three slots), under requeue and swap with sequential admission (chunked
admission: tests/test_torch_preempt_chunked.py, a file of its own so
that the two run on separate test workers).

Both engines get the same weights (through `interop`), the same numpy
prompts and the same calibrated activation scales, and run in f32. The
host scheduler is the same algorithm, so each step's scheduler snapshot
(free list, slots, block table, refcounts, resume queue, swapped and
replaying requests) must be identical, as must the greedy tokens and the
preemption and swap counters; the port's snapshots also pass the
reference's per-step invariants (`InvariantChecker`, copied here and
reading the port's per-layer stores). Each JAX engine configuration runs
once per module.

Also here, without an engine: the allocator's reference counts under the
reference's interleaving scripts, `SchedulerPolicy`'s requeue/swap
crossover, and a swap round trip that restores every byte.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.core.sparq import SparqConfig as JCfg
from repro.distributed.sharding import set_activation_spec
from repro.launch import serve as jserve
from repro.models import paging as jpaging
from repro.models.cache import CacheConfig as JCC
from repro.models.common import QuantCtx as JCtx
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.launch import serve as tserve
from repro_torch.models import paging
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.model import Model as TModel

PS = 4                                          # page size for every trace


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small tensors: with several
    test workers on the machine, idle OpenMP threads spinning between
    small ops would take the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_activation_spec():
    """The JAX model constrains activations to a module-global spec that
    a training test earlier in the same worker may have left set; both
    engines here run on one device, unsharded."""
    set_activation_spec(None)
    yield


def make_models():
    """The reduced tinyllama in f32 in both packages, the JAX weights and
    calibrated scales, and their `interop` conversions."""
    jc = jcfg_reduced("tinyllama-1.1b").replace(dtype=jnp.float32,
                                                remat=False)
    tc = tcfg_reduced("tinyllama-1.1b").replace(dtype=torch.float32)
    jm = JModel(jc)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = TModel(tc, device="cpu")
    rng = np.random.default_rng(11)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jc.vocab_size,
                                                 (2, 16)))}]
    jscales = jm.calibrate(jp, calib)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    tscales = interop.scales_from_jax(jax.tree.map(np.asarray, jscales))
    return dict(jm=jm, jp=jp, jscales=jscales, tm=tm, tp=tp,
                tscales=tscales)


@pytest.fixture(scope="module")
def models():
    return make_models()


def make_trace(seed: int, n_req: int, vocab: int):
    """tests/test_scheduler.py::_make_trace: ragged short prompts, long
    budgets, staggered arrivals, as (tokens, gen, arrive_at)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_req):
        L = int(rng.integers(3, 8))
        g = int(rng.integers(6, 15))
        a = int(rng.integers(0, 12))
        reqs.append((rng.integers(0, vocab, (L,)), g, a))
    return reqs


class InvariantChecker:
    """tests/test_scheduler.py::InvariantChecker on the port's snapshots:
    refcounts equal block-table references, free and referenced pages
    partition the pool, shared pages are written never, block tables are
    contiguous prefixes, a request lives in one place, and (sampled) the
    device block table and positions agree with the host's."""

    def __init__(self, ps: int, deep_every: int = 5):
        self.ps = ps
        self.deep_every = deep_every
        self.steps = 0
        self.max_owned = 0

    def __call__(self, snap):
        slots = snap["slots"]
        owned = [p for info in slots.values() for p in info["pages"]]
        mult = {}
        for p in owned:
            mult[p] = mult.get(p, 0) + 1
        free = set(snap["free_pages"])
        assert mult == snap["page_refcounts"], \
            "page refcounts disagree with block-table references"
        assert free.isdisjoint(mult), "freed page still referenced"
        assert len(free) + len(mult) == snap["n_pages"], \
            "free-list conservation violated"
        for s, info in slots.items():
            if info["pos"] % self.ps:
                blk = info["pos"] // self.ps
                row = snap["host_bt"][s]
                if blk < row.shape[0] and row[blk] >= 0:
                    assert snap["page_refcounts"][row[blk]] == 1, \
                        f"slot {s} would write shared page {row[blk]}"
        self.max_owned = max(self.max_owned, len(owned))
        for s, info in slots.items():
            row = snap["host_bt"][s]
            nb = len(info["pages"])
            assert list(row[row >= 0]) == info["pages"]
            assert (row[:nb] >= 0).all() and (row[nb:] == -1).all()
            assert 0 <= info["pos"] <= nb * self.ps
            assert info["pos"] > (nb - 1) * self.ps - self.ps, \
                "sequence owns more than one block past its position"
        places = ([info["rid"] for info in slots.values()]
                  + snap["resume_rids"] + snap["queued"])
        assert len(places) == len(set(places)), "request in two places"
        if self.steps % self.deep_every == 0:
            # the port's layers share one block table [S, NB]
            bt_dev = snap["caches"][0].block_table.numpy()
            np.testing.assert_array_equal(bt_dev, snap["host_bt"])
            pos_dev = snap["caches"][0].seq_pos.numpy()
            for s in range(pos_dev.shape[0]):
                if s in snap.get("prefilling", ()):
                    assert pos_dev[s] == -1, \
                        f"mid-prefill slot {s} active on device"
                    continue
                want = slots[s]["pos"] if s in slots else -1
                assert pos_dev[s] == want, f"slot {s} position drift"
        self.steps += 1


def snapshot_view(snap):
    """The host scheduler state both engines' snapshots carry."""
    return (snap["step"], tuple(snap["free_pages"]),
            {s: (v["rid"], tuple(v["pages"]), v["pos"], v["generated"],
                 v["joined"]) for s, v in snap["slots"].items()},
            snap["host_bt"].tolist(), tuple(snap["prefilling"]),
            tuple(snap["replaying"]), tuple(snap["queued"]),
            tuple(snap["resume_rids"]), tuple(snap["swapped_rids"]),
            int(snap["swap_resident_bytes"]), snap["page_refcounts"],
            snap["prefix"])


STAT_KEYS = ("decode_steps", "prefill_chunks", "peak_pages_used",
             "preemptions", "preempt_requeue", "preempt_swap", "resumes",
             "replay_steps", "swap_bytes_out", "swap_bytes_in",
             "swap_peak_bytes", "prefix_hits", "prefix_misses",
             "prefix_hit_tokens", "prefix_shared_pages", "cow_copies",
             "swap_refusals")


def run_jax(models, trace, engine_kw, policy_kw):
    """The reference engine over `trace`: (tokens, stats, snapshots)."""
    codec = JCfg(bits=4, opts=5, signed=True)
    eng = jserve.ContinuousBatchingEngine(
        models["jm"], JCC.sparq_cache(codec, impl="reference"),
        JCtx(mode="quantized", cfg=codec, impl="reference"),
        models["jscales"], policy=jserve.SchedulerPolicy(**policy_kw),
        **engine_kw)
    snaps = []
    res, stats = eng.run(
        models["jp"], [jserve.Request(t, g, arrive_at=a)
                       for t, g, a in trace],
        trace_hook=lambda s: snaps.append(snapshot_view(s)))
    return {r: np.asarray(t) for r, t in res.items()}, stats, snaps


def run_port(models, trace, engine_kw, policy_kw):
    """The port's engine over `trace` on the CPU, every snapshot held to
    InvariantChecker: (tokens, stats, snapshots, checker)."""
    codec = TCfg(bits=4, opts=5, signed=True)
    eng = tserve.ContinuousBatchingEngine(
        models["tm"], TCC.sparq_cache(codec),
        TCtx(mode="quantized", cfg=codec), models["tscales"],
        policy=tserve.SchedulerPolicy(**policy_kw), device="cpu",
        **engine_kw)
    snaps, check = [], InvariantChecker(ps=PS)

    def hook(s):
        check(s)
        snaps.append(snapshot_view(s))
    res, stats = eng.run(
        models["tp"], [tserve.Request(t, g, arrive_at=a)
                       for t, g, a in trace], trace_hook=hook)
    return res, stats, snaps, check


def assert_same_run(jrun, trun):
    jres, jstats, jsnaps = jrun
    tres, tstats, tsnaps, _ = trun
    assert set(jres) == set(tres)
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], jres[rid],
                                      err_msg=f"request {rid}")
    assert len(tsnaps) == len(jsnaps)
    for i, (t, j) in enumerate(zip(tsnaps, jsnaps)):
        assert t == j, f"scheduler state differs at decode step {i}"
    for k in STAT_KEYS:
        assert tstats[k] == jstats[k], k


# pools of tests/test_scheduler.py's grid: tight (8) and heavily
# oversubscribed (6, barely above the largest request)
CONFIGS = {
    "pool8-requeue": (8, "requeue", "sequential"),
    "pool6-swap": (6, "swap", "sequential"),
    "pool8-requeue-chunked": (8, "requeue", "chunked"),
    "pool6-swap-chunked": (6, "swap", "chunked"),
}


@pytest.fixture(scope="module")
def runs(models):
    """Each configuration's JAX and port runs, made once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            n_pages, mode, prefill = CONFIGS[name]
            trace = make_trace(0, 6, models["jm"].cfg.vocab_size)
            kw = dict(page_size=PS, n_pages=n_pages, max_active=3,
                      max_seq_len=24, prefill=prefill, chunk_size=16,
                      chunk_align=4)
            pol = dict(preempt=mode, victim="last_joined")
            cache[name] = (trace, run_jax(models, trace, kw, pol),
                           run_port(models, trace, kw, pol))
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["pool8-requeue", "pool6-swap"])
def test_preemption_matches_jax_engine(runs, name):
    """Tokens, the scheduler state at every decode step, and the
    preemption / swap counters equal the JAX engine's; the pool was
    stressed; requeue replays, swap moves bytes out and back in."""
    n_pages, mode, prefill = CONFIGS[name]
    trace, jrun, trun = runs(name)
    assert_same_run(jrun, trun)
    _, stats, _, check = trun
    per_req = [math.ceil((len(t) + g - 1) / PS) for t, g, _ in trace]
    assert max(per_req) < n_pages <= sum(per_req)
    assert check.steps == stats["decode_steps"] > 0
    assert stats["preemptions"] > 0 and check.max_owned <= n_pages
    if mode == "swap":
        assert stats["swap_bytes_out"] == stats["swap_bytes_in"] > 0
        assert stats["preempt_swap"] > 0
    else:
        assert stats["replay_steps"] > 0 and stats["swap_bytes_out"] == 0
    assert stats["free_pages_after"] == n_pages


def test_swap_bytes_are_pages_times_page_bytes(runs, models):
    """A swap-out moves its pages' four int8 planes per layer and the two
    f32 scales per layer: the counters are that sum, in and out."""
    _, _, (_, stats, snaps, _) = runs("pool6-swap")
    cfg = models["tm"].cfg
    page_bytes = 4 * cfg.n_layers * PS * cfg.n_kv_heads * cfg.head_dim
    scale_bytes = 8 * cfg.n_layers              # k and v scale per layer
    seen = 0
    for snap in snaps:
        swapped, resident = snap[8], snap[9]
        assert (resident - scale_bytes * len(swapped)) % page_bytes == 0
        assert (resident > 0) == bool(swapped)
        seen += bool(swapped)
    assert seen, "no swap was resident at a decode step"
    moved = stats["swap_bytes_out"] - scale_bytes * stats["preempt_swap"]
    assert moved > 0 and moved % page_bytes == 0


# ----------------------------------------------------------------------
# without an engine
# ----------------------------------------------------------------------

def _run_allocator_script(n_pages: int, ops):
    """tests/test_scheduler.py::_run_allocator_script on the port's
    allocator, beside the JAX one, with shares and releases added:
    every operation leaves both in the same state, refcounts conserved."""
    al, ja = paging.PageAllocator(n_pages), jpaging.PageAllocator(n_pages)
    held = {}                                   # tag -> pages referenced
    swapped = {}                                # tag -> page count
    next_tag = 0
    for op_i, arg in ops:
        op = ("alloc", "free", "swap_out", "swap_in", "share",
              "release")[op_i % 6]
        if op == "alloc":
            k = 1 + arg % 3
            if k <= al.free_count:
                pages = al.alloc(k)
                assert ja.alloc(k) == pages
                held[next_tag] = pages
                next_tag += 1
            else:
                before = al.free_pages
                with pytest.raises(paging.PoolExhausted):
                    al.alloc(k)
                with pytest.raises(jpaging.PoolExhausted):
                    ja.alloc(k)
                assert al.free_pages == before, "failed alloc took pages"
        elif op in ("free", "swap_out") and held:
            tag = sorted(held)[arg % len(held)]
            pages = held[tag]
            if all(al.refcount(p) == 1 for p in pages):
                held.pop(tag)
                al.free(pages)
                ja.free(pages)
                if op == "swap_out":
                    swapped[tag] = len(pages)
        elif op == "swap_in" and swapped:
            tag = sorted(swapped)[arg % len(swapped)]
            if swapped[tag] <= al.free_count:
                held[tag] = al.alloc(swapped.pop(tag))
                assert ja.alloc(len(held[tag])) == held[tag]
        elif op == "share" and held:
            src = held[sorted(held)[arg % len(held)]]
            pages = src[:1 + arg % len(src)]
            al.share(pages)
            ja.share(pages)
            held[next_tag] = list(pages)
            next_tag += 1
        elif op == "release" and held:
            tag = sorted(held)[arg % len(held)]
            pages = held.pop(tag)
            assert al.release(pages) == ja.release(pages)
        refs = {}
        for pages in held.values():
            for p in pages:
                refs[p] = refs.get(p, 0) + 1
        assert al.refcounts == ja.refcounts == refs
        assert al.free_pages == ja.free_pages
        assert (al.used_count, al.shared_count, al.total_refs) == (
            ja.used_count, ja.shared_count, ja.total_refs)
        assert al.peak_used == ja.peak_used
        al.assert_consistent()
    al.reset_peak()
    ja.reset_peak()
    assert al.peak_used == ja.peak_used == al.used_count


@pytest.mark.parametrize("seed", range(8))
def test_allocator_refcount_scripts(seed):
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(1, 12))
    ops = [(int(rng.integers(0, 6)), int(rng.integers(0, 10 ** 6)))
           for _ in range(80)]
    _run_allocator_script(n_pages, ops)


def test_allocator_free_refuses_shared_pages():
    al = paging.PageAllocator(4)
    pages = al.alloc(2)
    al.share(pages[:1])
    with pytest.raises(AssertionError, match="shared"):
        al.free(pages)
    assert al.release(pages[:1]) == []          # one reference left
    al.free(pages)
    assert al.free_count == 4


def test_cost_model_crossover_is_pinned():
    """tests/test_prefill.py's crossover on the port's policy: requeue
    grows with decode progress, swap is flat in it; auto flips exactly
    where they cross, as the JAX policy does."""
    kw = dict(preempt="auto", prefill_tok_us=1.0, replay_tok_us=100.0,
              swap_gb_s=10.0)
    pol, jpol = tserve.SchedulerPolicy(**kw), jserve.SchedulerPolicy(**kw)
    L, swap_bytes = 50, 500_000
    req1, swap1 = pol.estimate_cost(L, 1, swap_bytes)
    reqN, swapN = pol.estimate_cost(L, 5, swap_bytes)
    assert swap1 == swapN == pytest.approx(100.0)
    assert req1 == pytest.approx(50.0) and reqN == pytest.approx(450.0)
    assert pol.resolve(L, 1, swap_bytes) == "requeue"
    assert pol.resolve(L, 2, swap_bytes) == "swap"
    for g in range(1, 8):
        for b in (1, 10 ** 5, 10 ** 6, 10 ** 7):
            assert pol.resolve(L, g, b) == jpol.resolve(L, g, b)
            assert pol.estimate_cost(L, g, b) == jpol.estimate_cost(L, g, b)
    assert tserve.SchedulerPolicy(preempt="requeue").resolve(
        L, 99, 1) == "requeue"
    assert tserve.SchedulerPolicy(preempt="swap").resolve(
        L, 1, 10 ** 9) == "swap"
    with pytest.raises(ValueError, match="preempt mode"):
        tserve.SchedulerPolicy(preempt="evict")
    with pytest.raises(ValueError, match="victim"):
        tserve.SchedulerPolicy(victim="oldest")


def test_swap_round_trip_is_byte_verbatim():
    """gather -> SwapStore.put -> pop -> restore onto other pages of
    another slot: every byte of the four planes, the scales and the
    position come back; the counters count the bytes once each way."""
    torch.manual_seed(0)
    cc = TCC.sparq_cache(TCfg.opt5(signed=True))
    stores = [paging.PagedCacheStore.init(3, 10, PS, 6, 2, 8, cc, "cpu")
              for _ in range(2)]
    for st in stores:
        for pool in st._pools():
            pool.copy_(torch.randint(-128, 128, pool.shape,
                                     dtype=torch.int8))
        st.k_scale.copy_(torch.rand(3))
        st.v_scale.copy_(torch.rand(3))
    src, dst = [2, 7, 4], [9, 0, 5]
    want = [{k: v.clone() for k, v in paging.gather_slot_pages(
        st, 1, torch.tensor(src)).items()} for st in stores]
    swap = paging.SwapStore()
    nbytes = swap.put(5, [paging.gather_slot_pages(st, 1, torch.tensor(src))
                          for st in stores], pos=11)
    assert nbytes == 2 * (4 * 3 * PS * 2 * 8 + 8)
    assert swap.n_pages(5) == 3 and swap.pos(5) == 11 and 5 in swap
    planes, pos = swap.pop(5, "cpu")
    assert pos == 11 and len(swap) == 0
    assert swap.bytes_out == swap.bytes_in == swap.peak == nbytes
    for st, pl in zip(stores, planes):
        paging.restore_slot_pages(st, pl, 2, torch.tensor(dst), pos)
    for st, w in zip(stores, want):
        got = paging.gather_slot_pages(st, 2, torch.tensor(dst))
        for k in w:
            assert got[k].dtype == w[k].dtype and torch.equal(got[k], w[k])
        assert st.block_table[2].tolist() == dst + [-1] * 3
        assert int(st.seq_pos[2]) == 11


def test_swap_store_host_view_and_discard():
    """`pop` without a device gives numpy views of the same bytes;
    `discard` forgets an entry without charging a swap-in."""
    cc = TCC.sparq_cache(TCfg.opt5(signed=True))
    st = paging.PagedCacheStore.init(2, 4, PS, 3, 1, 4, cc, "cpu")
    st.k_data.copy_(torch.arange(st.k_data.numel()).reshape(
        st.k_data.shape).to(torch.int8))
    st.k_scale[0] = 0.25
    swap = paging.SwapStore()
    g = paging.gather_slot_pages(st, 0, torch.tensor([3, 1]))
    n1 = swap.put(0, [g], pos=6)
    swap.put(1, [g], pos=2)
    assert swap.peak == 2 * n1 == swap.resident_bytes
    planes, pos = swap.pop(0)
    assert pos == 6 and planes[0]["k_data"].dtype == np.int8
    np.testing.assert_array_equal(planes[0]["k_data"], g["k_data"].numpy())
    assert planes[0]["k_scale"].tolist() == [0.25]
    assert swap.discard(1) == n1
    assert swap.bytes_in == n1 and swap.bytes_out == 2 * n1
