"""Port parity for the prefix cache: the port's paged chunked engine
against `repro.launch.serve.ContinuousBatchingEngine` on the shared-
system-prompt trace of tests/test_scheduler.py (`_make_shared_trace(
seed=7)`: an 8-token preamble, ragged tails, two duplicates of the first
prompt; pages of 4, segments of 2), with the prefix cache on and off, at a
generous pool (24 pages: donors stay resident, duplicates copy-on-write
their boundary page) and an oversubscribed one (7 pages, swap: victims
holding shared pages requeue instead).

As in tests/test_torch_preempt.py: tokens, the scheduler state at every
decode step (refcounts, prefix counters) and the prefix / preemption
counters equal the JAX engine's, and the port's snapshots pass the
reference's per-step invariants. Tokens with the cache on equal tokens
with it off. Each JAX engine configuration runs once per module.

Also here, without an engine: `PrefixIndex` against the reference's
naive dictionary model and against the JAX index, exact-token lookups
under forced hash collisions, and the copy-on-write and scale-adoption
steps of shared admission.
"""
import numpy as np
import pytest
import torch

from repro.models import paging as jpaging
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.models import paging
from repro_torch.models.cache import CacheConfig as TCC
from test_torch_preempt import (PS, _no_activation_spec,  # noqa: F401
                                _one_thread, assert_same_run, make_models,
                                run_jax, run_port)


@pytest.fixture(scope="module")
def models():
    return make_models()


def make_shared_trace(seed: int, vocab: int):
    """tests/test_scheduler.py::_make_shared_trace as (tokens, gen,
    arrive_at): a shared 8-token preamble (2 pages), four ragged tails
    (request 0's prompt a whole number of pages), and two duplicates of
    request 0, staggered so later requests admit while donors live."""
    rng = np.random.default_rng(seed)
    preamble = rng.integers(0, vocab, (8,))
    reqs = []
    for i in range(4):
        tail = rng.integers(0, vocab,
                            (4 if i == 0 else int(rng.integers(1, 5)),))
        g = int(rng.integers(6, 11))
        reqs.append((np.concatenate([preamble, tail]), g, 3 * i))
    for a in (2, 7):
        reqs.append((reqs[0][0].copy(), int(rng.integers(6, 11)), a))
    return reqs


CONFIGS = {
    "pool24-requeue-on": (24, "requeue", True),
    "pool24-requeue-off": (24, "requeue", False),
    "pool7-swap-on": (7, "swap", True),
    "pool7-swap-off": (7, "swap", False),
}


@pytest.fixture(scope="module")
def runs(models):
    """Each configuration's JAX and port runs, made once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            n_pages, mode, prefix = CONFIGS[name]
            trace = make_shared_trace(7, models["jm"].cfg.vocab_size)
            kw = dict(page_size=PS, n_pages=n_pages, max_active=3,
                      max_seq_len=24, prefill="chunked", chunk_size=16,
                      chunk_align=4, chunk_seg=2, prefix_cache=prefix)
            pol = dict(preempt=mode, victim="last_joined")
            cache[name] = (run_jax(models, trace, kw, pol),
                           run_port(models, trace, kw, pol))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shared_trace_matches_jax_engine(runs, name):
    """Tokens, per-step scheduler state and counters equal the JAX
    engine's; with the cache on the trace hits (and at 24 pages copies a
    boundary page, at 7 preempts and refuses to swap shared pages)."""
    n_pages, mode, prefix = CONFIGS[name]
    jrun, trun = runs(name)
    assert_same_run(jrun, trun)
    _, stats, _, check = trun
    assert check.steps == stats["decode_steps"] > 0
    assert stats["free_pages_after"] == n_pages
    if not prefix:
        assert stats["prefix_hits"] == stats["prefix_misses"] == 0
        return
    assert stats["prefix_hits"] >= 1 and stats["prefix_shared_pages"] >= 1
    if n_pages >= 24:
        assert stats["prefix_misses"] <= 1 and stats["cow_copies"] >= 1
        assert stats["preemptions"] == 0
    else:
        assert stats["preemptions"] > 0
        assert stats["swap_refusals"] >= 1
        assert stats["preempt_requeue"] >= stats["swap_refusals"]


@pytest.mark.parametrize("pool", ["pool24-requeue", "pool7-swap"])
def test_prefix_cache_on_equals_off(runs, pool):
    """The cache changes which pages back a prompt, never a token."""
    on, off = runs(f"{pool}-on")[1][0], runs(f"{pool}-off")[1][0]
    assert set(on) == set(off)
    for rid in on:
        np.testing.assert_array_equal(on[rid], off[rid])


def test_prefix_hits_skip_prefill_chunks(runs):
    """Hits re-run only the tails: fewer chunk rows, never more chunks."""
    on = runs("pool24-requeue-on")[1][1]
    off = runs("pool24-requeue-off")[1][1]
    assert on["prefix_hit_tokens"] > 0
    assert on["prefill_chunks"] <= off["prefill_chunks"]


# ----------------------------------------------------------------------
# without an engine
# ----------------------------------------------------------------------

class _NaiveIndex:
    """tests/test_prefix.py's reference model: one dict entry per
    (prefix tuple) node."""

    def __init__(self, quantum, page_size):
        self.q, self.ppn = quantum, quantum // page_size
        self.nodes = {}

    def insert(self, tokens, pages):
        for d in range(len(tokens) // self.q):
            key = tuple(tokens[:(d + 1) * self.q])
            self.nodes.setdefault(
                key, tuple(pages[d * self.ppn:(d + 1) * self.ppn]))

    def match(self, tokens):
        pages, n = [], 0
        for d in range(len(tokens) // self.q):
            key = tuple(tokens[:(d + 1) * self.q])
            if key not in self.nodes:
                break
            pages.extend(self.nodes[key])
            n += self.q
        return n, pages

    def invalidate(self, dead):
        dead = set(dead)
        direct = {k for k, v in self.nodes.items() if dead & set(v)}
        self.nodes = {k: v for k, v in self.nodes.items()
                      if not any(k[:len(r)] == r for r in direct)}


def _run_index_script(quantum, page_size, ops):
    """tests/test_prefix.py::_run_index_script on the port's index, beside
    the naive model and the JAX index: identical matches, indexed pages,
    node counts and drops after every operation."""
    ix = paging.PrefixIndex(quantum=quantum, page_size=page_size)
    jx = jpaging.PrefixIndex(quantum=quantum, page_size=page_size)
    naive = _NaiveIndex(quantum, page_size)
    ppn = quantum // page_size
    next_page = 0
    for op_i, seed in ops:
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, 3, (int(rng.integers(1, 4 * quantum)),))
        op = ("insert", "match", "invalidate")[op_i % 3]
        if op == "insert":
            depth = len(toks) // quantum
            pages = list(range(next_page, next_page + depth * ppn))
            next_page += len(pages)
            assert ix.insert(toks, pages, scales=seed) == \
                jx.insert(toks, pages, scales=seed)
            naive.insert(toks, pages)
        elif op == "invalidate":
            dead = [int(rng.integers(0, max(next_page, 1)))]
            assert ix.invalidate(dead) == jx.invalidate(dead)
            naive.invalidate(dead)
        got = ix.match(toks)
        assert got == jx.match(toks)
        assert got[:2] == naive.match(toks)
        assert ix.indexed_pages == jx.indexed_pages
        assert len(ix.indexed_pages) == len(
            {p for v in naive.nodes.values() for p in v})
        assert ix.n_nodes == jx.n_nodes == len(naive.nodes)


@pytest.mark.parametrize("seed", range(12))
def test_index_matches_naive_model(seed):
    rng = np.random.default_rng(seed)
    quantum, page_size = (4, 4) if seed % 2 else (8, 4)
    ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 10 ** 6)))
           for _ in range(40)]
    _run_index_script(quantum, page_size, ops)


def test_segment_hash_is_the_reference_hash():
    rng = np.random.default_rng(3)
    for n in (1, 2, 8, 33):
        toks = rng.integers(0, 50_000, (n,))
        assert paging._segment_hash(toks) == jpaging._segment_hash(toks)


def test_hash_collisions_never_false_match(monkeypatch):
    """Every segment collides; lookups still resolve by exact tokens."""
    monkeypatch.setattr(paging, "_segment_hash", lambda toks: 17)
    ix = paging.PrefixIndex(quantum=4, page_size=4)
    t = lambda *a: np.asarray(a)
    ix.insert(t(1, 2, 3, 4), [0], scales="A")
    ix.insert(t(4, 3, 2, 1), [1], scales="B")
    ix.insert(t(1, 2, 3, 4, 9, 9, 9, 9), [0, 2], scales="C")
    assert ix.match(t(4, 3, 2, 1)) == (4, [1], "B")
    assert ix.match(t(1, 2, 3, 4, 9, 9, 9, 9)) == (8, [0, 2], "C")
    assert ix.match(t(5, 5, 5, 5))[0] == 0
    assert ix.invalidate([0]) == 2 and ix.match(t(1, 2, 3, 4))[0] == 0


def test_copy_page_and_adopt_scales():
    """Copy-on-write duplicates all four planes of one page, and nothing
    else; scale adoption sets one slot's scales."""
    cc = TCC.sparq_cache(TCfg.opt5(signed=True))
    st = paging.PagedCacheStore.init(2, 5, PS, 3, 2, 8, cc, "cpu")
    torch.manual_seed(1)
    for pool in st._pools():
        pool.copy_(torch.randint(-128, 128, pool.shape, dtype=torch.int8))
    before = [p.clone() for p in st._pools()]
    paging.copy_page(st, 3, 1)
    for pool, old in zip(st._pools(), before):
        assert torch.equal(pool[1], old[3])
        keep = [i for i in range(pool.shape[0]) if i != 1]
        assert torch.equal(pool[keep], old[keep])
    paging.adopt_prefix_scales(st, 1, torch.tensor(0.5), torch.tensor(0.25))
    assert st.k_scale.tolist() == [0.0, 0.5]
    assert st.v_scale.tolist() == [0.0, 0.25]
