"""Port parity, the async front end (`repro_torch.launch.frontend`) and the
paged engine's live mailboxes, on the reduced tinyllama in f32 on the CPU.

The reference's single-device tests (tests/test_frontend.py) on the port's
engine:
  * streamed tokens equal a synchronous `engine.run` over the same
    requests (a8w8 and 5opt KV codecs, chunked prefill, the prefix cache,
    requeue and swap preemption under a tight pool, arrivals spread over
    wall time), every step under the reference's `InvariantChecker`;
  * events are ordered and exactly one is final;
  * cancellation conserves pages: mid-prefill (the prefill job and its
    pages), mid-decode (shared prefix pages released by refcount), and a
    queued request never admits;
  * `reset_stats()` draws the warm-up/measure boundary.
The two TP rows of the reference file wait for tensor parallelism.

Against the JAX package: the port's streamed tokens for a poisson trace
equal the JAX engine's `run` on the same weights (through `interop`);
`arrival_times`, `_pctl` and `slo_summary` equal JAX's; the registry
series names equal JAX's; and the CLI serves `--serve async` on the CPU.

Every wait that involves the engine thread is bounded (`bounded`,
`asyncio.wait_for`), so a stuck loop fails its test instead of the suite.
"""
import asyncio
import dataclasses
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.core.sparq import SparqConfig as JCfg
from repro.distributed.sharding import set_activation_spec
from repro.launch import frontend as jfrontend
from repro.launch import serve as jserve
from repro.models.cache import CacheConfig as JCC
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.launch import frontend
from repro_torch.launch.serve import (ContinuousBatchingEngine, Request,
                                      SchedulerPolicy, main)
from repro_torch.models.cache import CacheConfig
from repro_torch.models.model import Model as TModel
from test_torch_preempt import InvariantChecker

PS = 4
MAX_SEQ_LEN = 24
WAIT_S = 60.0                   # bound of any wait on the engine thread

CODECS = {"a8w8": dict(enabled=False, signed=True),
          "5opt": dict(bits=4, opts=5, signed=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small tensors (see
    tests/test_torch_preempt.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_activation_spec():
    """A training test earlier in the worker may leave the JAX model's
    activation spec set; the runs here are unsharded."""
    set_activation_spec(None)
    yield


def bounded(fn, timeout=WAIT_S):
    """fn() on a daemon thread, joined with a timeout: its result, or its
    exception re-raised; a run that outlives the bound fails the test."""
    box = {}

    def body():
        try:
            box["out"] = fn()
        except BaseException as e:              # re-raised below
            box["err"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"front end still running after {timeout} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.fixture(scope="module")
def tiny_lm():
    """The reduced tinyllama in f32: JAX weights and their interop copy."""
    jc = jcfg_reduced("tinyllama-1.1b").replace(dtype=jnp.float32,
                                                remat=False)
    tc = tcfg_reduced("tinyllama-1.1b").replace(dtype=torch.float32)
    jm = JModel(jc)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = TModel(tc, device="cpu")
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp)


def _cc(codec_name: str) -> CacheConfig:
    return dataclasses.replace(
        CacheConfig.sparq_cache(TCfg(**CODECS[codec_name])), attn_bk=PS)


def _engine_kw(policy_mode="requeue", n_pages=10, **kw):
    """The reference test file's engine: pages of 4, three slots, chunked
    prefill in 2-token segments with the prefix cache, a preempt policy."""
    kw.setdefault("prefill", "chunked")
    if kw["prefill"] == "chunked":
        kw.setdefault("chunk_size", 16)
        kw.setdefault("chunk_align", 4)
        kw.setdefault("chunk_seg", 2)
        kw.setdefault("prefix_cache", True)
    return dict(page_size=PS, n_pages=n_pages, max_active=3,
                max_seq_len=MAX_SEQ_LEN, **kw), \
        dict(preempt=policy_mode, victim="last_joined")


def _engine(tiny_lm, codec_name="5opt", policy_mode="requeue", n_pages=10,
            **kw):
    ekw, pkw = _engine_kw(policy_mode, n_pages, **kw)
    return ContinuousBatchingEngine(
        tiny_lm["tm"], _cc(codec_name), policy=SchedulerPolicy(**pkw),
        device="cpu", **ekw)


def _shared_trace(vocab, seed=7):
    """A shared 2-page preamble, ragged tails and one exact duplicate:
    prefix hits and copy-on-write while requests overlap in wall time."""
    rng = np.random.default_rng(seed)
    preamble = rng.integers(0, vocab, (8,))
    rows = []
    for i in range(4):
        tail = rng.integers(0, vocab,
                            (4 if i == 0 else int(rng.integers(1, 5)),))
        rows.append((np.concatenate([preamble, tail]),
                     int(rng.integers(6, 11)), 0.03 * i))
    rows.append((rows[0][0].copy(), 7, 0.05))    # duplicate of row 0
    return rows


def _drained_pool(eng):
    """After the run every page is back on the free list."""
    al = eng._debug_state["allocator"]
    al.assert_consistent()
    assert al.used_count == 0, "run left pages allocated"


# ----------------------------------------------------------------------
# streamed tokens == synchronous batch tokens
# ----------------------------------------------------------------------

@pytest.mark.parametrize("codec_name,policy_mode",
                         [("a8w8", "requeue"), ("a8w8", "swap"),
                          ("5opt", "requeue"), ("5opt", "swap")],
                         ids=["a8w8-requeue", "a8w8-swap",
                              "5opt-requeue", "5opt-swap"])
def test_streamed_tokens_match_batch(tiny_lm, codec_name, policy_mode):
    """play_trace over wall-clock arrivals streams exactly the tokens a
    synchronous engine.run gives for the same requests."""
    tp = tiny_lm["tp"]
    rows = _shared_trace(tiny_lm["tm"].cfg.vocab_size)
    eng = _engine(tiny_lm, codec_name, policy_mode)
    oracle, _ = eng.run(tp, [Request(t, g) for t, g, _ in rows])
    check = InvariantChecker(ps=PS)
    out, slo, stats = bounded(lambda: frontend.play_trace(
        eng, tp, rows, trace_hook=check))
    for i in range(len(rows)):
        np.testing.assert_array_equal(out[i], oracle[i])
        assert out[i].shape == (rows[i][1],)
    assert slo["requests"] == len(rows)
    assert stats["clock_mode"] == "wall"
    assert stats["cancelled"] == 0
    # one TTFT a request, one ITL sample a follow-on token
    assert slo["ttft"]["n"] == len(rows)
    assert slo["itl"]["n"] == sum(g - 1 for _, g, _ in rows)
    assert slo["ttft"]["p50_ms"] > 0
    _drained_pool(eng)


def test_stream_events_are_ordered_and_final(tiny_lm):
    """Every stream's stamps are monotone with exactly one final event,
    and the async iterator ends cleanly."""
    tp = tiny_lm["tp"]
    rows = _shared_trace(tiny_lm["tm"].cfg.vocab_size)[:3]
    eng = _engine(tiny_lm)

    async def run():
        fe = frontend.AsyncFrontend(eng, tp)
        await asyncio.wait_for(fe.start(), WAIT_S)
        handles = [fe.submit(t, g, at=at) for t, g, at in rows]
        for h in handles:
            await asyncio.wait_for(h.drain(), WAIT_S)
        await asyncio.wait_for(fe.stop(), WAIT_S)
        return handles

    handles = bounded(lambda: asyncio.run(run()))
    for h, (_, g, _) in zip(handles, rows):
        assert len(h.events) == g
        assert [e.final for e in h.events] == [False] * (g - 1) + [True]
        ts = [e.t for e in h.events]
        assert ts == sorted(ts)
    _drained_pool(eng)


# ----------------------------------------------------------------------
# cancellation maps onto eviction and conserves pages
# ----------------------------------------------------------------------

def test_cancel_mid_prefill_conserves_pages(tiny_lm):
    """Cancelling a request whose chunked prefill is still streaming drops
    its prefill job and every granted page; the other request is
    untouched."""
    tp = tiny_lm["tp"]
    rng = np.random.default_rng(11)
    vocab = tiny_lm["tm"].cfg.vocab_size
    # rid 0 decodes from step 0; rid 1's 16-token prompt prefills in
    # 2-token segments while rid 0 decodes
    reqs = [Request(rng.integers(0, vocab, (4,)), 12, arrive_at=0),
            Request(rng.integers(0, vocab, (16,)), 8, arrive_at=1)]
    eng = _engine(tiny_lm, n_pages=12, chunk_size=4, prefix_cache=False)
    oracle, _ = eng.run(tp, [Request(reqs[0].tokens, reqs[0].gen)])
    check = InvariantChecker(ps=PS)
    state = {"cancelled_mid_prefill": False}

    def hook(snap):
        check(snap)
        if snap["prefilling"] and not state["cancelled_mid_prefill"]:
            state["cancelled_mid_prefill"] = True
            eng.cancel(1)

    results, stats = eng.run(tp, reqs, trace_hook=hook)
    assert state["cancelled_mid_prefill"], \
        "setup failed: rid 1 was never seen mid-prefill"
    assert stats["cancelled"] == 1
    np.testing.assert_array_equal(results[0], oracle[0])
    assert 1 not in results
    _drained_pool(eng)


def test_cancel_mid_decode_releases_shared_pages(tiny_lm):
    """Mid-decode cancellation through the async API: the victim's stream
    closes with its partial tokens (a prefix of the oracle's), the others
    stream to completion unchanged, and the victim's pages, shared prefix
    pages included, return to the pool."""
    tp = tiny_lm["tp"]
    rows = _shared_trace(tiny_lm["tm"].cfg.vocab_size)
    victim_i = 4                                  # the duplicate: shares
    toks_v, _, at_v = rows[victim_i]
    rows[victim_i] = (toks_v, 12, at_v)           # a long budget
    eng = _engine(tiny_lm)
    oracle, _ = eng.run(tp, [Request(t, g) for t, g, _ in rows])
    check = InvariantChecker(ps=PS)

    def hook(snap):
        check(snap)
        # pace the engine so the cancel lands while the victim decodes
        time.sleep(0.005)

    async def run():
        fe = frontend.AsyncFrontend(eng, tp, trace_hook=hook)
        await asyncio.wait_for(fe.start(), WAIT_S)
        handles = [fe.submit(t, g, at=at) for t, g, at in rows]
        victim = handles[victim_i]

        async def watch():
            async for _ in victim:
                if len(victim.events) >= 2:
                    victim.cancel()
        await asyncio.wait_for(watch(), WAIT_S)
        for i, h in enumerate(handles):
            if i != victim_i:
                await asyncio.wait_for(h.drain(), WAIT_S)
        _, stats = await asyncio.wait_for(fe.stop(), WAIT_S)
        return handles, stats

    handles, stats = bounded(lambda: asyncio.run(run()))
    victim = handles[victim_i]
    assert victim.cancelled
    assert stats["cancelled"] == 1
    assert 2 <= len(victim.events) < rows[victim_i][1]
    np.testing.assert_array_equal(victim.tokens,
                                  oracle[victim_i][:len(victim.events)])
    for i, h in enumerate(handles):
        if i != victim_i:
            np.testing.assert_array_equal(h.tokens, oracle[i])
    assert eng._live is None                      # the loop exited
    _drained_pool(eng)


def test_cancel_queued_request_never_admits(tiny_lm):
    """A request cancelled while still queued never touches a slot."""
    tp = tiny_lm["tp"]
    rng = np.random.default_rng(3)
    vocab = tiny_lm["tm"].cfg.vocab_size
    reqs = [Request(rng.integers(0, vocab, (4,)), 6, arrive_at=0),
            Request(rng.integers(0, vocab, (4,)), 6, arrive_at=100)]
    eng = _engine(tiny_lm, prefix_cache=False)
    seen = set()

    def hook(snap):
        for info in snap["slots"].values():
            seen.add(info["rid"])
        eng.cancel(1)                   # idempotent; rid 1 still queued

    results, stats = eng.run(tp, reqs, trace_hook=hook)
    assert stats["cancelled"] == 1
    assert seen == {0} and 1 not in results
    _drained_pool(eng)


# ----------------------------------------------------------------------
# reset_stats: the warm-up/measure boundary
# ----------------------------------------------------------------------

def test_warmup_does_not_pollute_measured_stats(tiny_lm):
    """A warmed serve-forever run reports only the timed trace: without
    the reset_stats() boundary the stats would keep the warm-up's prefix
    hits, decode steps and pool-peak watermark."""
    tp = tiny_lm["tp"]
    rng = np.random.default_rng(5)
    vocab = tiny_lm["tm"].cfg.vocab_size
    warm_prompt = rng.integers(0, vocab, (8,))
    warmup = [(warm_prompt, 6) for _ in range(4)]   # hits, a high peak
    rows = [(rng.integers(0, vocab, (8,)), 5, 0.0),
            (rng.integers(0, vocab, (8,)), 5, 0.8)]
    eng = _engine(tiny_lm, n_pages=16)
    out, slo, stats = bounded(lambda: frontend.play_trace(
        eng, tp, rows, warmup=warmup))
    assert stats["prefix_hits"] == 0
    assert stats["prefix_misses"] == 2
    # one request needs ceil((8 + 5 - 1) / 4) = 3 pages; the warm-up's
    # 4 concurrent requests held >= 8
    assert stats["peak_pages_used"] <= 4, \
        f"peak {stats['peak_pages_used']} inherited from the warm-up"
    assert stats["cancelled"] == 0
    assert stats["decode_steps"] <= sum(g for _, g, _ in rows)
    assert slo["ttft"]["n"] == len(rows)
    for i in range(len(rows)):
        assert out[i].shape == (rows[i][1],)
    _drained_pool(eng)


def test_metrics_scrape_during_replay(tiny_lm):
    """With `metrics_port=0`, a GET /metrics over 127.0.0.1 at the end of
    the trace (play_trace's `after_trace`) parses and counts one TTFT a
    request and one ITL a later token."""
    from repro_torch.obs import export
    rows = _shared_trace(tiny_lm["tm"].cfg.vocab_size)[:3]
    eng = _engine(tiny_lm)
    seen = {}

    async def scrape(server):
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       server.port)
        writer.write(b"GET /metrics HTTP/1.1\r\n\r\n")
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), WAIT_S)
        writer.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        seen["status"] = head.split(b"\r\n")[0]
        seen["parsed"] = export.parse_prometheus(body.decode())

    _, slo, _ = bounded(lambda: frontend.play_trace(
        eng, tiny_lm["tp"], rows, metrics_port=0, after_trace=scrape))
    assert seen["status"] == b"HTTP/1.1 200 OK"
    parsed = seen["parsed"]
    assert parsed[("frontend_ttft_seconds_count", "")] == len(rows)
    assert parsed[("frontend_itl_seconds_count", "")] == \
        sum(g - 1 for _, g, _ in rows) == slo["itl"]["n"]


def test_mailboxes_need_a_live_loop_and_wall_clock(tiny_lm):
    """submit() refuses without a live run; drain=False needs the wall
    clock; a bad clock mode raises."""
    eng = _engine(tiny_lm)
    eng._run_live.wait = lambda timeout=None: False   # do not wait 5 s
    with pytest.raises(RuntimeError, match="live run"):
        eng.submit(Request(np.arange(4), 3))
    with pytest.raises(ValueError, match="wall"):
        eng.run(tiny_lm["tp"], [], drain=False)
    with pytest.raises(ValueError, match="clock_mode"):
        eng.run(tiny_lm["tp"], [], clock_mode="tick")


# ----------------------------------------------------------------------
# TP = 2: streamed tokens match the sync engine on a sharded pool
# ----------------------------------------------------------------------

def test_tp2_streamed_matches_sync(tiny_lm):
    """The reference's test_tp2_streamed_matches_sync: the async front end
    over a TP 2 engine (each KV head on its own shard, both on the CPU)
    streams exactly the tokens the synchronous sharded run gives, which
    are the unsharded engine's; the pool drains."""
    from repro_torch.launch.mesh import make_tp_mesh
    tp = tiny_lm["tp"]
    rows = _shared_trace(tiny_lm["tm"].cfg.vocab_size)[:3]
    reqs = [Request(t, g) for t, g, _ in rows]
    eng = _engine(tiny_lm, mesh=make_tp_mesh(2, devices=["cpu"] * 2))
    oracle, ostats = eng.run(tp, reqs)
    assert ostats["tp"] == 2
    unsharded, _ = _engine(tiny_lm).run(tp, reqs)
    check = InvariantChecker(ps=PS)
    out, slo, stats = bounded(lambda: frontend.play_trace(
        eng, tp, rows, trace_hook=check))
    for i in range(len(rows)):
        np.testing.assert_array_equal(out[i], oracle[i])
        np.testing.assert_array_equal(oracle[i], unsharded[i])
    assert stats["tp"] == 2 and slo["requests"] == len(rows)
    assert check.steps == stats["decode_steps"] > 0
    _drained_pool(eng)


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_poisson(tiny_lm):
    """The JAX engine (the same configuration, 5opt KV, requeue) and its
    synchronous run over the poisson trace's requests."""
    jm, jp = tiny_lm["jm"], tiny_lm["jp"]
    ekw, pkw = _engine_kw()
    jeng = jserve.ContinuousBatchingEngine(
        jm, dataclasses.replace(JCC.sparq_cache(JCfg(**CODECS["5opt"]),
                                                impl="reference"),
                                attn_bk=PS),
        policy=jserve.SchedulerPolicy(**pkw), **ekw)
    rng = np.random.default_rng(2)
    vocab = jm.cfg.vocab_size
    ats = frontend.arrival_times("poisson", 5, 16.0,
                                 rng=np.random.default_rng(0))
    rows = [(rng.integers(0, vocab, (int(rng.integers(3, 12)),)),
             int(rng.integers(4, 9)), at) for at in ats]
    jres, _ = jeng.run(jp, [jserve.Request(t, g) for t, g, _ in rows])
    return jeng, rows, jres


def test_poisson_stream_equals_jax_engine_run(tiny_lm, jax_poisson):
    """The port's streamed tokens over a poisson trace (16 req/s) equal
    the JAX engine's synchronous run over the same requests."""
    _, rows, jres = jax_poisson
    eng = _engine(tiny_lm)
    out, slo, stats = bounded(lambda: frontend.play_trace(
        eng, tiny_lm["tp"], rows))
    assert set(out) == set(jres) == set(range(len(rows)))
    for i in out:
        np.testing.assert_array_equal(out[i], np.asarray(jres[i]),
                                      err_msg=f"request {i}")
    assert slo["ttft"]["n"] == len(rows)
    _drained_pool(eng)


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_arrival_times_equal_jax(kind):
    for seed, n, rate in ((0, 8, 16.0), (3, 13, 2.5)):
        got = frontend.arrival_times(kind, n, rate,
                                     rng=np.random.default_rng(seed))
        want = jfrontend.arrival_times(kind, n, rate,
                                       rng=np.random.default_rng(seed))
        assert [float(x) for x in got] == [float(x) for x in want]
    assert frontend.arrival_times("bursty", 6, 8.0, burst=3) == \
        jfrontend.arrival_times("bursty", 6, 8.0, burst=3)
    with pytest.raises(ValueError):
        frontend.arrival_times(kind, 3, 0.0)
    with pytest.raises(ValueError):
        frontend.arrival_times("uniform", 3, 1.0)


def test_slo_summary_and_pctl_match_jax():
    """The same event stamps through both packages' `slo_summary` and
    `_pctl`, with scheduled and unscheduled arrivals and an empty
    stream."""
    rng = np.random.default_rng(9)
    streams = []
    for i in range(6):
        t0 = float(rng.uniform(0, 1))
        stamps = t0 + np.cumsum(rng.uniform(0.001, 0.05, int(
            rng.integers(0, 7))))
        streams.append(types.SimpleNamespace(
            events=[frontend.TokenEvent(int(k), float(t), False)
                    for k, t in enumerate(stamps)],
            arrive_t=None if i % 3 == 0 else float(rng.uniform(0, 0.5)),
            submit_t=float(rng.uniform(0, 0.5))))
    assert frontend.slo_summary(streams, 10.0) == \
        jfrontend.slo_summary(streams, 10.0)
    for xs in ([], [0.1], list(rng.uniform(0, 1, 37))):
        assert frontend._pctl(xs) == jfrontend._pctl(xs)


def _series_names(reg):
    return sorted((m.name, m.kind, tuple(m.labelnames))
                  for m in reg.collect())


def test_registry_series_names_match_jax(tiny_lm, jax_poisson):
    """After a run, with a front end attached, the port's registry holds
    the JAX engine's metrics: names, kinds and label names."""
    jeng = jax_poisson[0]
    jfrontend.AsyncFrontend(jeng, tiny_lm["jp"])
    eng = _engine(tiny_lm)
    eng.run(tiny_lm["tp"], [Request(np.arange(5), 3)])
    frontend.AsyncFrontend(eng, tiny_lm["tp"])
    names = _series_names(eng.telemetry.registry)
    assert names == _series_names(jeng.telemetry.registry)
    assert ("frontend_ttft_seconds", "histogram", ()) in names


def test_cli_serves_async_on_cpu(capsys):
    """`--serve async --arrival-trace bursty --metrics-port 0` through the
    CLI on the CPU; the async front end also drives a `--tp 2` engine,
    and a tp that splits a head group raises."""
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "3",
            "--prompt-len", "8", "--gen", "4", "--page-size", "4",
            "--chunk-size", "16", "--chunk-align", "4", "--calibrate", "1",
            "--prequantize", "--engine", "paged", "--prefill", "chunked",
            "--kv-cache", "sparq", "--sparq", "5opt", "--device", "cpu",
            "--serve", "async", "--arrival-trace", "bursty",
            "--metrics-port", "0"]
    stats = bounded(lambda: main(argv))
    assert stats["clock_mode"] == "wall"
    assert stats["slo"]["requests"] == 3 and stats["slo"]["ttft"]["n"] == 3
    assert all(len(t) == 4 for t in stats["tokens"].values())
    assert stats["free_pages_after"] == stats["pool_pages"]
    assert "metrics: http://127.0.0.1:" in capsys.readouterr().out
    stats = bounded(lambda: main(argv[:-2] + ["--tp", "2"]))
    assert stats["tp"] == 2 and stats["slo"]["requests"] == 3
    assert all(len(t) == 4 for t in stats["tokens"].values())
    with pytest.raises(ValueError, match="must divide n_kv_heads"):
        main(argv[:-6] + ["--tp", "4"])
    with pytest.raises(SystemExit):
        main(argv[:-6] + ["--arrival-trace", "poisson"])  # needs async
