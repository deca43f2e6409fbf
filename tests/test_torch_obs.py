"""Port parity for the telemetry layer (`repro_torch.obs`, the port's own
copy of `repro.obs`) and its use in the paged engine.

Without an engine: one scenario of counters, gauges, histograms and spans
goes through both packages; the Prometheus text is byte-equal, it parses
back, and the trace events are equal. The reference's checks of
tests/test_obs.py on registry semantics, the exposition and the span
schema hold on the port's copy.

With the engine: the reference's `runs` workload of tests/test_obs.py
(reduced tinyllama in f32, pages of 4, three slots, chunked prefill with
the prefix cache, requeue on a shared preamble and swap on private
prompts) runs on the port's engine with the JAX weights and on the JAX
engine, both traced. Tokens, every counter and gauge series (the time
counters aside), every histogram's counts, the stats key set and each
request's span sequence (timestamps aside) are equal; the port's tokens
with tracing on equal those with telemetry off, and its stats are
registry reads.
"""
import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.core.sparq import SparqConfig as JCfg
from repro.distributed.sharding import set_activation_spec
from repro.launch import serve as jserve
from repro.models.cache import CacheConfig as JCC
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch import obs as tobs
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.launch import serve as tserve
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.model import Model as TModel
from repro_torch.obs import (EngineSpans, MetricsRegistry, Telemetry, Tracer,
                             export, summary_ms)

PS = 4
MAX_SEQ_LEN = 24
# stats keys of the port's engine that the reference's has not
PORT_ONLY_STATS = {"device", "decode_tokens", "free_pages_after"}


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
    activation spec set; the engines here run unsharded."""
    set_activation_spec(None)
    yield


# ----------------------------------------------------------------------
# the same scenario through both packages
# ----------------------------------------------------------------------

def _scenario(obs):
    """Every metric kind, labels, a reset and a span lifecycle with fixed
    host stamps, through one package's obs. Returns (registry, tracer)."""
    reg = obs.MetricsRegistry()
    reg.counter("requests_total", help="requests served").series().inc(3)
    c = reg.counter("tokens_total", help="tokens", labelnames=("kind",))
    c.inc(5, kind="prefill")
    c.inc(2.5, kind="decode")
    g = reg.gauge("pool_pages", help="pages in use", unit="pages").series()
    g.set(7)
    g.set_max(3)
    g.inc(0.25)
    h = reg.histogram("latency_seconds", help="lat", unit="seconds",
                      labelnames=("phase",))
    for v in (1e-6, 3e-5, 0.004, 0.5, 2.0, 1e3):
        h.observe(v, phase="decode")
    h.observe(0.1, phase="admit")
    fill = reg.histogram("fill", buckets=tuple(i / 10 for i in range(1, 11)))
    for v in (0.05, 0.3, 1.0):
        fill.observe(v)
    reg.counter("gone_total").series().inc(9)
    reg.get("gone_total").reset()
    tr = obs.Tracer()
    sp = obs.EngineSpans(tr)
    sp.run_begin(10.0)
    sp.submitted(0, 10.001)
    sp.submitted(1, 10.001)
    sp.admitted(0, 10.002, mode="chunked")
    sp.chunk(0, 10.002, 10.003, tokens=16)
    sp.first_token(0, 10.004)
    sp.token(0, 10.005)
    sp.preempted(0, 10.006, mode="swap")
    sp.swap(0, 10.006, 10.0065, "out", nbytes=1024)
    sp.resume_work(0, 10.007, 10.008, mode="swap")
    sp.resumed(0, 10.008)
    sp.admitted(1, 10.009, mode="chunked")
    sp.chunk(1, 10.009, 10.010, tokens=8)
    sp.decoding(1, 10.011)
    sp.finished(0, 10.012)
    sp.step(10.0, 10.013, phases=(("retire", 10.0, 10.001),
                                  ("decode", 10.001, 10.013)), active=2)
    sp.snapshot({"pages_in_use": 3, "free_pages": 7, "active": 1,
                 "queued": 0, "swapped": 0}, 10.013)
    sp.run_end(10.014)
    return reg, tr


def test_scenario_exports_equal_the_reference():
    jreg, jtr = _scenario(jobs)
    treg, ttr = _scenario(tobs)
    text = export.prometheus_text(treg)
    assert text == jobs.export.prometheus_text(jreg)
    assert export.parse_prometheus(text) == \
        jobs.export.parse_prometheus(text)
    assert json.dumps(treg.snapshot(), sort_keys=True) == \
        json.dumps(jreg.snapshot(), sort_keys=True)
    assert export.trace_json(ttr) == jobs.export.trace_json(jtr)
    assert summary_ms(treg.get("latency_seconds").series(phase="decode")) \
        == jobs.summary_ms(jreg.get("latency_seconds").series(
            phase="decode"))


def test_jsonl_writers_match_the_reference(tmp_path):
    jreg, jtr = _scenario(jobs)
    treg, ttr = _scenario(tobs)
    for name, tw, jw, tobj, jobj in (
            ("m", export.write_metrics_jsonl,
             jobs.export.write_metrics_jsonl, treg, jreg),
            ("e", export.write_events_jsonl,
             jobs.export.write_events_jsonl, ttr, jtr),
            ("p", export.write_prometheus, jobs.export.write_prometheus,
             treg, jreg),
            ("t", export.write_trace, jobs.export.write_trace, ttr, jtr)):
        tw(tobj, tmp_path / f"{name}.torch")
        jw(jobj, tmp_path / f"{name}.jax")
        assert (tmp_path / f"{name}.torch").read_bytes() == \
            (tmp_path / f"{name}.jax").read_bytes(), name


# ----------------------------------------------------------------------
# the reference's registry, exposition and span checks, on the port
# ----------------------------------------------------------------------

def test_counter_semantics():
    reg = MetricsRegistry()
    s = reg.counter("reqs_total", help="h").series()
    s.inc()
    s.inc(2.5)
    assert s.value() == 3.5
    with pytest.raises(ValueError):
        s.inc(-1)
    lc = reg.counter("tok_total", labelnames=("kind",))
    lc.inc(3, kind="a")
    lc.inc(4, kind="b")
    assert lc.value(kind="a") == 3 and lc.value(kind="b") == 4
    assert lc.total() == 7


def test_gauge_semantics():
    g = MetricsRegistry().gauge("pages").series()
    g.set(5)
    g.set_max(3)
    assert g.value() == 5
    g.set_max(9)
    assert g.value() == 9
    g.inc(2)
    g.dec(1)
    assert g.value() == 10


def test_histogram_semantics():
    reg = MetricsRegistry()
    s = reg.histogram("lat", buckets=(0.1, 1.0, 10.0)).series()
    raw = [0.05, 0.5, 0.5, 5.0, 50.0]
    for v in raw:
        s.observe(v)
    assert s.counts == [1, 2, 1, 1]
    assert s.cumulative_counts() == [1, 3, 4, 5]
    assert s.count == 5 and s.sum == pytest.approx(56.05)
    assert s.percentile(50) == float(np.percentile(np.asarray(raw), 50))
    assert s.mean() == pytest.approx(np.mean(raw))
    assert s.max() == 50.0
    with pytest.raises(ValueError):
        reg.histogram("bad", buckets=(1.0, 0.5))


def test_label_isolation_and_registration_errors():
    reg = MetricsRegistry()
    h = reg.histogram("phase_s", labelnames=("phase",))
    h.series(phase="admit").observe(1.0)
    assert h.series(phase="decode").count == 0
    with pytest.raises(ValueError):
        h.series(stage="admit")
    assert reg.histogram("phase_s", labelnames=("phase",)) is h
    with pytest.raises(TypeError):
        reg.counter("phase_s")
    with pytest.raises(ValueError):
        reg.histogram("phase_s", labelnames=("other",))


def test_reset_keeps_series_handles_alive():
    reg = MetricsRegistry()
    c = reg.counter("c").series()
    g = reg.gauge("g").series()
    h = reg.histogram("h").series()
    c.inc(3)
    g.set(7)
    h.observe(0.5)
    reg.reset()
    assert c.value() == 0 and g.value() == 0
    assert h.count == 0 and h.raw == [] and sum(h.counts) == 0
    assert reg.counter("c").series() is c
    c.inc()
    assert reg.counter("c").value() == 1


def test_summary_ms_empty_and_full():
    xs = [0.011, 0.002, 0.5, 0.033, 0.07]
    s = MetricsRegistry().histogram("ttft").series()
    for v in xs:
        s.observe(v)
    a = np.asarray(xs) * 1e3
    assert summary_ms(s) == {"p50_ms": float(np.percentile(a, 50)),
                             "p99_ms": float(np.percentile(a, 99)),
                             "mean_ms": float(a.mean()),
                             "max_ms": float(a.max()), "n": 5}
    assert summary_ms(MetricsRegistry().histogram("e").series())["n"] == 0


def test_prometheus_golden():
    reg = MetricsRegistry()
    reg.counter("requests_total", help="requests served").series().inc(3)
    c = reg.counter("tokens_total", help="tokens", labelnames=("kind",))
    c.inc(5, kind="prefill")
    c.inc(2, kind="decode")
    reg.gauge("pool_pages", help="pages in use").series().set(7)
    s = reg.histogram("latency_seconds", help="lat",
                      buckets=(0.1, 1.0)).series()
    for v in (0.05, 0.5, 5.0):
        s.observe(v)
    assert export.prometheus_text(reg) == (
        "# HELP requests_total requests served\n"
        "# TYPE requests_total counter\n"
        "requests_total 3\n"
        "# HELP tokens_total tokens\n"
        "# TYPE tokens_total counter\n"
        'tokens_total{kind="prefill"} 5\n'
        'tokens_total{kind="decode"} 2\n'
        "# HELP pool_pages pages in use\n"
        "# TYPE pool_pages gauge\n"
        "pool_pages 7\n"
        "# HELP latency_seconds lat\n"
        "# TYPE latency_seconds histogram\n"
        'latency_seconds_bucket{le="0.1"} 1\n'
        'latency_seconds_bucket{le="1"} 2\n'
        'latency_seconds_bucket{le="+Inf"} 3\n'
        "latency_seconds_sum 5.55\n"
        "latency_seconds_count 3\n")


def test_prometheus_parse_roundtrip():
    reg = MetricsRegistry()
    reg.counter("a_total", labelnames=("x",)).inc(2, x="v")
    reg.gauge("b").series().set(1.5)
    h = reg.histogram("c_seconds", buckets=(1.0,)).series()
    h.observe(0.5)
    h.observe(2.0)
    parsed = export.parse_prometheus(export.prometheus_text(reg))
    assert parsed[("a_total", 'x="v"')] == 2
    assert parsed[("b", "")] == 1.5
    assert parsed[("c_seconds_bucket", 'le="1"')] == 1
    assert parsed[("c_seconds_bucket", 'le="+Inf"')] == 2
    assert parsed[("c_seconds_sum", "")] == 2.5
    assert parsed[("c_seconds_count", "")] == 2


def test_metrics_server_scrape():
    reg = MetricsRegistry()
    reg.counter("scraped_total", help="h").series().inc(3)

    async def go():
        srv = await export.MetricsServer(reg).start()
        try:
            async def fetch(path):
                r, w = await asyncio.open_connection("127.0.0.1", srv.port)
                w.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
                await w.drain()
                data = await r.read()
                w.close()
                return data
            return await fetch("/metrics"), await fetch("/other")
        finally:
            await srv.stop()

    ok, notfound = asyncio.run(go())
    head, _, body = ok.partition(b"\r\n\r\n")
    assert b"200 OK" in head and b"version=0.0.4" in head
    assert export.parse_prometheus(body.decode())[("scraped_total", "")] == 3
    assert b"404" in notfound


def check_balanced(events):
    """Every B has its E on its tid, X events have durations >= 0, no
    span is left open (tests/test_obs.py::_check_balanced)."""
    open_spans = {}
    for e in events:
        assert e["ph"] in ("B", "E", "X", "i", "C", "M")
        if e["ph"] != "M":
            assert e["ts"] >= 0
        if e["ph"] == "B":
            open_spans.setdefault(e["tid"], []).append(e["name"])
        elif e["ph"] == "E":
            assert open_spans.get(e["tid"]), "E without matching B"
            open_spans[e["tid"]].pop()
        elif e["ph"] == "X":
            assert e["dur"] >= 0
    leftovers = {k: v for k, v in open_spans.items() if v}
    assert not leftovers, f"unclosed spans: {leftovers}"


def test_span_lifecycle_balances():
    _, tr = _scenario(tobs)
    evs = tr.events()
    json.dumps(evs)
    check_balanced(evs)
    x_names = [e["name"] for e in evs if e["ph"] == "X"]
    assert "prefill_chunk[0]" in x_names and "swap_out" in x_names
    assert "resume" in x_names and "step[0]" in x_names
    inames = [e["name"] for e in evs if e["ph"] == "i"]
    assert inames.count("first_token") == 1 and "finished" in inames
    assert {e["name"] for e in evs if e["ph"] == "C"} == {"pool", "load"}


def test_run_end_closes_stragglers_and_spans_noop_without_tracer():
    tr = Tracer()
    sp = EngineSpans(tr)
    sp.run_begin(0.0)
    sp.submitted(0, 0.001)
    sp.admitted(1, 0.002)
    sp.run_end(0.01)
    check_balanced(tr.events())
    off = EngineSpans(None)
    assert not off.on and sp.on
    for call in (lambda: off.run_begin(), lambda: off.submitted(0),
                 lambda: off.chunk(0, 0.0, 1.0), lambda: off.step(0.0, 1.0),
                 lambda: off.finished(0), lambda: off.run_end()):
        call()
    tel = Telemetry.metrics_only()
    assert tel.step_timing and tel.tracer is None and not tel.spans.on
    assert Telemetry().step_timing is False
    assert Telemetry.tracing().spans.on


# ----------------------------------------------------------------------
# the engine: the reference's `runs` workload on both engines
# ----------------------------------------------------------------------

def _mk_reqs(vocab, seed=7, shared=True):
    """tests/test_obs.py::_mk_reqs, as (tokens, gen) pairs."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (8,))
    reqs = []
    for _ in range(5):
        tail = rng.integers(0, vocab, (int(rng.integers(2, 6)),))
        toks = np.concatenate([pre, tail]) if shared \
            else rng.integers(0, vocab, (8 + tail.size,))
        reqs.append((toks.astype(np.int32), int(rng.integers(6, 11))))
    return reqs


def _engine_kw(mode):
    return dict(page_size=PS, n_pages=10 if mode == "requeue" else 8,
                max_active=3, max_seq_len=MAX_SEQ_LEN,
                prefill="chunked", chunk_size=16, chunk_align=4,
                chunk_seg=2, prefix_cache=True)


@pytest.fixture(scope="module")
def runs():
    """Per preemption mode: the JAX engine traced (streaming its tokens,
    so that it records token instants, as the port's engine does with
    its one copy a step), the port's engine traced twice, and the port's
    engine with telemetry off."""
    jc = jcfg_reduced("tinyllama-1.1b").replace(dtype=jnp.float32,
                                                remat=False)
    tc = tcfg_reduced("tinyllama-1.1b").replace(dtype=torch.float32)
    jm, tm = JModel(jc), TModel(tc, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    jcc = dataclasses.replace(JCC.sparq_cache(JCfg.opt5(signed=True),
                                              impl="reference"), attn_bk=PS)
    tcc = dataclasses.replace(TCC.sparq_cache(TCfg.opt5(signed=True)),
                              attn_bk=PS)
    out = {}
    for mode in ("requeue", "swap"):
        pairs = _mk_reqs(jc.vocab_size, shared=(mode == "requeue"))
        policy = dict(preempt=mode, victim="last_joined")
        jtel = jobs.Telemetry.tracing()
        jeng = jserve.ContinuousBatchingEngine(
            jm, jcc, policy=jserve.SchedulerPolicy(**policy),
            telemetry=jtel, **_engine_kw(mode))
        jres, jstats = jeng.run(jp, [jserve.Request(t, g) for t, g in pairs],
                                emit=lambda *a: None)
        tel = Telemetry.tracing()

        def teng(t):
            return tserve.ContinuousBatchingEngine(
                tm, tcc, policy=tserve.SchedulerPolicy(**policy),
                device="cpu", telemetry=t, **_engine_kw(mode))
        reqs = [tserve.Request(t, g) for t, g in pairs]
        eng = teng(tel)
        _, stats_first = eng.run(tp, reqs)
        res, stats = eng.run(tp, reqs)
        res0, stats0 = teng(None).run(tp, reqs)
        out[mode] = dict(jtel=jtel, jres=jres, jstats=jstats, tel=tel,
                         res=res, stats=stats, stats_first=stats_first,
                         res0=res0, stats0=stats0)
    return out


def _series(reg):
    """{(name, labels): (kind, unit, value)} of every series; histograms
    give their count, and their bucket counts where they hold no time."""
    out = {}
    for m in reg.collect():
        for labels, s in m.samples():
            key = (m.name, tuple(sorted(labels.items())))
            if m.kind == "histogram":
                v = (s.count,) if m.unit == "seconds" else \
                    (s.count, tuple(s.counts), tuple(s.raw))
            else:
                v = s.value()
            out[key] = (m.kind, m.unit, m.help, v)
    return out


def test_tokens_equal_jax_and_tracing_off(runs):
    for mode, r in runs.items():
        assert set(r["res"]) == set(r["jres"]) == set(r["res0"])
        for rid in r["jres"]:
            np.testing.assert_array_equal(r["res"][rid], r["jres"][rid])
            np.testing.assert_array_equal(r["res"][rid], r["res0"][rid])
        assert r["stats"]["preemptions"] >= 1, mode
        if mode == "swap":
            assert r["stats"]["preempt_swap"] >= 1
        else:
            assert r["stats"]["prefix_hits"] >= 1


def test_registry_series_equal_jax(runs):
    """Every metric, its help, unit and kind equal the reference's; every
    counter and gauge series is equal but the time counters (unit
    seconds); every histogram's count is equal, and the fill histogram's
    buckets and samples too."""
    for mode, r in runs.items():
        got, want = _series(r["tel"].registry), _series(r["jtel"].registry)
        assert set(got) == set(want), mode
        for key in want:
            kind, unit, help_, v = want[key]
            assert got[key][:3] == (kind, unit, help_), key
            if kind == "counter" and unit == "seconds":
                continue
            assert got[key][3] == v, (mode, key, got[key][3], v)


def test_stats_keys_and_values_match_registry(runs):
    for mode, r in runs.items():
        stats, reg = r["stats"], r["tel"].registry
        assert set(stats) == set(r["stats0"])
        assert set(stats) - PORT_ONLY_STATS == set(r["jstats"]), mode
        assert stats["decode_steps"] == \
            reg.get("engine_decode_steps_total").total()
        assert stats["decode_tokens"] == \
            reg.get("engine_decode_tokens_total").total()
        assert stats["prefill_chunks"] == \
            reg.get("engine_prefill_chunks_total").total()
        assert stats["prefill_s"] == \
            reg.get("engine_prefill_seconds_total").total()
        assert stats["resume_s"] == \
            reg.get("engine_resume_seconds_total").total()
        for m in ("requeue", "swap"):
            assert stats[f"preempt_{m}"] == \
                reg.get("engine_preemptions_total").value(mode=m)
        assert stats["resumes"] == reg.get("engine_resumes_total").total()
        assert stats["replay_steps"] == \
            reg.get("engine_replay_steps_total").total()
        assert stats["cancelled"] == \
            reg.get("engine_cancelled_total").total() == 0
        for d in ("out", "in"):
            assert stats[f"swap_bytes_{d}"] == \
                reg.get("swap_bytes_total").value(dir=d)
        assert stats["swap_peak_bytes"] == \
            reg.get("swap_peak_bytes").value()
        assert stats["peak_pages_used"] == \
            reg.get("pool_pages_peak").value()
        assert stats["prefix_hits"] == \
            reg.get("prefix_cache_hits_total").total()
        fill = reg.get("prefill_chunk_fill_ratio").series()
        assert fill.count == stats["prefill_chunks"]
        assert all(0 < v <= 1.0 for v in fill.raw)
        # the counts a run shares with the reference's stats
        for k in ("decode_steps", "prefill_chunks", "preemptions",
                  "preempt_requeue", "preempt_swap", "resumes",
                  "replay_steps", "swap_bytes_out", "swap_bytes_in",
                  "swap_peak_bytes", "peak_pages_used", "pool_slots",
                  "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                  "prefix_shared_pages", "cow_copies", "swap_refusals",
                  "total_tokens_served", "cancelled", "clock_mode", "tp"):
            assert stats[k] == r["jstats"][k], (mode, k)


def test_second_run_reports_fresh_stats(runs):
    for r in runs.values():
        for k in ("decode_steps", "prefill_chunks", "preemptions",
                  "resumes", "swap_bytes_out", "total_tokens_served"):
            assert r["stats"][k] == r["stats_first"][k], k


def _request_spans(events):
    """{tid: [(ph, name, args)]} of the request tracks, timestamps and
    durations left out."""
    out = {}
    for e in events:
        if e["tid"] == 0:
            continue
        out.setdefault(e["tid"], []).append(
            (e["ph"], e.get("name"), json.dumps(e.get("args"),
                                                sort_keys=True)))
    return out


def test_span_sequences_equal_jax(runs):
    for mode, r in runs.items():
        evs = export.trace_json(r["tel"].tracer)["traceEvents"]
        jevs = jobs.export.trace_json(r["jtel"].tracer)["traceEvents"]
        check_balanced(evs)
        got, want = _request_spans(evs), _request_spans(jevs)
        assert set(got) == set(want) == {rid + 1 for rid in r["res"]}
        for tid in want:
            assert got[tid] == want[tid], (mode, tid)
        names = lambda es: [e["name"] for e in es if e["tid"] == 0
                            and e["ph"] != "M"]
        steps = [n for n in names(evs) if n.startswith("step[")]
        assert steps[0] == "step[0]"
        assert len(steps) == len([n for n in names(jevs)
                                  if n.startswith("step[")])
        assert names(evs).count("run_begin") == 1
        assert {"retire", "admit", "prefill", "decode"} <= set(names(evs))


def test_engine_prometheus_dump_matches_stats(runs):
    for mode, r in runs.items():
        parsed = export.parse_prometheus(
            export.prometheus_text(r["tel"].registry))
        assert parsed[("engine_decode_steps_total", "")] == \
            r["stats"]["decode_steps"]
        assert parsed[("engine_step_phase_seconds_count",
                       'phase="decode"')] == r["stats"]["decode_steps"]
        assert parsed[("swap_bytes_total", 'dir="out"')] == \
            r["stats"]["swap_bytes_out"]


def test_cli_writes_and_parses_metrics_and_trace(tmp_path):
    """`--metrics-dump` and `--trace-out` on the CPU, on an oversubscribed
    pool with swap and the prefix cache: the dump parses back to the
    stats dict's counts and the trace balances, a track a request."""
    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    stats = tserve.main([
        "--arch", "tinyllama-1.1b", "--reduced", "--batch", "3",
        "--prompt-len", "12", "--gen", "4", "--page-size", "4",
        "--chunk-size", "16", "--chunk-align", "4", "--calibrate", "1",
        "--engine", "paged", "--prefill", "chunked", "--device", "cpu",
        "--preempt", "swap", "--oversubscribe", "0.5", "--prefix-cache",
        "--metrics-dump", str(prom), "--trace-out", str(trace)])
    parsed = export.parse_prometheus(prom.read_text())
    for name, key in (("engine_decode_steps_total", "decode_steps"),
                      ("engine_prefill_chunks_total", "prefill_chunks"),
                      ("engine_resumes_total", "resumes"),
                      ("prefix_cache_misses_total", "prefix_misses")):
        assert parsed[(name, "")] == stats[key], name
    assert parsed[("pool_pages_peak", "")] == stats["peak_pages_used"]
    assert parsed[("engine_preemptions_total", 'mode="swap"')] == \
        stats["preempt_swap"]
    blob = json.loads(trace.read_text())
    assert set(blob) == {"traceEvents", "displayTimeUnit"}
    check_balanced(blob["traceEvents"])
    assert {e["tid"] for e in blob["traceEvents"] if e["ph"] == "B"} == \
        {1, 2, 3}
    with pytest.raises(SystemExit):       # the scan engine has no registry
        tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                     "cpu", "--metrics-dump", str(prom)])


def test_swap_store_mirrors_its_counters_into_the_registry():
    """`SwapStore(registry=...)`: swap_bytes_total{dir}, the resident and
    peak gauges follow put / pop / discard, and `reset_counters` after
    `registry.reset()` restarts both views at the current residency."""
    from repro_torch.models import paging
    from repro_torch.models.cache import CacheConfig
    st = paging.PagedCacheStore.init(
        2, 4, 4, 3, 1, 4, CacheConfig.sparq_cache(TCfg.opt5(signed=True)),
        "cpu")
    reg = MetricsRegistry()
    swap = paging.SwapStore(registry=reg)
    g = paging.gather_slot_pages(st, 0, torch.tensor([3, 1]))
    n = swap.put(0, [g], pos=6)
    swap.put(1, [g], pos=2)
    swap.pop(0)
    c = reg.get("swap_bytes_total")
    assert c.value(dir="out") == swap.bytes_out == 2 * n
    assert c.value(dir="in") == swap.bytes_in == n
    assert reg.get("swap_peak_bytes").value() == swap.peak == 2 * n
    assert reg.get("swap_resident_bytes").value() == swap.resident_bytes == n
    reg.reset()
    swap.reset_counters()
    assert swap.bytes_out == swap.bytes_in == 0 and swap.peak == n
    assert reg.get("swap_peak_bytes").value() == n
    assert swap.discard(1) == n
    assert reg.get("swap_resident_bytes").value() == 0
    assert c.value(dir="in") == 0
