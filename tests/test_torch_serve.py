"""Port parity, the slice end to end: the port's paged chunked-prefill
engine against `repro.launch.serve.ContinuousBatchingEngine
(prefill="chunked")` on the ragged, staggered-arrival trace of
tests/test_prefill.py.

Both engines get the same weights (through `interop`), the same numpy
prompts and the same calibrated activation scales, and run in f32. With
static scales every request's greedy tokens are a function of (prompt,
seg) alone, so they must be equal; the host scheduler is the same
algorithm, so the page allocator's trace must be identical step by step.
`chunk_seg` (8) is below the longest prompt (14), so multi-segment
prompts attend their earlier segments through packed pages (the chunked
attention's page stage).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.core.sparq import SparqConfig as JCfg
from repro.distributed.sharding import set_activation_spec
from repro.launch import serve as jserve
from repro.models.cache import CacheConfig as JCC
from repro.models.common import QuantCtx as JCtx
from repro.models.model import Model as JModel
from repro.models.quantize import quantize_params as jquantize
from repro_torch import interop
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.launch import serve as tserve
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.model import Model as TModel
from repro_torch.models.paging import PoolExhausted
from repro_torch.obs import export as obs_export

PS = 4
ENGINE_KW = dict(page_size=PS, n_pages=24, max_active=3, max_seq_len=24,
                 prefill="chunked", chunk_size=16, chunk_align=4,
                 chunk_seg=8)


@pytest.fixture(scope="module", autouse=True)
def _no_activation_spec():
    """The JAX model constrains activations to a module-global spec that
    a training test earlier in the same worker may have left set; both
    engines here run on one device, unsharded."""
    set_activation_spec(None)
    yield


@pytest.fixture(scope="module")
def models():
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
    return jm, jp, tm, jscales


def _trace(seed=7, vocab=512):
    """tests/test_prefill.py::_trace: ragged lengths, staggered arrivals."""
    rng = np.random.default_rng(seed)
    lens = [5, 11, 3, 9, 14, 6]
    gens = [7, 5, 9, 6, 4, 8]
    arr = [0, 0, 2, 3, 5, 7]
    return [(rng.integers(0, vocab, (L,)), g, a)
            for L, g, a in zip(lens, gens, arr)]


def _allocator_view(snap):
    return (snap["step"], tuple(snap["free_pages"]),
            {s: (v["rid"], tuple(v["pages"]), v["pos"], v["generated"])
             for s, v in snap["slots"].items()},
            snap["host_bt"].tolist(), tuple(snap["prefilling"]))


@pytest.mark.parametrize("codec,prequant", [("5opt", False), ("a8w8", True)])
def test_engine_tokens_and_allocator_trace_match(models, codec, prequant):
    jm, jp, tm, jscales = models
    kw = dict(enabled=False, signed=True) if codec == "a8w8" \
        else dict(bits=4, opts=5, signed=True)
    jcodec, tcodec = JCfg(**kw), TCfg(**kw)
    if prequant:
        jp = jquantize(jp)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    tscales = interop.scales_from_jax(jax.tree.map(np.asarray, jscales))
    trace = _trace()

    jsnaps, tsnaps = [], []
    jeng = jserve.ContinuousBatchingEngine(
        jm, JCC.sparq_cache(jcodec, impl="reference"),
        JCtx(mode="quantized", cfg=jcodec, impl="reference"), jscales,
        **ENGINE_KW)
    jres, jstats = jeng.run(
        jp, [jserve.Request(t, g, arrive_at=a) for t, g, a in trace],
        trace_hook=lambda s: jsnaps.append(_allocator_view(s)))
    teng = tserve.ContinuousBatchingEngine(
        tm, tserve.make_cache_config("sparq", tcodec),
        TCtx(mode="quantized", cfg=tcodec), tscales, device="cpu",
        **ENGINE_KW)
    tres, tstats = teng.run(
        tp, [tserve.Request(t, g, arrive_at=a) for t, g, a in trace],
        trace_hook=lambda s: tsnaps.append(_allocator_view(s)))

    assert set(jres) == set(tres) == set(range(len(trace)))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"request {rid}")
    assert tsnaps == jsnaps                      # allocator trace, per step
    assert tstats["decode_steps"] == jstats["decode_steps"]
    assert tstats["prefill_chunks"] == jstats["prefill_chunks"]
    assert tstats["peak_pages_used"] == jstats["peak_pages_used"]
    assert tstats["free_pages_after"] == ENGINE_KW["n_pages"]  # pool free
    assert tstats["cache_total_bytes"] == jstats["cache_total_bytes"]
    assert any(len(t) > ENGINE_KW["chunk_seg"] for t, _, _ in trace)


def test_engine_pool_exhaustion_raises(models):
    """Two short prompts admit, then their decode growth outruns the pool:
    with preemption not ported, the engine raises host-side."""
    _, _, tm, _ = models
    params = tm.init_params(0)
    eng = tserve.ContinuousBatchingEngine(
        tm, tserve.make_cache_config("sparq", TCfg.opt5(signed=True)),
        device="cpu", page_size=PS, n_pages=4, max_active=2,
        max_seq_len=24, prefill="chunked", chunk_size=16, chunk_align=4)
    with pytest.raises(PoolExhausted):
        eng.run(params, [tserve.Request(np.arange(2), 12),
                         tserve.Request(np.arange(2) + 5, 12)])


def test_cli_runs_on_cpu_and_rejects_unported_flags(capsys, tmp_path):
    base = ["--reduced", "--batch", "2", "--prompt-len", "12", "--gen", "3",
            "--page-size", "4", "--n-pages", "16", "--chunk-size", "16",
            "--chunk-align", "4", "--calibrate", "1", "--prequantize",
            "--device", "cpu", "--engine", "paged", "--prefill", "chunked"]
    stats = tserve.main(base)
    assert stats["decode_tokens"] == 2 * (3 - 1) and stats["device"] == "cpu"
    assert "sample:" in capsys.readouterr().out
    stats = tserve.main(base + ["--preempt", "swap", "--oversubscribe",
                                "0.5", "--prefix-cache"])
    assert stats["pool_pages"] == 4 and stats["prefix_misses"] == 2
    assert stats["decode_tokens"] == 2 * (3 - 1)
    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    stats = tserve.main(base + ["--metrics-dump", str(prom),
                                "--trace-out", str(trace)])
    parsed = obs_export.parse_prometheus(prom.read_text())
    assert parsed[("engine_decode_steps_total", "")] == stats["decode_steps"]
    events = json.loads(trace.read_text())["traceEvents"]
    assert {e["tid"] for e in events if e["ph"] == "B"} == {1, 2}
    # --tp 2 shards the reduced model's 2 KV heads over two CPU shards
    stats = tserve.main(base + ["--tp", "2"])
    assert stats["tp"] == 2 and stats["decode_tokens"] == 2 * (3 - 1)
    assert stats["pool_bytes_per_device"] < stats["cache_total_bytes"]
    assert "tp=2: " in capsys.readouterr().out
    with pytest.raises(ValueError, match="must divide n_kv_heads"):
        tserve.main(base + ["--tp", "4"])
    with pytest.raises(SystemExit):                 # the scan engine
        tserve.main(base[:-4] + ["--tp", "2"])
    # --serve async and --metrics-port are ported; the port is served by
    # the async front end only
    with pytest.raises(SystemExit):
        tserve.main(base + ["--metrics-port", "0"])
    stats = tserve.main(base + ["--serve", "async"])
    assert stats["clock_mode"] == "wall"
    assert stats["decode_tokens"] == 2 * (3 - 1)
    # --no-warmup (the reference's flag) skips the untimed pass of every
    # engine: the scan engine's, the paged loop's and the front end's
    stats = tserve.main(base + ["--no-warmup"])
    assert stats["decode_tokens"] == 2 * (3 - 1)
    stats = tserve.main(base[:-4] + ["--no-warmup"])
    assert stats["compile_s"] == 0.0
    assert tserve.main(base[:-4])["compile_s"] > 0.0
    stats = tserve.main(base + ["--serve", "async", "--no-warmup"])
    assert stats["decode_tokens"] == 2 * (3 - 1)
    with pytest.raises(SystemExit):         # oversubscribed, no preemption
        tserve.main(base + ["--oversubscribe", "0.5"])
    with pytest.raises(ValueError, match="packed"):   # pages are sparq
        tserve.main(base + ["--kv-cache", "fp32"])
