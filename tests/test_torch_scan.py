"""Port parity, the contiguous-cache slice end to end: the port's scan
engine (`DecodeEngine`) against `repro.launch.serve.DecodeEngine`, and its
paged engine with sequential admission against the JAX engine with
`prefill="sequential"`.

Both packages get the same weights (through `interop`), the same numpy
prompts and the same calibrated activation scales, and run in f32, so the
greedy tokens must be equal and the paged allocator's trace identical
step by step. Contiguous caches filled by the JAX prefill go into the port
through `interop.cache_from_jax`, so a decode step reads identical bytes
in both; its logits are held to atol 2e-4, as in test_torch_model.py.
"""
import dataclasses

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
from repro_torch import interop
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.cache import CachedTensor
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.model import Model as TModel
from test_torch_serve import _allocator_view, _trace

LOGIT_ATOL = 2e-4
PS = 4
SEQ_KW = dict(page_size=PS, n_pages=24, max_active=3, max_seq_len=24,
              prefill="sequential")
CODECS = {"fp32": None, "int8": dict(enabled=False, signed=True),
          "5opt": dict(bits=4, opts=5, signed=True)}


@pytest.fixture(scope="module", autouse=True)
def _no_activation_spec():
    """The JAX model constrains activations to a module-global spec that
    a training test earlier in the same worker may have left set; both
    packages run on one device here, unsharded."""
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
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(11)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jc.vocab_size,
                                                 (2, 16)))}]
    jscales = jm.calibrate(jp, calib)
    tscales = interop.scales_from_jax(jax.tree.map(np.asarray, jscales))
    return jm, jp, tm, tp, jscales, tscales


def _setup(name, models):
    """(JAX ctx, cache config), (port ctx, cache config) for a KV layout:
    fp32 serves unquantized matmuls; int8/5opt quantize matmuls and cache
    with the same codec."""
    if CODECS[name] is None:
        return (None, JCC.fp32()), (None, TCC.fp32())
    jc, tc = JCfg(**CODECS[name]), TCfg(**CODECS[name])
    return ((JCtx(mode="quantized", cfg=jc, impl="reference"),
             JCC.sparq_cache(jc, impl="reference")),
            (TCtx(mode="quantized", cfg=tc), TCC.sparq_cache(tc)))


@pytest.mark.parametrize("name", list(CODECS))
def test_scan_engine_tokens_match(models, name):
    jm, jp, tm, tp, jscales, tscales = models
    (jctx, jcc), (tctx, tcc) = _setup(name, models)
    toks = np.random.default_rng(3).integers(0, 512, (2, 10))
    jtoks, jstats = jserve.DecodeEngine(
        jm, jcc, jctx, jscales if jctx else None).generate(
            jp, {"tokens": jnp.asarray(toks)}, 6, warmup=False)
    eng = tserve.DecodeEngine(tm, tcc, tctx, tscales if tctx else None)
    ttoks, tstats = eng.generate(tp, {"tokens": toks}, 6, warmup=False)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert ttoks.dtype == np.int32 and ttoks.shape == (2, 6)
    for key in ("cache_bytes_per_value", "cache_ctrl_bytes_per_value",
                "cache_data_bytes", "cache_total_bytes"):
        assert tstats[key] == jstats[key], key
    assert tstats["decode_tok_s"] > 0 and tstats["device"] == "cpu"


@pytest.mark.parametrize("name", ["5opt", "fp32"])
def test_decode_step_on_jax_prefilled_cache(models, name):
    """JAX prefill -> cache_from_jax: the port's decode step reads the
    same bytes and scales as the JAX one, and writes the same token."""
    jm, jp, tm, tp, jscales, tscales = models
    (jctx, jcc), (tctx, tcc) = _setup(name, models)
    toks = np.random.default_rng(5).integers(0, 512, (2, 9))
    jcache = jm.init_cache(2, 16, cache_cfg=jcc)
    logits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache,
                                ctx=jctx, scales_groups=jscales
                                if jctx else None)
    tcache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), tcc)
    assert len(tcache) == tm.cfg.n_layers
    tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
    jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache,
                                jnp.int32(9), ctx=jctx,
                                scales_groups=jscales if jctx else None)
    tl = tm.decode_step(tp, torch.from_numpy(tok), tcache,
                        torch.tensor(9, dtype=torch.int32), ctx=tctx,
                        scales_groups=tscales if tctx else None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    jplanes = jax.tree.map(np.asarray, jcache)[0]
    for li, st in enumerate(tcache):
        assert int(st.pos) == 10
        # packed codes are integers: exact; f32 K moves by f32 ulps
        np.testing.assert_allclose(st.k.data[:, 9].numpy(),
                                   jplanes.k.data[li][:, 9], rtol=0,
                                   atol=0 if st.k.is_sparq else 1e-5)


def test_scan_decode_never_dequantizes_a_plane(models, monkeypatch):
    """A scan decode step with the sparq layout reads the packed planes
    through K5 only: no CachedTensor.read(), no K6 (the analogue of
    tests/test_cache.py::test_sparq_decode_never_reads_full_plane)."""
    _, _, tm, tp, _, tscales = models
    _, (tctx, tcc) = _setup("5opt", models)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512,
                                                              (2, 8)))
    caches = tm.init_cache(2, 12, cache_cfg=tcc)
    logits = tm.prefill(tp, {"tokens": toks}, caches, ctx=tctx,
                        scales_groups=tscales)
    calls = []
    orig_dq, orig_read = tops.sparq_dequantize, CachedTensor.read
    monkeypatch.setattr(tops, "sparq_dequantize",
                        lambda *a: calls.append("dequant") or orig_dq(*a))
    monkeypatch.setattr(CachedTensor, "read",
                        lambda self, dtype=None: calls.append("read")
                        or orig_read(self, dtype))
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    tm.decode_step(tp, tok, caches, torch.tensor(8, dtype=torch.int32),
                   ctx=tctx, scales_groups=tscales)
    assert calls == []
    caches[0].kv()                   # the read-back path does use K6
    assert calls == ["read", "dequant", "read", "dequant"]


def test_capacity_check_raises_before_any_work(models, monkeypatch):
    _, _, tm, tp, _, _ = models
    eng = tserve.DecodeEngine(tm, TCC.sparq_cache())
    monkeypatch.setattr(tm, "init_cache", lambda *a, **k: pytest.fail(
        "cache allocated before the capacity check"))
    monkeypatch.setattr(tm, "prefill", lambda *a, **k: pytest.fail(
        "prefill ran before the capacity check"))
    with pytest.raises(ValueError, match="KV-cache overflow"):
        eng.generate(tp, {"tokens": np.zeros((1, 10), np.int64)}, 8,
                     max_len=16)


@pytest.mark.parametrize("name", ["5opt", "int8"])
def test_sequential_engine_tokens_and_allocator_trace_match(models, name):
    """The ragged, staggered trace of test_torch_serve.py through both
    engines with sequential admission: equal tokens and allocator trace,
    pools freed; and the port's tokens equal its scan engine's serving
    each request alone with attn_bk == page_size."""
    jm, jp, tm, tp, jscales, tscales = models
    (jctx, jcc), (tctx, tcc) = _setup(name, models)
    trace = _trace()
    jsnaps, tsnaps = [], []
    jeng = jserve.ContinuousBatchingEngine(jm, jcc, jctx, jscales, **SEQ_KW)
    jres, jstats = jeng.run(
        jp, [jserve.Request(t, g, arrive_at=a) for t, g, a in trace],
        trace_hook=lambda s: jsnaps.append(_allocator_view(s)))
    teng = tserve.ContinuousBatchingEngine(tm, tcc, tctx, tscales,
                                           device="cpu", **SEQ_KW)
    tres, tstats = teng.run(
        tp, [tserve.Request(t, g, arrive_at=a) for t, g, a in trace],
        trace_hook=lambda s: tsnaps.append(_allocator_view(s)))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"request {rid}")
    assert tsnaps == jsnaps
    assert tstats["prefill_mode"] == "sequential"
    assert tstats["prefill_chunks"] == 0
    assert tstats["decode_steps"] == jstats["decode_steps"]
    assert tstats["peak_pages_used"] == jstats["peak_pages_used"]
    assert tstats["free_pages_after"] == SEQ_KW["n_pages"]
    scan = tserve.DecodeEngine(tm, dataclasses.replace(tcc, attn_bk=PS),
                               tctx, tscales)
    for rid, (t, g, _) in enumerate(trace):
        toks, _ = scan.generate(tp, {"tokens": t[None]}, g, warmup=False)
        np.testing.assert_array_equal(tres[rid], toks[0],
                                      err_msg=f"scan, request {rid}")


def test_adopt_prefill_copies_pages_scales_and_position(models):
    """adopt_prefill moves a batch-1 contiguous cache into the pool: page
    t of the slot holds rows [t*ps, (t+1)*ps) of every plane verbatim."""
    from repro_torch.models import paging
    _, _, tm, tp, _, tscales = models
    _, (tctx, tcc) = _setup("5opt", models)
    cfg = tm.cfg
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, 512,
                                                              (1, 10)))
    tmp = tm.init_cache(1, 3 * PS, cache_cfg=tcc)
    tm.prefill(tp, {"tokens": toks}, tmp, ctx=tctx, scales_groups=tscales)
    store = paging.PagedCacheStore.init(2, 8, PS, 4, cfg.n_kv_heads,
                                        cfg.head_dim, tcc, "cpu")
    pages = torch.tensor([5, 0, 3])
    paging.adopt_prefill(store, tmp[1], 1, pages)
    for pool, plane in ((store.k_data, tmp[1].k.data),
                        (store.v_meta, tmp[1].v.meta)):
        for t, pg in enumerate(pages.tolist()):
            assert torch.equal(pool[pg], plane[0, t * PS:(t + 1) * PS])
    assert store.block_table[1].tolist() == [5, 0, 3, -1]
    assert int(store.seq_pos[1]) == 10 and int(store.seq_pos[0]) == -1
    assert float(store.k_scale[1]) == float(tmp[1].k.scale) > 0
    with pytest.raises(ValueError, match="batch-1 sparq cache"):
        paging.adopt_prefill(store, tmp[1], 0, pages[:2])


@pytest.mark.parametrize("extra", [
    ["--kv-cache", "sparq"], ["--kv-cache", "fp32", "--sparq", "off"],
    ["--engine", "paged", "--prefill", "sequential"]],
    ids=["scan-sparq", "scan-fp32", "paged-sequential"])
def test_cli_runs_new_paths_on_cpu(capsys, extra):
    base = ["--reduced", "--batch", "2", "--prompt-len", "12", "--gen", "3",
            "--page-size", "4", "--n-pages", "16", "--calibrate", "1",
            "--prequantize", "--device", "cpu"]
    stats = tserve.main(base + extra)
    out = capsys.readouterr().out
    assert "sample:" in out and stats["decode_tok_s"] > 0
    if "paged" in extra:
        assert stats["prefill_mode"] == "sequential"
        assert stats["decode_tokens"] == 2 * (3 - 1)
    else:
        assert "compile" in out and "B/value" in out
