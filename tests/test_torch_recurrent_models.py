"""Port parity, the recurrent families end to end: recurrentgemma-9b (the
RG-LRU hybrid: rg_rec, rg_rec, rg_attn over a sliding-window ring) and
rwkv6-7b at reduced size against the JAX package: configs, logits
(unquantized and quantized), calibration sites, weight codes, the scan
engine's greedy tokens over the fp and sparq layouts with a prompt longer
than the window, the caches carried across by `interop.cache_from_jax`
and their modeled bytes, the paged engine's refusal and the CLI.

Tolerance: LOGIT_ATOL (2e-4) on logits, as in tests/test_torch_moe.py;
none for greedy tokens, weight codes and byte tallies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.core.sparq import SparqConfig as JCfg
from repro.distributed.sharding import set_activation_spec
from repro.launch import serve as jserve
from repro.models import cache as jcache
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.models.cache import CacheConfig as JCC
from repro.models.common import QuantCtx as JCtx
from repro.models.model import Model as JModel
from repro.models.quantize import quantize_params as jquantize
from repro_torch import interop
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tcfg
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.launch import serve as tserve
from repro_torch.models import cache as tcache
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as ttr
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.common import norm
from repro_torch.models.model import Model as TModel
from repro_torch.models.quantize import quantize_params as tquantize
from test_torch_mla import _snap

LOGIT_ATOL = 2e-4
RG, RWKV = "recurrentgemma-9b", "rwkv6-7b"
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
CODEC = dict(bits=4, opts=5, signed=True)
SITES = {RG: {"rg_rec": {"rg_gate", "rg_in", "rg_rgate", "rg_igate",
                         "rg_out", "ffn_gate", "ffn_up", "ffn_down"},
              "rg_attn": {"attn_q", "attn_k", "attn_v", "attn_out",
                          "ffn_gate", "ffn_up", "ffn_down"}},
         RWKV: {"rwkv": {"tm_r", "tm_k", "tm_v", "tm_g", "tm_out", "cm_k",
                         "cm_r", "cm_v"}}}


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


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", [RG, RWKV])
def test_config_equals_jax(arch, reduced):
    assert arch in ARCHS
    jc = (jcfg_reduced if reduced else jcfg)(arch)
    tc = (tcfg_reduced if reduced else tcfg)(arch)
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        want = DTYPES.get(want, want) if not isinstance(
            want, (int, float, str, bool, tuple)) else want
        assert getattr(tc, f.name) == want, (jc.name, f.name)
    kinds = TModel(tc, device="cpu").kinds
    assert kinds == JModel(jc).kinds
    if arch == RG:
        assert kinds.count("rg_attn") == tc.n_layers // 3
        assert kinds.count("rg_rec") == tc.n_layers - tc.n_layers // 3
        assert (tc.local_window, tc.attn_chunk) == ((32, 64) if reduced
                                                    else (2048, 1024))
    else:
        assert kinds == ["rwkv"] * tc.n_layers
        assert tc.mixer_chunk == (8 if reduced else 16)


@pytest.fixture(scope="module", params=[RG, RWKV])
def fam(request):
    """The reduced model in f32 in both packages (recurrentgemma: its 3
    layers rg_rec, rg_rec, rg_attn; rwkv6: 2 layers): the port's seeded
    weights (the RG-LRU's lam and RWKV's vectors moved off their constant
    init) and their JAX copy, each quantized by its own package, and the
    port's calibrated spans (`_snap`ped for the jitted JAX layers)."""
    arch = request.param
    jc = jcfg_reduced(arch).replace(dtype=jnp.float32, remat=False)
    tc = tcfg_reduced(arch).replace(dtype=torch.float32, remat=False)
    jm, tm = JModel(jc), TModel(tc, device="cpu")
    tp = tm.init_params(0)
    rng = np.random.default_rng(1)
    for g in tp["blocks"]:
        if "rec" in g:
            g["rec"]["lam"] = torch.from_numpy(rng.uniform(
                -1, 2, g["rec"]["lam"].shape).astype(np.float32))
        for k in [k for k in g if k.startswith("mu_") or k in ("u", "w0")]:
            lo, hi = (0, 1) if k.startswith("mu_") else (-1.5, 0.5)
            g[k] = torch.from_numpy(rng.uniform(lo, hi, g[k].shape).astype(
                np.float32))
    jp = _to_jax(tp)
    calib = [{"tokens": np.random.default_rng(11).integers(
        0, jc.vocab_size, (2, 40))}]
    tscales = tm.calibrate(tp, calib)
    snapped = [{k: _snap(v.numpy()) for k, v in g.items()} for g in tscales]
    return dict(arch=arch, jm=jm, jp=jp, tm=tm, tp=tp, tscales=tscales,
                jscales=[{k: jnp.asarray(v) for k, v in g.items()}
                         for g in snapped],
                tsnapped=[{k: torch.from_numpy(v) for k, v in g.items()}
                          for g in snapped],
                jq=jquantize(jp), tq=tquantize(tp))


def _jax_logits(jm, jp, toks):
    """The JAX float logits, the layers applied one by one, jitted, as
    tests/test_torch_mla.py."""
    cfg = jm.cfg

    def logits(p, toks):
        x, _ = jm._embed_in(p, {"tokens": toks}, cfg.dtype)
        pos = jnp.broadcast_to(jnp.arange(toks.shape[1])[None], toks.shape)
        for gi, (kind, count) in enumerate(jm.groups_meta):
            for li in range(count):
                x, _, _ = jtr.block_apply(
                    jax.tree.map(lambda a: a[li], p["blocks"][gi]), x, cfg,
                    kind, positions=pos, mode="train")
        x = jcommon.norm(p["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return jm._head(p, x)
    return np.asarray(jax.jit(logits)(jp, jnp.asarray(toks)))


def _jax_quantized_layers(jm, jp, toks, codec, jscales):
    """The JAX quantized stack over the `_snap`ped spans, each layer its
    own jitted program: the hidden states between the layers (the
    embedding, each layer's output) and the logits."""
    cfg = jm.cfg
    x, _ = jm._embed_in(jp, {"tokens": jnp.asarray(toks)}, cfg.dtype)
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1])[None], toks.shape)
    hidden = [np.asarray(x)]
    for gi, (kind, count) in enumerate(jm.groups_meta):
        for li in range(count):
            ctx = JCtx(mode="quantized", cfg=codec, impl="reference",
                       scales={s: v[li] for s, v in jscales[gi].items()})
            x = jax.jit(lambda p, x: jtr.block_apply(
                p, x, cfg, kind, positions=pos, mode="train", ctx=ctx)[0])(
                jax.tree.map(lambda a: a[li], jp["blocks"][gi]), x)
            hidden.append(np.asarray(x))
    x = jcommon.norm(jp["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return np.asarray(jm._head(jp, x)), hidden


def test_logits_match_jax(fam):
    """Float logits against the JAX layers, end to end; T 40 exceeds the
    reduced window of 32, so the windowed layer's two-block trick runs.
    The 5opt model over each package's int8 weight codes and the
    calibrated spans layer by layer: each port layer on the JAX layer's
    input, then the port's head on the JAX stack's output. (End to end, a
    difference of an f32 ulp in one activation can move it across a
    rounding boundary to the next code, and the recurrences carry that
    one code to every later token: two XLA compilations of the same JAX
    stack, the whole and layer by layer, part so.)"""
    jm, tm = fam["jm"], fam["tm"]
    toks = np.random.default_rng(1).integers(0, 512, (2, 40))
    np.testing.assert_allclose(tm.logits(fam["tp"], {"tokens": toks}).numpy(),
                               _jax_logits(jm, fam["jp"], toks), rtol=0,
                               atol=LOGIT_ATOL, err_msg="off")
    want, hidden = _jax_quantized_layers(jm, fam["jq"], toks, JCfg(**CODEC),
                                         fam["jscales"])
    tc = tm.cfg
    pos = torch.arange(40)[None].expand(2, 40)
    layer = 0
    for gi, (kind, count) in enumerate(tm.groups_meta):
        for li in range(count):
            ctx = TCtx(mode="quantized", cfg=TCfg(**CODEC), scales={
                s: v[li] for s, v in fam["tsnapped"][gi].items()})
            got, _, _ = ttr.block_apply(
                ttr.layer_params(fam["tq"]["blocks"][gi], li),
                torch.from_numpy(hidden[layer].copy()), tc, kind,
                positions=pos, mode="train", ctx=ctx)
            np.testing.assert_allclose(got.numpy(), hidden[layer + 1],
                                       rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"5opt layer {layer}")
            layer += 1
    x = norm(fam["tq"]["final_norm"], torch.from_numpy(hidden[-1].copy()),
             tc.norm_type, tc.norm_eps)
    np.testing.assert_allclose(tm._head(fam["tq"], x).numpy(), want, rtol=0,
                               atol=LOGIT_ATOL, err_msg="5opt head")


def test_calibration_sees_every_site(fam):
    """`Model.calibrate` (mode train) gives a positive span at every site
    of every layer, `attn_out` of the windowed layer among them (its
    train mode goes through `dense`); `quant_sites` is the reference's."""
    tm = fam["tm"]
    assert tm.quant_sites() == fam["jm"].quant_sites()
    want = SITES[fam["arch"]]
    assert [set(g) for g in fam["tscales"]] == [
        want[kind] for kind, _ in tm.groups_meta]
    assert set(tm.quant_sites()) == set().union(*want.values())
    assert all(bool((v > 0).all()) for g in fam["tscales"]
               for v in g.values())


def test_quantize_params_quantizes_the_same_leaves(fam):
    """The projections become codes (the RG-LRU's five, RWKV's eight and
    the attention and GeGLU weights); conv_k, lam, the mus, u, w0, w_A,
    w_B and the norms stay float in both packages; the codes are equal."""
    jq = jax.tree.map(np.asarray, fam["jq"])
    tq = fam["tq"]
    jl = jax.tree_util.tree_leaves_with_path(jq)
    tl = jax.tree_util.tree_leaves_with_path(tq)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, j), (_, t) in zip(jl, tl):
        assert str(t.dtype) == f"torch.{j.dtype.name}", path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    coded = {"w_y", "w_x", "w_a", "w_i", "w_out", "wq", "wk", "wv", "wo",
             "w_gate", "w_up", "w_down", "w_r", "w_k", "w_v", "w_g", "w_o",
             "w_ck", "w_cr", "w_cv"}

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict) and set(v) != {"q", "s"}:
                walk(v)
            else:
                assert isinstance(v, dict) == (k in coded), k
    for g in tq["blocks"]:
        walk(g)


@pytest.mark.parametrize("layout", ["fp32", "sparq"])
def test_scan_engine_tokens_equal_jax(fam, layout):
    """The scan engine, batch 2, 40-token prompts (past the reduced window
    of 32: the prefill primes a rotated ring, each decode write evicts a
    slot), gen 8, on the float model over an fp32 cache and over the 5opt
    sparq ring (K4's ring write, the windowed K5 on packed planes; the
    recurrent states in bf16 as the reference stores them); tokens and
    the modeled cache bytes equal JAX's."""
    jm, tm = fam["jm"], fam["tm"]
    toks = np.random.default_rng(3).integers(0, 512, (2, 40))
    jcc, tcc = (JCC.fp32(), TCC.fp32()) if layout == "fp32" else (
        JCC.sparq_cache(JCfg(**CODEC), impl="reference"),
        TCC.sparq_cache(TCfg(**CODEC)))
    jtoks, jstats = jserve.DecodeEngine(jm, jcc).generate(
        fam["jp"], {"tokens": jnp.asarray(toks)}, 8, warmup=False)
    eng = tserve.DecodeEngine(tm, tcc)
    ttoks, tstats = eng.generate(fam["tp"], {"tokens": toks}, 8,
                                 warmup=False)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    for k in ("cache_data_bytes", "cache_total_bytes"):
        assert tstats[k] == jstats[k], k
    if fam["arch"] == RG:
        ring = eng.last_caches[2]
        assert isinstance(ring, tcache.RingKVCache)
        assert int(ring.pos) == 40 + 7
        assert sorted(ring.slot_pos[0].tolist()) == list(range(15, 47))


def test_caches_from_jax_and_their_bytes(fam):
    """After a JAX prefill over the sparq layout, `interop.cache_from_jax`
    gives the port's caches with the same states, bytes and positions, and
    `modeled_cache_bytes` the reference's tally of them; a port decode
    step from them gives the JAX step's logits."""
    jm, tm = fam["jm"], fam["tm"]
    jcc = JCC.sparq_cache(JCfg(**CODEC), impl="reference")
    tcc = TCC.sparq_cache(TCfg(**CODEC))
    toks = np.random.default_rng(4).integers(0, 512, (2, 36))
    jc = jm.init_cache(2, 44, cache_cfg=jcc)
    _, jc = jax.jit(jm.prefill)(fam["jp"], {"tokens": jnp.asarray(toks)},
                                jc)
    np_c = jax.tree.map(np.asarray, jc)
    tc = interop.cache_from_jax(np_c, tcc)
    kinds = tm.kinds
    assert len(tc) == len(kinds)
    want_types = {"rg_rec": trg.RGLRUCache, "rg_attn": tcache.RingKVCache,
                  "rwkv": trwkv.RWKVCache}
    assert [type(c) for c in tc] == [want_types[k] for k in kinds]
    assert tcache.modeled_cache_bytes(tc) == jcache.modeled_cache_bytes(jc)
    if fam["arch"] == RWKV:
        assert tc[0].state.dtype == torch.bfloat16
    nxt = np.random.default_rng(5).integers(0, 512, (2, 1))
    jl, _ = jax.jit(jm.decode_step)(fam["jp"], jnp.asarray(nxt), jc,
                                    jnp.int32(36))
    tl = tm.decode_step(fam["tp"], torch.from_numpy(nxt), tc,
                        torch.tensor(36, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)


def test_mixer_forms_agree(fam):
    """The ports of tests/test_models_smoke.py::test_rwkv_scan_vs_chunked
    and ::test_rglru_assoc_vs_scan: the chunked (rwkv) or associative
    (rglru) mixer against the sequential scan, same tolerance."""
    tm = fam["tm"]
    toks = np.random.default_rng(6).integers(0, 512, (2, 24))
    got = tm.logits(fam["tp"], {"tokens": toks})
    scan = TModel(tm.cfg.replace(mixer_impl="scan"), device="cpu").logits(
        fam["tp"], {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), scan.numpy(), rtol=5e-3,
                               atol=5e-3)


def test_fused_decode_matches_fp_on_the_int8_grid():
    """The port of tests/test_cache.py::test_fused_decode_nondense_archs_
    match_fp for recurrentgemma: the greedy tokens over an fp32 cache
    equal those over the int8-grid sparq ring (the windowed decode on
    packed planes), end to end through the scan engine."""
    tc = tcfg_reduced(RG).replace(dtype=torch.float32, remat=False)
    tm = TModel(tc, device="cpu")
    tp = tm.init_params(0)
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 16))
    t_fp, _ = tserve.DecodeEngine(tm, TCC.fp32()).generate(
        tp, {"tokens": toks}, 6, warmup=False)
    t_i8, _ = tserve.DecodeEngine(tm, TCC.sparq_cache(
        TCfg(enabled=False, signed=True))).generate(
        tp, {"tokens": toks}, 6, warmup=False)
    np.testing.assert_array_equal(t_fp, t_i8)


def test_paged_engine_refuses_recurrent_archs(fam):
    with pytest.raises(ValueError, match="standard-KV"):
        tserve.ContinuousBatchingEngine(
            fam["tm"], TCC.sparq_cache(TCfg(**CODEC)), device="cpu")


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_cli_serves_reduced_arch_on_cpu(arch):
    """`--arch ... --reduced --engine scan` on the CPU: recurrentgemma with
    int8 weight codes over the 5opt sparq ring (a prompt past the window),
    rwkv6 as the reference's `test_serve_rwkv_constant_state` runs it
    (a8w8, dynamic scales); rwkv6's modeled state is the same at any
    prompt length. `--engine paged` refuses both."""
    common = ["--arch", arch, "--reduced", "--batch", "2", "--gen", "4",
              "--device", "cpu"]
    if arch == RG:
        flags = ["--prompt-len", "40", "--calibrate", "1", "--prequantize",
                 "--kv-cache", "sparq", "--sparq", "5opt"]
    else:
        flags = ["--prompt-len", "16", "--sparq", "a8w8", "--calibrate",
                 "0"]
    stats = tserve.main(common + flags)
    assert stats["tokens"].shape == (2, 4)
    assert stats["decode_tok_s"] > 0 and stats["cache_total_bytes"] > 0
    if arch == RWKV:
        longer = tserve.main(common + flags + ["--prompt-len", "48"])
        assert longer["cache_total_bytes"] == stats["cache_total_bytes"]
    with pytest.raises(ValueError, match="standard-KV"):
        tserve.main(common + flags + ["--engine", "paged"])
