"""Port parity, the VLM family: paligemma-3b at reduced size (2 layers, a
16-row image prefix) against the JAX package: configs, the Batcher's
vision stub, the prefix-LM mask of `flash_attention` over several
chunkings, a dense layer with the prefix in train, prefill and decode,
logits and loss (the prefix cut before the head), the quantized model,
calibration, the scan engine's greedy tokens over the fp and sparq
layouts (decoding from prompt + prefix), the caches carried across by
`interop.cache_from_jax` and their modeled bytes, the paged engine's
refusal, the CLI and the trainer.

Weights are drawn by the JAX package and carried over by
`interop.params_from_jax`; every run is f32. Tolerance: LOGIT_ATOL (2e-4)
on floats; none for greedy tokens, codes and byte tallies.
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
from repro.data import pipeline as jpipe
from repro.distributed.sharding import set_activation_spec
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import cache as jcache
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
from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import cache as tcache
from repro_torch.models import transformer as ttr
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.model import Model as TModel
from repro_torch.models.quantize import quantize_params as tquantize

LOGIT_ATOL = 2e-4
ARCH = "paligemma-3b"
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
CODEC = dict(bits=4, opts=5, signed=True)
SITES = {"attn_q", "attn_k", "attn_v", "attn_out", "ffn_gate", "ffn_up",
         "ffn_down"}


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


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_jax(reduced):
    """Every field the port has equals the reference's; the layers are
    "dense" (GQA over one KV head: G 8 and hd 256 at full width), behind
    an image prefix of `frontend_len` rows."""
    assert ARCH in ARCHS
    jc = (jcfg_reduced if reduced else jcfg)(ARCH)
    tc = (tcfg_reduced if reduced else tcfg)(ARCH)
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        want = DTYPES.get(want, want) if not isinstance(
            want, (int, float, str, bool, tuple)) else want
        assert getattr(tc, f.name) == want, (jc.name, f.name)
    assert not tc.is_encdec and tc.frontend == "vision"
    assert TModel(tc, device="cpu").kinds == JModel(jc).kinds == \
        ["dense"] * tc.n_layers
    assert (tc.frontend_len, tc.head_dim, tc.n_heads // tc.n_kv_heads) == (
        (16, 32, 4) if reduced else (256, 256, 8))


def test_batcher_image_stub():
    """A vision front end adds "image_embeds" f32 [B, frontend_len,
    d_model], normals x 0.02 as the reference's, seeded by (seed, step,
    host offset) like the tokens: the same batch twice, another at the
    next step."""
    cfg = tcfg_reduced(ARCH)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4,
                    seed=3, frontend=cfg.frontend,
                    frontend_len=cfg.frontend_len, d_model=cfg.d_model)
    data = Batcher(dc)
    b0 = data.global_batch(0)
    assert set(b0) == {"tokens", "labels", "image_embeds"}
    img = b0["image_embeds"]
    assert img.shape == (4, 16, cfg.d_model) and img.dtype == np.float32
    np.testing.assert_array_equal(img, data.global_batch(0)["image_embeds"])
    assert not np.array_equal(img, data.global_batch(1)["image_embeds"])
    assert 0.015 < float(img.std()) < 0.025 and abs(float(img.mean())) < 3e-3
    assert b0["tokens"].shape == (4, 24)
    none = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                              global_batch=4, seed=3)).global_batch(0)
    assert set(none) == {"tokens", "labels"}
    np.testing.assert_array_equal(none["tokens"], b0["tokens"])
    jb = jpipe.Batcher(jpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=24, global_batch=4, seed=3,
        frontend="vision", frontend_len=16,
        d_model=cfg.d_model)).global_batch(0)
    assert jb["image_embeds"].shape == img.shape
    assert jb["image_embeds"].dtype == img.dtype


@pytest.mark.parametrize("q_chunk,kv_chunk", [(64, 64), (8, 8), (16, 5),
                                              (5, 12)])
def test_flash_prefix_lm_matches_jax(q_chunk, kv_chunk):
    """`flash_attention(prefix_len=)` against the reference's over 37
    queries and keys, GQA 4 over 2: prefixes that end inside a chunk
    (13) and on one (16 at chunks of 8), with and without a window; a prefix
    widens only the causal mask (bidirectional attention ignores it),
    and the keys past Tk that the reference pads each chunk with stay
    masked."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 37, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 37, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 37, 2, 16), dtype=np.float32)
    cases = [dict(prefix_len=13), dict(prefix_len=16),
             dict(prefix_len=13, window=8), dict(prefix_len=13, causal=False)]
    for kw in cases:
        want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                     q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
        got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=str(kw))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk)
    # a prefix of every key is bidirectional attention; one of 13 keys
    # changes the first 12 query rows only (the later ones saw it anyway)
    np.testing.assert_allclose(
        tattn.flash_attention(*t, prefix_len=37, **kw).numpy(),
        tattn.flash_attention(*t, causal=False, **kw).numpy(), rtol=0,
        atol=1e-5)
    pre = tattn.flash_attention(*t, prefix_len=13, **kw)
    causal = tattn.flash_attention(*t, **kw)
    assert torch.equal(pre[:, 12:], causal[:, 12:])
    assert (pre[:, :12] - causal[:, :12]).abs().amax(dim=(0, 2, 3)).min() \
        > 1e-3


@pytest.fixture(scope="module")
def pg():
    """The reduced paligemma in f32 in both packages: the JAX package's
    seeded weights carried over by `interop.params_from_jax`, each
    package's int8 weight codes, and the port's calibrated spans on a
    batch with its image prefix."""
    jc = jcfg_reduced(ARCH).replace(dtype=jnp.float32, remat=False)
    tc = tcfg_reduced(ARCH).replace(dtype=torch.float32, remat=False)
    jm, tm = JModel(jc), TModel(tc, device="cpu")
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    calib = [_batch(jc, np.random.default_rng(11), 2, 16)]
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, calib=calib,
                tscales=tm.calibrate(tp, calib), jq=jquantize(jp),
                tq=tquantize(tp))


def _batch(cfg, rng, B, T):
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)),
            "image_embeds": rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model), dtype=np.float32)
            * np.float32(0.02)}


def _layer(tree, li):
    return jax.tree.map(lambda a: a[li], tree)


def test_dense_block_with_prefix_matches_jax(pg):
    """A dense layer over a 16-row prefix and 12 tokens, in train and in
    prefill (the whole 28 rows written to the 5opt sparq cache), against
    the reference's `block_apply`; the cache's codes and positions equal.
    (Decode takes no prefix: the engine and cache tests hold it.)"""
    jm, tm = pg["jm"], pg["tm"]
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    B, T, P = 2, 28, cfg.frontend_len
    x = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32) / 4
    pos = np.tile(np.arange(T), (B, 1))
    jp_l, tp_l = _layer(pg["jp"]["blocks"][0], 1), \
        ttr.layer_params(pg["tp"]["blocks"][0], 1)
    jcc, tcc = _layouts("sparq")
    jc_l = jtr.block_cache_init(cfg, "dense", B, 32, cache_cfg=jcc)
    tc_l = ttr.stack_cache_init(tm.cfg, ["dense"], B, 32, "cpu", tcc)[0]
    for mode, xs, ps, with_cache in (("train", x, pos, None),
                                     ("prefill", x, pos, "cache")):
        want, new_j, _ = jtr.block_apply(
            jp_l, jnp.asarray(xs), cfg, "dense", positions=jnp.asarray(ps),
            cache=jc_l if with_cache else None, mode=mode, prefix_len=P)
        got, _, _ = ttr.block_apply(
            tp_l, torch.from_numpy(xs), tm.cfg, "dense",
            positions=torch.from_numpy(ps),
            cache=tc_l if with_cache else None, mode=mode, prefix_len=P)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=mode)
        if with_cache:
            jc_l = new_j
            assert int(tc_l.pos) == int(jc_l.pos)
            for jpl, tpl in ((jc_l.k, tc_l.k), (jc_l.v, tc_l.v)):
                np.testing.assert_array_equal(tpl.data.numpy(),
                                              np.asarray(jpl.data))
                np.testing.assert_array_equal(tpl.meta.numpy(),
                                              np.asarray(jpl.meta))


def test_logits_and_loss_match_jax(pg):
    """Float logits and loss against the reference's jitted ones: the
    image prefix ahead of the scaled tokens, cut before the head (logits
    of the 20 token positions only)."""
    jm, tm = pg["jm"], pg["tm"]
    b = _batch(jm.cfg, np.random.default_rng(5), 2, 20)
    b["labels"] = np.concatenate([b["tokens"][:, 1:],
                                  np.full((2, 1), -1)], 1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(jm.logits)(pg["jp"], jb)
    got = tm.logits(pg["tp"], b)
    assert got.shape == (2, 20, jm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    jl, _ = jax.jit(jm.loss)(pg["jp"], jb)
    tl, _ = tm.loss(pg["tp"], b)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0,
                               atol=LOGIT_ATOL)
    assert tm.forward(pg["tp"], b).shape == (2, 16 + 20, jm.cfg.d_model)
    no_img = tm.logits(pg["tp"], {"tokens": b["tokens"]})
    assert not torch.allclose(no_img, got)


def test_quantized_logits_match_eager_jax(pg):
    """Int8 weight codes and 5opt activations over the calibrated spans
    (the prefix rows quantized with the tokens) against the reference's
    `forward` run eagerly."""
    jm, tm = pg["jm"], pg["tm"]
    b = _batch(jm.cfg, np.random.default_rng(6), 2, 16)
    jctx = JCtx(mode="quantized", cfg=JCfg(**CODEC), impl="reference")
    jscales = [{k: jnp.asarray(v.numpy()) for k, v in g.items()}
               for g in pg["tscales"]]
    with jax.disable_jit():
        x, prefix = jm.forward(pg["jq"], {k: jnp.asarray(v)
                                          for k, v in b.items()},
                               jctx, jscales)
        want = np.asarray(jm._head(pg["jq"], x[:, prefix:]))
    got = tm.logits(pg["tq"], b, TCtx(mode="quantized", cfg=TCfg(**CODEC)),
                    pg["tscales"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


def test_calibration_spans_and_sites_equal_jax(pg):
    """`Model.calibrate` hands the prefix length to every layer: the
    sites and the spans equal the reference's eager calibration;
    `quant_sites` is the reference's dense list."""
    jm, tm = pg["jm"], pg["tm"]
    assert tm.quant_sites() == jm.quant_sites()
    jcal = [{k: jnp.asarray(v) for k, v in b.items()} for b in pg["calib"]]
    want = jm.calibrate(pg["jp"], jcal)
    assert [set(g) for g in pg["tscales"]] == [set(g) for g in want] == \
        [SITES]
    for tg, jg in zip(pg["tscales"], want):
        for site in tg:
            np.testing.assert_allclose(tg[site].numpy(), np.asarray(jg[site]),
                                       rtol=1e-6, atol=0, err_msg=site)


def _layouts(layout):
    return (JCC.fp32(), TCC.fp32()) if layout == "fp32" else (
        JCC.sparq_cache(JCfg(**CODEC), impl="reference"),
        TCC.sparq_cache(TCfg(**CODEC)))


@pytest.mark.parametrize("layout", ["fp32", "sparq"])
def test_scan_engine_tokens_equal_jax(pg, layout):
    """The scan engine, batch 2, 12-token prompts behind their 16-row
    image prefix, gen 8, on the float model over an fp32 cache and over
    the 5opt sparq cache: decoding starts at position 28, the capacity
    counts the prefix; tokens and the modeled cache bytes equal JAX's."""
    jm, tm = pg["jm"], pg["tm"]
    b = _batch(jm.cfg, np.random.default_rng(3), 2, 12)
    jcc, tcc = _layouts(layout)
    jtoks, jstats = jserve.DecodeEngine(jm, jcc).generate(
        pg["jp"], {k: jnp.asarray(v) for k, v in b.items()}, 8,
        warmup=False)
    eng = tserve.DecodeEngine(tm, tcc)
    ttoks, tstats = eng.generate(pg["tp"], b, 8, warmup=False)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    for k in ("cache_data_bytes", "cache_total_bytes"):
        assert tstats[k] == jstats[k], k
    assert all(int(c.pos) == 16 + 12 + 7 for c in eng.last_caches)
    assert eng.last_caches[0].k.data.shape[1] == 16 + 12 + 8 + 8
    with pytest.raises(ValueError, match="overflow"):
        eng.generate(pg["tp"], b, 8, max_len=12 + 8, warmup=False)


def test_caches_from_jax_and_their_bytes(pg):
    """After a JAX prefill of prefix and prompt over the sparq layout,
    `interop.cache_from_jax` gives the port's caches with the same codes,
    scales and positions (28), `modeled_cache_bytes` the reference's
    tally; a port decode step at position 28 from them gives the JAX
    step's logits."""
    jm, tm = pg["jm"], pg["tm"]
    jcc, tcc = _layouts("sparq")
    b = _batch(jm.cfg, np.random.default_rng(9), 2, 12)
    jc = jm.init_cache(2, 36, cache_cfg=jcc)
    _, jc = jax.jit(jm.prefill)(pg["jp"], {k: jnp.asarray(v)
                                           for k, v in b.items()}, jc)
    tc = interop.cache_from_jax(jax.tree.map(np.asarray, jc), tcc)
    assert [type(c) for c in tc] == [tcache.CacheStore] * jm.cfg.n_layers
    assert tcache.modeled_cache_bytes(tc) == jcache.modeled_cache_bytes(jc)
    assert all(int(c.pos) == 28 for c in tc)
    nxt = np.random.default_rng(5).integers(0, 512, (2, 1))
    jl, _ = jax.jit(jm.decode_step)(pg["jp"], jnp.asarray(nxt), jc,
                                    jnp.int32(28))
    tl = tm.decode_step(pg["tp"], torch.from_numpy(nxt), tc,
                        torch.tensor(28, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)


def test_paged_engine_refuses_vlm(pg):
    """Its layers are dense, but the paged engine has no image prefix:
    it refuses the family in the reference's words."""
    with pytest.raises(ValueError, match="standard-KV.*vlm"):
        tserve.ContinuousBatchingEngine(
            pg["tm"], TCC.sparq_cache(TCfg(**CODEC)), device="cpu")


def test_cli_serves_paligemma_on_cpu():
    """`--arch paligemma-3b --reduced --engine scan` on the CPU: int8
    weight codes over the 5opt sparq cache, the image prefix drawn by the
    Batcher; `--engine paged` refuses it in the reference's words."""
    argv = ["--arch", ARCH, "--reduced", "--engine", "scan", "--kv-cache",
            "sparq", "--sparq", "5opt", "--prequantize", "--batch", "2",
            "--prompt-len", "16", "--gen", "4", "--calibrate", "1",
            "--device", "cpu"]
    stats = tserve.main(argv)
    assert stats["tokens"].shape == (2, 4)
    assert ((stats["tokens"] >= 0) & (stats["tokens"] < 512)).all()
    assert stats["decode_tok_s"] > 0 and stats["cache_total_bytes"] > 0
    with pytest.raises(ValueError, match="standard-KV"):
        tserve.main(argv + ["--engine", "paged"])


def test_trainer_step_on_cpu():
    """`repro_torch.launch.train` on the reduced paligemma: its batches
    carry the image prefix (the loss over the token positions only), two
    steps, finite losses."""
    losses = ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
