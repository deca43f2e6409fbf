"""Port parity, the enc-dec family: whisper-base at reduced size (2 encoder
and 2 decoder layers) against the JAX package: configs, the Batcher's
audio stub, the encoder ("enc") and decoder ("dec") blocks in train,
prefill and decode, logits and loss, the quantized model with its
encoder on dynamic scales (against the eager reference: jitted, XLA
multiplies by the reciprocal of qmax where the port divides, and its
fusions move activations by an ulp), calibration, the scan
engine's greedy tokens over the fp and sparq layouts, the decoder caches
carried across by `interop.cache_from_jax` and their modeled bytes, the
paged engine's refusal, the CLI and the trainer; and K5's split-key
arithmetic at the decoder's G 1.

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
from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import cache as tcache
from repro_torch.models import transformer as ttr
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.common import sinusoidal_embed
from repro_torch.models.model import Model as TModel
from repro_torch.kernels import sparq_decode_attn as dec
from repro_torch.models.quantize import quantize_params as tquantize
from test_torch_decode_split import CS, _k5_case, emulate

LOGIT_ATOL = 2e-4
ARCH = "whisper-base"
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
CODEC = dict(bits=4, opts=5, signed=True)
PROJ = ("wq", "wk", "wv", "wo", "w_up", "w_down")
DEC_SITES = {"attn_q", "attn_k", "attn_v", "attn_out", "ffn_up",
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


def _frames(rng, B, T, d):
    return (rng.standard_normal((B, T, d), dtype=np.float32)
            * np.float32(0.02))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_jax(reduced):
    """Every field the port has equals the reference's (it leaves out
    `tensor_parallel`); the decoder's layers are "dec", and the encoder
    has its own depth."""
    assert ARCH in ARCHS
    jc = (jcfg_reduced if reduced else jcfg)(ARCH)
    tc = (tcfg_reduced if reduced else tcfg)(ARCH)
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        want = DTYPES.get(want, want) if not isinstance(
            want, (int, float, str, bool, tuple)) else want
        assert getattr(tc, f.name) == want, (jc.name, f.name)
    assert tc.is_encdec and (tc.frontend, tc.use_rope) == ("audio", False)
    assert TModel(tc, device="cpu").kinds == JModel(jc).kinds == \
        ["dec"] * tc.n_layers
    assert tc.n_enc_layers == (2 if reduced else 6)


def test_batcher_frames_stub():
    """An audio front end adds "frames" f32 [B, seq_len, d_model], normals
    x 0.02 as the reference's: seeded by (seed, step, host offset) like
    the tokens, the same batch twice, another at the next step, and the
    calibration batches carry them too."""
    cfg = tcfg_reduced(ARCH)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4,
                    seed=3, frontend=cfg.frontend,
                    frontend_len=cfg.frontend_len, d_model=cfg.d_model)
    data = Batcher(dc)
    b0, again, b1 = data.global_batch(0), data.global_batch(0), \
        data.global_batch(1)
    assert set(b0) == {"tokens", "labels", "frames"}
    f = b0["frames"]
    assert f.shape == (4, 24, cfg.d_model) and f.dtype == np.float32
    np.testing.assert_array_equal(f, again["frames"])
    assert not np.array_equal(f, b1["frames"])
    assert 0.015 < float(f.std()) < 0.025 and abs(float(f.mean())) < 2e-3
    local = Batcher(dc, host_id=1, n_hosts=2).local_batch(0)
    assert local["frames"].shape == (2, 24, cfg.d_model)
    assert not np.array_equal(local["frames"], f[:2])
    assert data.calib_batches(1)[0]["frames"].shape == (4, 24, cfg.d_model)
    jb = jpipe.Batcher(jpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=24, global_batch=4, seed=3,
        frontend="audio", d_model=cfg.d_model)).global_batch(0)
    assert jb["frames"].shape == f.shape and jb["frames"].dtype == f.dtype
    assert "image_embeds" not in jb


def test_sinusoidal_embed_matches_jax():
    got = sinusoidal_embed(40, 128, "cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jcommon.sinusoidal_embed(
        40, 128)), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def wb():
    """The reduced whisper in f32 in both packages: the JAX package's
    seeded weights carried over by `interop.params_from_jax`, each
    package's int8 weight codes, and the port's calibrated spans."""
    jc = jcfg_reduced(ARCH).replace(dtype=jnp.float32, remat=False)
    tc = tcfg_reduced(ARCH).replace(dtype=torch.float32, remat=False)
    jm, tm = JModel(jc), TModel(tc, device="cpu")
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(11)
    calib = [{"tokens": rng.integers(0, jc.vocab_size, (2, 16)),
              "frames": _frames(rng, 2, 16, jc.d_model)}]
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, calib=calib,
                tscales=tm.calibrate(tp, calib), jq=jquantize(jp),
                tq=tquantize(tp))


def test_params_from_jax_carry_the_encoder(wb):
    """The JAX tree crosses leaf for leaf (the encoder's "enc_blocks" and
    "enc_norm", each decoder layer's "xattn" and "ln_x"), and the port's
    own init draws the same layout: the same paths, shapes and dtypes."""
    jl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, wb["jp"]))
    tl = jax.tree_util.tree_leaves_with_path(wb["tp"])
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, j), (_, t) in zip(jl, tl):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    tp = wb["tm"].init_params(0)
    assert {"enc_blocks", "enc_norm"} <= set(tp)
    assert set(tp["blocks"][0]) == {"ln1", "attn", "ln_x", "xattn", "ln2",
                                    "ffn"}
    own = jax.tree_util.tree_leaves_with_path(tp)
    assert [(p, tuple(t.shape), t.dtype) for p, t in own] == [
        (p, tuple(t.shape), t.dtype) for p, t in tl]


def _layouts(layout):
    return (JCC.fp32(), TCC.fp32()) if layout == "fp32" else (
        JCC.sparq_cache(JCfg(**CODEC), impl="reference"),
        TCC.sparq_cache(TCfg(**CODEC)))


def _layer(tree, li):
    return jax.tree.map(lambda a: a[li], tree)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_enc_block_matches_jax(wb, mode):
    """An "enc" layer (bidirectional flash attention over 40 frames in
    kv chunks of 64 and of 16, its output projection in float) against
    the reference's `block_apply`."""
    jm, tm = wb["jm"], wb["tm"]
    x = _frames(np.random.default_rng(2), 2, 40, jm.cfg.d_model) * 50
    pos = np.tile(np.arange(40), (2, 1))
    for chunk in (64, 16):
        jc, tc = jm.cfg.replace(attn_chunk=chunk), \
            tm.cfg.replace(attn_chunk=chunk)
        want, _, _ = jtr.block_apply(
            _layer(wb["jp"]["enc_blocks"][0], 1), jnp.asarray(x), jc, "enc",
            positions=jnp.asarray(pos), mode=mode)
        got, _, _ = ttr.block_apply(
            ttr.layer_params(wb["tp"]["enc_blocks"][0], 1),
            torch.from_numpy(x), tc, "enc", positions=torch.from_numpy(pos),
            mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=str(chunk))


def test_dec_block_matches_jax(wb):
    """A "dec" layer against the reference's `block_apply`: in train
    (K/V from enc_out, no cache), in prefill (the 5opt sparq self cache
    written, the cross K/V [B, T_enc, KV, hd] replacing the cache's zeros
    of [B, max_len, KV, hd]), then two decode steps (the cross K/V read
    back through `decode_attention` over fp planes). Outputs within
    LOGIT_ATOL; the cross K/V within it, the self cache's codes and
    positions equal, its scale within 1e-6 relative."""
    jm, tm = wb["jm"], wb["tm"]
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    B, T, Te, max_len = 2, 12, 20, 24
    # at the scale of the embedded tokens (0.02 x sqrt(d))
    x = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32) / 4
    enc = rng.standard_normal((B, Te, cfg.d_model), dtype=np.float32)
    pos = np.tile(np.arange(T), (B, 1))
    jp_l = _layer(wb["jp"]["blocks"][0], 1)
    tp_l = ttr.layer_params(wb["tp"]["blocks"][0], 1)
    want, _, _ = jtr.block_apply(jp_l, jnp.asarray(x), cfg, "dec",
                                 positions=jnp.asarray(pos), mode="train",
                                 enc_out=jnp.asarray(enc))
    got, _, _ = ttr.block_apply(tp_l, torch.from_numpy(x), tm.cfg, "dec",
                                positions=torch.from_numpy(pos),
                                mode="train", enc_out=torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL, err_msg="train")
    jcc, tcc = _layouts("sparq")
    jcache_l = jtr.block_cache_init(cfg, "dec", B, max_len, cache_cfg=jcc)
    tcache_l = ttr.stack_cache_init(tm.cfg, ["dec"], B, max_len, "cpu",
                                    tcc)[0]
    assert isinstance(tcache_l, tcache.DecCache)
    assert tuple(tcache_l.cross_k.shape) == jcache_l["cross_k"].shape
    steps = [("prefill", x, pos, jnp.asarray(enc), torch.from_numpy(enc))]
    for t in range(2):
        steps.append(("decode", rng.standard_normal(
            (B, 1, cfg.d_model), dtype=np.float32) / 4,
            np.full((B, 1), T + t), None, None))
    for mode, xs, ps, je, te in steps:
        want, jcache_l, _ = jtr.block_apply(
            jp_l, jnp.asarray(xs), cfg, "dec", positions=jnp.asarray(ps),
            cache=jcache_l, mode=mode, enc_out=je)
        got, _, _ = ttr.block_apply(
            tp_l, torch.from_numpy(xs), tm.cfg, "dec",
            positions=torch.from_numpy(ps), cache=tcache_l, mode=mode,
            enc_out=te)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=mode)
        for k in ("cross_k", "cross_v"):
            assert tuple(getattr(tcache_l, k).shape) == (B, Te, 4, 32)
            np.testing.assert_allclose(getattr(tcache_l, k).numpy(),
                                       np.asarray(jcache_l[k]), rtol=0,
                                       atol=LOGIT_ATOL)
        js, ts = jcache_l["self"], tcache_l.self_kv
        assert int(ts.pos) == int(js.pos)
        for jpl, tpl in ((js.k, ts.k), (js.v, ts.v)):
            np.testing.assert_array_equal(tpl.data.numpy(),
                                          np.asarray(jpl.data))
            np.testing.assert_array_equal(tpl.meta.numpy(),
                                          np.asarray(jpl.meta))
            # the scale is the slab's max |K| / qmax: an f32 ulp of the
            # projection moves it
            np.testing.assert_allclose(float(tpl.scale), float(jpl.scale),
                                       rtol=1e-6)


def _batch(cfg, rng, B, T):
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)),
            "frames": _frames(rng, B, T, cfg.d_model)}


def test_logits_and_loss_match_jax(wb):
    """Float logits and loss (the encoder over the frames, every decoder
    layer attending to its output) against the reference's jitted ones."""
    jm, tm = wb["jm"], wb["tm"]
    b = _batch(jm.cfg, np.random.default_rng(5), 2, 20)
    b["labels"] = np.concatenate([b["tokens"][:, 1:],
                                  np.full((2, 1), -1)], 1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(jm.logits)(wb["jp"], jb)
    got = tm.logits(wb["tp"], b)
    assert got.shape == (2, 20, jm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    jl, _ = jax.jit(jm.loss)(wb["jp"], jb)
    tl, _ = tm.loss(wb["tp"], b)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0,
                               atol=LOGIT_ATOL)


def test_quantized_model_matches_eager_jax(wb):
    """The serving computation: int8 weight codes and 5opt activations,
    the encoder under the serving ctx (no calibrated spans: each site
    takes its input's max |x| at run time), the decoder over the
    calibrated spans; the encoder's output and the logits against the
    reference's `_encode` and `forward` run eagerly (jitted, XLA's fusions
    move an activation by an ulp across a rounding boundary: one code,
    0.01 on an output row)."""
    jm, tm = wb["jm"], wb["tm"]
    b = _batch(jm.cfg, np.random.default_rng(6), 2, 16)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jctx = JCtx(mode="quantized", cfg=JCfg(**CODEC), impl="reference")
    tctx = TCtx(mode="quantized", cfg=TCfg(**CODEC))
    jscales = [{k: jnp.asarray(v.numpy()) for k, v in g.items()}
               for g in wb["tscales"]]
    with jax.disable_jit():
        jenc = np.asarray(jm._encode(wb["jq"], jb["frames"], jctx))
        x, _ = jm.forward(wb["jq"], jb, jctx, jscales)
        want = np.asarray(jm._head(wb["jq"], x))
    tenc = tm._encode(wb["tq"], b["frames"], tctx)
    np.testing.assert_allclose(tenc.numpy(), jenc, rtol=0, atol=LOGIT_ATOL)
    got = tm.logits(wb["tq"], b, tctx, wb["tscales"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


def test_calibration_spans_and_sites_equal_jax(wb):
    """`Model.calibrate` observes the decoder's dense sites only (the
    encoder runs in float, unobserved; the cross attention's products are
    float), with the reference's eager spans; `quant_sites` is the
    reference's dense list."""
    jm, tm = wb["jm"], wb["tm"]
    assert tm.quant_sites() == jm.quant_sites()
    jcal = [{k: jnp.asarray(v) for k, v in b.items()} for b in wb["calib"]]
    want = jm.calibrate(wb["jp"], jcal)
    assert [set(g) for g in wb["tscales"]] == [set(g) for g in want] == \
        [DEC_SITES]
    for tg, jg in zip(wb["tscales"], want):
        for site in tg:
            np.testing.assert_allclose(tg[site].numpy(), np.asarray(jg[site]),
                                       rtol=1e-6, atol=0, err_msg=site)


@pytest.mark.parametrize("layout", ["fp32", "sparq"])
def test_scan_engine_tokens_equal_jax(wb, layout):
    """The scan engine, batch 2, 16-token prompts with their 16 frames,
    gen 8, on the float model (its decoder's projections scaled) over an
    fp32 cache and over the 5opt sparq
    cache (K4's write and K5 at G 1 for the decoder's self attention; the
    cross K/V in float); tokens and the modeled cache bytes (the cross K/V
    at T_enc in the activation dtype, as the reference's prefill leaves
    them) equal JAX's."""
    jm, tm = wb["jm"], wb["tm"]
    # the decoder's projections x 5: at the init's scale every greedy
    # token repeats the one before it (a tied head and no position
    # signal), at this one the tokens follow the context
    jp = dict(wb["jp"], blocks=jax.tree_util.tree_map_with_path(
        lambda path, a: a * 5 if path[-1].key in PROJ else a,
        wb["jp"]["blocks"]))
    b = _batch(jm.cfg, np.random.default_rng(3), 2, 16)
    jcc, tcc = _layouts(layout)
    jtoks, jstats = jserve.DecodeEngine(jm, jcc).generate(
        jp, {k: jnp.asarray(v) for k, v in b.items()}, 8, warmup=False)
    eng = tserve.DecodeEngine(tm, tcc)
    ttoks, tstats = eng.generate(
        interop.params_from_jax(jax.tree.map(np.asarray, jp)), b, 8,
        warmup=False)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert len(np.unique(ttoks[0])) > 2
    for k in ("cache_data_bytes", "cache_total_bytes"):
        assert tstats[k] == jstats[k], k
    assert all(isinstance(c, tcache.DecCache) and c.cross_k.shape[1] == 16
               for c in eng.last_caches)


def test_caches_from_jax_and_their_bytes(wb):
    """After a JAX prefill over the sparq layout, `interop.cache_from_jax`
    turns each decoder layer's {"self", "cross_k", "cross_v"} dict into a
    `DecCache` with the same codes, scales, positions and cross K/V;
    `modeled_cache_bytes` gives the reference's tally (the cross K/V as
    other bytes at [B, T_enc, KV, hd]); a port decode step from them gives
    the JAX step's logits."""
    jm, tm = wb["jm"], wb["tm"]
    jcc, tcc = _layouts("sparq")
    b = _batch(jm.cfg, np.random.default_rng(9), 2, 12)
    jc = jm.init_cache(2, 20, cache_cfg=jcc)
    assert tcache.modeled_cache_bytes(tm.init_cache(2, 20, cache_cfg=tcc)) \
        == jcache.modeled_cache_bytes(jc)
    _, jc = jax.jit(jm.prefill)(wb["jp"], {k: jnp.asarray(v)
                                           for k, v in b.items()}, jc)
    tc = interop.cache_from_jax(jax.tree.map(np.asarray, jc), tcc)
    assert [type(c) for c in tc] == [tcache.DecCache] * jm.cfg.n_layers
    assert tcache.modeled_cache_bytes(tc) == jcache.modeled_cache_bytes(jc)
    for li, c in enumerate(tc):
        np.testing.assert_array_equal(c.cross_k.numpy(),
                                      np.asarray(jc[0]["cross_k"][li]))
        np.testing.assert_array_equal(c.self_kv.k.data.numpy(),
                                      np.asarray(jc[0]["self"].k.data[li]))
        assert int(c.self_kv.pos) == 12
    nxt = np.random.default_rng(5).integers(0, 512, (2, 1))
    jl, _ = jax.jit(jm.decode_step)(wb["jp"], jnp.asarray(nxt), jc,
                                    jnp.int32(12))
    tl = tm.decode_step(wb["tp"], torch.from_numpy(nxt), tc,
                        torch.tensor(12, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("window,ring", [(0, False), (CS.K2_WINDOW, True)])
def test_k5_emulation_at_g1(window, ring):
    """K5's split-key arithmetic (the numpy emulation of its body) at
    whisper-base's decode, `chip_smoke.K5_G1`: G 1 over 8 KV heads of 64,
    296 slots, bk 128, linear or ring kpos; within 1e-4 of the plain
    version and of the f64 evaluation."""
    g1 = CS.K5_G1
    args = _k5_case(7, B=g1["B"], Tk=g1["Tk"], KV=g1["KV"], G=g1["G"],
                    hd=g1["hd"], cur=g1["cur"], ring=ring)
    k, v, live = CS.contig_keys(*args[1:], window=window)
    got = emulate(args[0], k, v, live, 128)
    want = dec.ref_sparq_decode_attn(*args, window=window, bk=128)
    exact = CS.decode_f64_reference(args[0], k, v, live)
    assert float((got - want).abs().max()) <= 1e-4
    assert float((got.double() - exact).abs().max()) <= 1e-4


def test_paged_engine_refuses_encdec(wb):
    with pytest.raises(ValueError, match="standard-KV"):
        tserve.ContinuousBatchingEngine(
            wb["tm"], TCC.sparq_cache(TCfg(**CODEC)), device="cpu")


def test_cli_serves_whisper_on_cpu():
    """`--arch whisper-base --reduced --engine scan` on the CPU: int8
    weight codes over the 5opt sparq cache, the frames drawn by the
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
    """`repro_torch.launch.train` on the reduced whisper: its batches
    carry frames (the encoder is trained too), two steps, finite
    losses."""
    losses = ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
