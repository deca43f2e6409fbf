"""Port parity, the rest of the dense family: granite-20b (MQA, LayerNorm,
non-gated GELU, tied head), starcoder2-3b (GQA, LayerNorm, GELU, rope
theta 1e5) and mistral-large-123b (SwiGLU, weights in bf16), each on its
reduced config, against the JAX package.

The JAX model's weights go to the port through `interop`; both run in f32
on the same numpy tokens and calibrated scales. Tolerances are those of
tests/test_torch_model.py: logits within LOGIT_ATOL on O(1) values (XLA
and PyTorch sum norms, rope and attention in different orders), spans
within 1e-5 relative, integer state exact. `norm` and `ffn_apply` are held
to 1e-6 relative on their own: a handful of f32 ops each (the tanh GELU
on both sides; `jnp.var` is the population variance).
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
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import transformer as jtr
from repro.models.cache import CacheConfig as JCC
from repro.models.common import QuantCtx as JCtx
from repro.models.model import Model as JModel
from repro.models.quantize import quantize_params as jquantize
from repro_torch import interop
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tcfg
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.quantizer import div_qmax
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.model import Model as TModel
from repro_torch.models.quantize import _quantize_leaf
from repro_torch.models.quantize import quantize_params as tquantize

LOGIT_ATOL = 2e-4
FAMILY = ("granite-20b", "starcoder2-3b", "mistral-large-123b")
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


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


def _as_torch(v):
    return DTYPES.get(v, v) if not isinstance(v, (int, float, str, bool,
                                                  tuple)) else v


@pytest.mark.parametrize("arch", FAMILY)
def test_configs_equal_jax(arch):
    assert arch in ARCHS
    for jget, tget in ((jcfg, tcfg), (jcfg_reduced, tcfg_reduced)):
        jc, tc = jget(arch), tget(arch)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == _as_torch(getattr(jc, f.name)), \
                (arch, jc.name, f.name)
        assert tc.head_dim == jc.head_dim


@pytest.fixture(scope="module", params=FAMILY)
def pair(request):
    """The reduced config in both packages in f32, JAX weights and their
    interop copy, one calibration batch and the JAX spans."""
    arch = request.param
    jc = jcfg_reduced(arch).replace(dtype=jnp.float32, remat=False)
    tc = tcfg_reduced(arch).replace(dtype=torch.float32)
    jm, tm = JModel(jc), TModel(tc, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    calib = [{"tokens": np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 24))}]
    jscales = jm.calibrate(jp, [{"tokens": jnp.asarray(b["tokens"])}
                                for b in calib])
    return dict(arch=arch, jm=jm, jp=jp, tm=tm, tp=tp, calib=calib,
                jscales=jscales)


def test_norm_and_ffn_match_jax():
    """LayerNorm and RMSNorm, and the gelu, geglu and swiglu blocks, on
    the same f32 inputs and weights."""
    rng = np.random.default_rng(5)
    d, f = 96, 160
    x = (rng.standard_normal((3, 7, d)) * 2 + 0.5).astype(np.float32)
    for kind in ("layernorm", "rmsnorm"):
        p = {"scale": rng.standard_normal(d).astype(np.float32),
             "bias": rng.standard_normal(d).astype(np.float32)}
        if kind == "rmsnorm":
            p.pop("bias")
        want = np.asarray(jcommon.norm(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), kind, 1e-5))
        got = tcommon.norm(interop.to_torch(p), torch.from_numpy(x), kind,
                           1e-5).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=kind)
    for mlp in ("gelu", "geglu", "swiglu"):
        p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
             for k, s in (("w_up", (d, f)), ("w_down", (f, d)),
                          ("w_gate", (d, f)))}
        if mlp == "gelu":
            p.pop("w_gate")
        want = np.asarray(jffn.ffn_apply(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x), mlp))
        got = tffn.ffn_apply(interop.to_torch(p), torch.from_numpy(x),
                             mlp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=mlp)
    with pytest.raises(ValueError):
        tffn.ffn_apply(interop.to_torch(p), torch.from_numpy(x), "relu")


def _ctxs(mode):
    if mode == "off":
        return None, None
    codec = dict(enabled=False, signed=True) if mode == "a8w8" \
        else dict(bits=4, opts=5, signed=True)
    return (JCtx(mode="quantized", cfg=JCfg(**codec), impl="reference"),
            TCtx(mode="quantized", cfg=TCfg(**codec)))


def _jax_logits(jm, jp, toks, jctx, jscales):
    """The JAX model's logits, its layers applied one by one in eager mode
    (`transformer.block_apply` with each layer's spans). The scanned
    `Model.forward` compiles the layer body, and XLA then multiplies an
    activation span by the reciprocal of qmax where `dense` divides by it:
    an activation scale can lie an ulp away and move one code (starcoder2
    a8w8, layer 1's ffn_up here; ROADMAP §3, division by a constant). The
    eager layers divide, as the port does."""
    cfg = jm.cfg
    x, _ = jm._embed_in(jp, {"tokens": jnp.asarray(toks)}, cfg.dtype)
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1])[None], toks.shape)
    for li in range(cfg.n_layers):
        ctx = jctx if jctx is None else dataclasses.replace(
            jctx, scales={s: v[li] for s, v in jscales[0].items()})
        x, _, _ = jtr.block_apply(
            jax.tree.map(lambda a: a[li], jp["blocks"][0]), x, cfg, "dense",
            positions=pos, mode="train", ctx=ctx)
    x = jcommon.norm(jp["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return np.asarray(jm._head(jp, x))


def test_logits_spans_and_codes_match_jax(pair):
    """Logits in the modes off, a8w8 and 5opt with the JAX spans (and, in
    mode off, the scanned JAX forward's); the port's own calibration
    against them, on the JAX site set (gelu has no ffn_gate);
    `quantize_params` codes and scales bit for bit, and serving from them
    equals quantizing on the fly."""
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    jscales = pair["jscales"]
    ts = interop.scales_from_jax(jax.tree.map(np.asarray, jscales))
    toks = np.random.default_rng(1).integers(0, 512, (2, 20))
    jx, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(tm.logits(tp, {"tokens": toks}).numpy(),
                               np.asarray(jm._head(jp, jx)), rtol=0,
                               atol=LOGIT_ATOL, err_msg="scanned, off")
    for mode in ("off", "a8w8", "5opt"):
        jctx, tctx = _ctxs(mode)
        want = _jax_logits(jm, jp, toks, jctx, jscales)
        got = tm.logits(tp, {"tokens": toks}, tctx,
                        scales_groups=ts if tctx else None).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"{pair['arch']} {mode}")

    tscales = tm.calibrate(tp, pair["calib"])
    assert len(tscales) == len(jscales)
    gated = tm.cfg.mlp_type in tffn.GATED
    for jg, tg in zip(jscales, tscales):
        assert set(tg) == set(jg)
        assert ("ffn_gate" in jg) == gated
        for site in jg:
            np.testing.assert_allclose(tg[site].numpy(),
                                       np.asarray(jg[site]), rtol=1e-5,
                                       err_msg=site)

    jq = jax.tree.map(np.asarray, jquantize(jp))
    tq = tquantize(tp)
    for sub in ("attn", "ffn"):
        jb, tb = jq["blocks"][0][sub], tq["blocks"][0][sub]
        assert set(tb) == set(jb)
        for name in jb:
            for part in ("q", "s"):
                np.testing.assert_array_equal(tb[name][part].numpy(),
                                              jb[name][part], err_msg=name)
    if tm.cfg.norm_type == "layernorm":
        np.testing.assert_array_equal(
            tq["blocks"][0]["ln1"]["bias"].numpy(),
            jq["blocks"][0]["ln1"]["bias"])
    assert ("lm_head" in tq) == ("lm_head" in jq) == \
        (not tm.cfg.tie_embeddings)
    _, tctx = _ctxs("5opt")
    small = {"tokens": toks[:1, :12]}
    np.testing.assert_array_equal(
        tm.logits(tq, small, tctx, scales_groups=ts).numpy(),
        tm.logits(interop.params_from_jax(jq), small, tctx,
                  scales_groups=ts).numpy())


def _whole_leaf(leaf, bits=8):
    """The stacked leaf quantized at once (the formula `_quantize_leaf`
    applied to the whole [L, din, dout] leaf before it went slice by
    slice)."""
    s = torch.clamp(div_qmax(torch.amax(torch.abs(leaf), dim=1),
                             (1 << (bits - 1)) - 1), min=1e-8)
    codes = torch.clamp(torch.round(leaf / s[:, None, :]),
                        -127, 127).to(torch.int8)
    return codes, s.to(torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slice_by_slice_quantize_equals_whole_leaf(dtype):
    gen = torch.Generator().manual_seed(3)
    leaf = (torch.randn((5, 48, 40), generator=gen)
            * torch.rand((5, 1, 40), generator=gen) * 3).to(dtype)
    leaf[2, :, 7] = 0.0                        # a dead channel: the floor
    got = _quantize_leaf(leaf, 8)
    codes, s = _whole_leaf(leaf)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert torch.equal(got["q"], codes) and torch.equal(got["s"], s)


@pytest.mark.parametrize("arch", FAMILY)
def test_bf16_init_layout_equals_jax(arch):
    """`init_params(dtype=bf16)` gives the JAX `init_params(key,
    jnp.bfloat16)` tree: the same keys, shapes and dtypes (norms f32); the
    default dtype is the config's `param_dtype`."""
    jc, tc = jcfg_reduced(arch), tcfg_reduced(arch)
    jp = JModel(jc).init_params(jax.random.PRNGKey(0), jnp.bfloat16)
    tm = TModel(tc, device="cpu")
    tp = tm.init_params(0, dtype=torch.bfloat16)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype) == f"torch.{j.dtype.name}", path
    default = tm.init_params(0)
    want = tc.param_dtype
    assert default["blocks"][0]["attn"]["wq"].dtype == want
    assert default["embed"].dtype == want
    # an f32 init, slice by slice, is the bf16 one before its cast
    f32 = tm.init_params(0, dtype=torch.float32)
    for path, t in tleaves:
        leaf = f32
        for k in path:
            leaf = leaf[k.key if hasattr(k, "key") else k.idx]
        assert torch.equal(leaf.to(t.dtype), t), path


def _trace(vocab, seed=7):
    """tests/test_prefill.py::_trace: ragged lengths, staggered arrivals."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (L,)), g, a)
            for L, g, a in zip([5, 11, 3, 9, 14, 6], [7, 5, 9, 6, 4, 8],
                               [0, 0, 2, 3, 5, 7])]


@pytest.mark.parametrize("arch", ["granite-20b", "starcoder2-3b"])
def test_paged_chunked_engine_tokens_equal_jax(arch):
    """The port's paged chunked engine against the JAX engine (5opt, int8
    weights, calibrated scales) on a short staggered trace: MQA (one KV
    head) and GQA with LayerNorm and GELU."""
    jc = jcfg_reduced(arch).replace(dtype=jnp.float32, remat=False)
    tc = tcfg_reduced(arch).replace(dtype=torch.float32)
    jm, tm = JModel(jc), TModel(tc, device="cpu")
    jp = jquantize(jm.init_params(jax.random.PRNGKey(0)))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    calib = [{"tokens": jnp.asarray(np.random.default_rng(11).integers(
        0, jc.vocab_size, (2, 16)))}]
    jscales = jm.calibrate(jp, calib)
    tscales = interop.scales_from_jax(jax.tree.map(np.asarray, jscales))
    jcodec, tcodec = JCfg(bits=4, opts=5, signed=True), \
        TCfg(bits=4, opts=5, signed=True)
    kw = dict(page_size=4, n_pages=24, max_active=3, max_seq_len=24,
              prefill="chunked", chunk_size=16, chunk_align=4, chunk_seg=8)
    trace = _trace(jc.vocab_size)
    jres, jstats = jserve.ContinuousBatchingEngine(
        jm, JCC.sparq_cache(jcodec, impl="reference"),
        JCtx(mode="quantized", cfg=jcodec, impl="reference"), jscales,
        **kw).run(jp, [jserve.Request(t, g, arrive_at=a)
                       for t, g, a in trace])
    tres, tstats = tserve.ContinuousBatchingEngine(
        tm, tserve.make_cache_config("sparq", tcodec),
        TCtx(mode="quantized", cfg=tcodec), tscales, device="cpu",
        **kw).run(tp, [tserve.Request(t, g, arrive_at=a)
                       for t, g, a in trace])
    assert set(tres) == set(jres) == set(range(len(trace)))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"{arch} request {rid}")
    for k in ("decode_steps", "prefill_chunks", "peak_pages_used",
              "cache_total_bytes"):
        assert tstats[k] == jstats[k], k
    assert tstats["free_pages_after"] == kw["n_pages"]


@pytest.mark.parametrize("arch", FAMILY)
def test_cli_serves_the_family_on_cpu(arch, tmp_path):
    """`--arch ... --reduced` through the paged chunked engine with the
    telemetry flags, on the CPU."""
    prom = tmp_path / "m.prom"
    stats = tserve.main([
        "--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "12",
        "--gen", "3", "--page-size", "4", "--chunk-size", "16",
        "--chunk-align", "4", "--calibrate", "1", "--prequantize",
        "--engine", "paged", "--prefill", "chunked", "--kv-cache", "sparq",
        "--sparq", "5opt", "--device", "cpu", "--metrics-dump", str(prom),
        "--trace-out", str(tmp_path / "t.json")])
    assert stats["decode_tokens"] == 2 * (3 - 1)
    assert stats["free_pages_after"] == stats["pool_pages"]
    assert "engine_decode_steps_total" in prom.read_text()
