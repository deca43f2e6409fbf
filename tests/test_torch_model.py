"""Port parity, dense decoder: the JAX model and the port share weights
through `repro_torch.interop` and see the same numpy tokens.

Tolerances: both run in f32. Norms, rope and attention sum in different
orders in XLA and PyTorch, a few f32 ulps per op. In the quantized modes
an activation that lands within an ulp of a rounding boundary can move
one integer code, so the tests feed both packages the same calibrated
scales and hold logits to atol 2e-4 on O(1) values (a code flip moves a
logit by ~1e-3 at these widths; none occur on these inputs). Integer
state — weight codes, page bytes, scales, positions — must be exact.
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
from repro.models import paging as jpaging
from repro.models.cache import CacheConfig as JCC
from repro.models.common import QuantCtx as JCtx
from repro.models.model import Model as JModel
from repro.models.quantize import quantize_params as jquantize
from repro_torch import interop
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.models import paging as tpaging
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.model import Model as TModel
from repro_torch.models.quantize import quantize_params as tquantize

LOGIT_ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _no_activation_spec():
    """The JAX model constrains activations to a module-global spec that
    a training test earlier in the same worker may have left set; the
    parity runs here are single-device and unsharded."""
    set_activation_spec(None)
    yield


@pytest.fixture(scope="module")
def pair():
    jc = jcfg_reduced("tinyllama-1.1b").replace(dtype=jnp.float32,
                                                remat=False)
    tc = tcfg_reduced("tinyllama-1.1b").replace(dtype=torch.float32)
    jm = JModel(jc)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = TModel(tc, device="cpu")
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(0, jc.vocab_size, (2, 24))}]
    jscales = jm.calibrate(jp, [{"tokens": jnp.asarray(b["tokens"])}
                                for b in calib])
    return jm, jp, tm, tp, calib, jscales


def _ctxs(mode):
    if mode == "off":
        return None, None
    codec = dict(enabled=False, signed=True) if mode == "a8w8" \
        else dict(bits=4, opts=5, signed=True)
    return (JCtx(mode="quantized", cfg=JCfg(**codec), impl="reference"),
            TCtx(mode="quantized", cfg=TCfg(**codec)))


@pytest.mark.parametrize("mode", ["off", "a8w8", "5opt"])
def test_logits_match(pair, mode):
    jm, jp, tm, tp, calib, jscales = pair
    jctx, tctx = _ctxs(mode)
    toks = np.random.default_rng(1).integers(0, 512, (2, 20))
    jx, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, jctx,
                       scales_groups=jscales if jctx else None)
    want = np.asarray(jm._head(jp, jx))
    got = tm.logits(tp, {"tokens": toks}, tctx,
                    scales_groups=interop.scales_from_jax(
                        jax.tree.map(np.asarray, jscales))
                    if tctx else None).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_calibrated_scales_match(pair):
    """Calibrated spans: the first site of each layer sees the same
    normed input; later sites inherit f32 reordering, so the spans are
    held to 1e-5 relative (a max over activations, not an integer)."""
    jm, jp, tm, tp, calib, jscales = pair
    tscales = tm.calibrate(tp, calib)
    assert len(tscales) == len(jscales)
    for jg, tg in zip(jscales, tscales):
        assert set(jg) == set(tg) == set(tm.quant_sites())
        for site in jg:
            np.testing.assert_allclose(tg[site].numpy(),
                                       np.asarray(jg[site]), rtol=1e-5)


def test_quantize_params_codes_equal(pair):
    jm, jp, tm, tp, calib, jscales = pair
    jq = jax.tree.map(np.asarray, jquantize(jp))
    tq = tquantize(tp)
    blk_j, blk_t = jq["blocks"][0], tq["blocks"][0]
    for sub, name in [("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                      ("attn", "wo"), ("ffn", "w_gate"), ("ffn", "w_up"),
                      ("ffn", "w_down")]:
        np.testing.assert_array_equal(blk_j[sub][name]["q"],
                                      blk_t[sub][name]["q"].numpy())
        np.testing.assert_array_equal(blk_j[sub][name]["s"],
                                      blk_t[sub][name]["s"].numpy())
    assert isinstance(tq["embed"], torch.Tensor)      # boundary stays float
    # serving from prequantized codes == quantizing on the fly
    jctx, tctx = _ctxs("5opt")
    ts = interop.scales_from_jax(jax.tree.map(np.asarray, jscales))
    toks = {"tokens": np.random.default_rng(2).integers(0, 512, (1, 12))}
    a = tm.logits(tq, toks, tctx, scales_groups=ts)
    b = tm.logits(interop.params_from_jax(jq), toks, tctx, scales_groups=ts)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _stores(S=3, P=10, ps=4, NB=4, KV=2, hd=16, codec=None):
    jcodec = JCfg.opt5(signed=True) if codec is None else codec[0]
    tcodec = TCfg.opt5(signed=True) if codec is None else codec[1]
    js = jpaging.PagedCacheStore.init(S, P, ps, NB, KV, hd,
                                      JCC.sparq_cache(jcodec, "reference"))
    ts = tpaging.PagedCacheStore.init(S, P, ps, NB, KV, hd,
                                      TCC.sparq_cache(tcodec), "cpu")
    bt = np.array([[2, 5, -1, -1], [0, -1, -1, -1], [7, 1, 3, -1]],
                  np.int32)
    js = dataclasses.replace(js, block_table=jnp.asarray(bt))
    ts.block_table = torch.from_numpy(bt.copy())
    return js, ts


def _assert_same_store(js, ts):
    for name in ("k_data", "k_meta", "v_data", "v_meta"):
        # the trash page (last) takes padding writes in an undefined
        # order in both frameworks; every live page must match exactly
        np.testing.assert_array_equal(np.asarray(getattr(js, name))[:-1],
                                      getattr(ts, name).numpy()[:-1],
                                      err_msg=name)
    for name in ("k_scale", "v_scale", "seq_pos"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("codec", ["5opt", "a8w8"])
def test_write_chunk_and_update_bytes_identical(codec):
    """One chunk (slot 0 first segment + slot 2 mid-prompt segment +
    padding) then two decode updates with an inactive slot: identical
    pool bytes, frozen scales and positions."""
    cc = None if codec == "5opt" else (JCfg(enabled=False, signed=True),
                                       TCfg(enabled=False, signed=True))
    js, ts = _stores(codec=cc)
    rng = np.random.default_rng(3)
    C = 12
    seq_id = np.array([0] * 6 + [2] * 4 + [-1] * 2, np.int32)
    pos = np.array(list(range(6)) + list(range(4, 8)) + [0, 0], np.int32)
    hist = np.array([0] * 6 + [4] * 4 + [0, 0], np.int32)
    tile_seq = np.array([0, 0, 0, 2, 2, -1], np.int32)
    spa = np.array([6, -1, -1], np.int32)
    k = rng.standard_normal((C, 2, 16)).astype(np.float32)
    v = rng.standard_normal((C, 2, 16)).astype(np.float32)
    jmeta = jpaging.ChunkMeta(*map(jnp.asarray, (seq_id, pos, hist,
                                                 tile_seq, spa)))
    tmeta = tpaging.ChunkMeta(*map(torch.from_numpy, (seq_id, pos, hist,
                                                      tile_seq, spa)))
    # jitted: the eager JAX codec dispatches hundreds of tiny ops
    j_write = jax.jit(lambda st, k_, v_, m_: st.write_chunk(k_, v_, m_))
    j_update = jax.jit(lambda st, k_, v_: st.update(k_, v_))
    js = j_write(js, jnp.asarray(k), jnp.asarray(v), jmeta)
    ts = ts.write_chunk(torch.from_numpy(k), torch.from_numpy(v), tmeta)
    _assert_same_store(js, ts)
    assert float(ts.k_scale[2]) == 0.0      # no first-segment token: unset
    for _ in range(2):
        kn = rng.standard_normal((3, 1, 2, 16)).astype(np.float32)
        vn = rng.standard_normal((3, 1, 2, 16)).astype(np.float32)
        js = j_update(js, jnp.asarray(kn), jnp.asarray(vn))
        ts = ts.update(torch.from_numpy(kn), torch.from_numpy(vn))
        _assert_same_store(js, ts)
