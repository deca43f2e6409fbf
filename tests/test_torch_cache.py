"""Port parity, contiguous-cache kernels and cache: the plain versions of
K4 (quant), K6 (dequant) and K5 (contiguous flash-decode), and
`CachedTensor`/`CacheStore`, against `repro.kernels` (its jnp oracles and
its Pallas kernels in interpret mode) and `repro.models.cache`.

Tolerances: the codec (K4, K6) is integer arithmetic after one IEEE f32
division, so it must be exact, and so must every cache byte and scale.
K5 sums f32 products in the order each framework's einsum picks, a few
f32 ulps on O(1) inputs: held to rtol = atol = 1e-5. Against the port's
own K2 plain version, K5 with bk == page_size runs the same f32
operations tile for tile and must agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparq import SparqConfig as JCfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sparq_decode_attn import sparq_decode_attn_pallas
from repro.kernels.sparq_dequant import sparq_dequant_pallas
from repro.kernels.sparq_quant import sparq_quant_pallas
from repro.models import cache as jcache
from repro.models.cache import CacheConfig as JCC
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sparq_decode_attn import ref_sparq_decode_attn
from repro_torch.models import cache as tcache
from repro_torch.models.cache import CacheConfig as TCC
from test_torch_kernels import CODECS, _kw, _random_pool, _t

ATOL = RTOL = 1e-5


def _x(shape, signed, seed=0, sparsity=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if not signed:
        x = np.maximum(x, 0)
    x[rng.random(shape) < sparsity] = 0.0      # exercise vSPARQ's pair rule
    return x


# ----------------------------------------------------------------------
# K4: quant
# ----------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS, ids=lambda c: str(c))
def test_quant_plain_matches_oracle_and_pallas(codec):
    """ops.sparq_quantize (plain) == the JAX oracle == the Pallas kernel in
    interpret mode, codes and meta, with one scale; and == the oracle with
    one scale per row on a ragged M (the paged write's form)."""
    jc, tc = JCfg(**codec), TCfg(**codec)
    x = _x((24, 64), jc.signed)
    a = np.float32(np.abs(x).max() / jc.max_val)
    jcodes, jmeta = jref.ref_sparq_quant(jnp.asarray(x), jnp.float32(a),
                                         **_kw(jc))
    pcodes, pmeta = sparq_quant_pallas(jnp.asarray(x), jnp.float32(a),
                                       bm=8, interpret=True, **_kw(jc))
    tcodes, tmeta = tops.sparq_quantize(_t(x), torch.tensor(a), tc)
    for want in (jcodes, pcodes):
        np.testing.assert_array_equal(np.asarray(want), tcodes.numpy())
    for want in (jmeta, pmeta):
        np.testing.assert_array_equal(np.asarray(want), tmeta.numpy())
    # per-row scale, ragged M, leading dims flattened
    x3 = _x((7, 3, 16), jc.signed, seed=1)
    rows = (np.abs(x3).max(-1) / jc.max_val).astype(np.float32) + 1e-3
    jcodes, jmeta = jref.ref_sparq_quant(jnp.asarray(x3),
                                         jnp.asarray(rows)[..., None],
                                         **_kw(jc))
    tcodes, tmeta = tops.sparq_quantize(_t(x3), _t(rows.reshape(-1)), tc)
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())
    np.testing.assert_array_equal(np.asarray(jmeta), tmeta.numpy())


def test_quant_rejects_bad_scale():
    with pytest.raises(ValueError, match="one per row"):
        tops.sparq_quantize(torch.zeros(4, 8), torch.ones(3),
                            TCfg.opt5(signed=True))


# ----------------------------------------------------------------------
# K6: dequant
# ----------------------------------------------------------------------

def test_dequant_every_byte_pair_exact():
    """All 256 store bytes x all 256 meta bytes (including -128), each
    pair on an even and on an odd lane: plain == oracle == Pallas."""
    b = np.arange(-128, 128, dtype=np.int8)
    store = np.repeat(b, 256)
    meta = np.tile(b, 256)
    # the rolled copy moves every (store, meta) pair to the other parity
    store = np.concatenate([store, np.roll(store, 1)]).reshape(-1, 128)
    meta = np.concatenate([meta, np.roll(meta, 1)]).reshape(-1, 128)
    got = tops.sparq_dequantize(_t(store), _t(meta)).numpy()
    want = np.asarray(jref.ref_sparq_dequant(jnp.asarray(store),
                                             jnp.asarray(meta)))
    pal = np.asarray(sparq_dequant_pallas(jnp.asarray(store),
                                          jnp.asarray(meta), bm=256,
                                          interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)
    assert got.dtype == np.int8


def test_dequant_inverts_quant_and_pack():
    """dequant(pack(quant(x))) == quant(x)'s codes, ragged leading dims."""
    tc = TCfg.opt5(signed=True)
    x = _t(_x((5, 3, 2, 16), True, seed=2))
    codes, meta = tops.sparq_quantize(x, torch.tensor(0.01), tc)
    back = tops.sparq_dequantize(tops.sparq_pack(codes, meta), meta)
    assert torch.equal(back, codes)


# ----------------------------------------------------------------------
# K5: contiguous flash-decode
# ----------------------------------------------------------------------

def _contig_case(seed=0, B=3, Tk=37, KV=2, G=4, hd=16, ring=False):
    rng = np.random.default_rng(seed)
    kd, km = _random_pool(rng, B, Tk, KV, hd)
    vd, vm = _random_pool(rng, B, Tk, KV, hd)
    q = rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)
    kpos = np.broadcast_to(np.arange(Tk, dtype=np.int32), (B, Tk)).copy()
    if ring:    # rotated ring slots, some never written (-1)
        kpos = np.roll(kpos, 11, axis=1) + 5
        kpos[:, 3:7] = -1
    return q, kd, km, vd, vm, kpos


@pytest.mark.parametrize("window,ring", [(0, False), (12, False),
                                         (0, True), (9, True)])
def test_contiguous_decode_plain_matches_oracle_and_pallas(window, ring):
    """Ragged Tk (37 over bk 16: a partial last tile), with and without a
    window, linear and ring-rotated kpos with empty (-1) slots."""
    q, kd, km, vd, vm, kpos = _contig_case(ring=ring)
    ks, vs, cur = np.float32(0.02), np.float32(0.015), np.int32(30)
    jargs = (jnp.asarray(q), jnp.asarray(kd), jnp.asarray(km),
             jnp.float32(ks), jnp.asarray(vd), jnp.asarray(vm),
             jnp.float32(vs), jnp.asarray(kpos), jnp.int32(cur))
    want = np.asarray(jops.sparq_decode_attention(
        *jargs, window=window, impl="reference", bk=16))
    pal = np.asarray(jops.sparq_decode_attention(
        *jargs, window=window, impl="pallas", bk=16))
    got = tops.sparq_decode_attention(
        _t(q), _t(kd), _t(km), torch.tensor(ks), _t(vd), _t(vm),
        torch.tensor(vs), _t(kpos), torch.tensor(cur), window=window,
        bk=16).numpy()
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)


def test_contiguous_decode_kernel_signature_oracle():
    """The bare plain version against the bare Pallas kernel on a Tk that
    is a tile multiple (no dispatcher padding on either side)."""
    q, kd, km, vd, vm, kpos = _contig_case(Tk=32)
    B, _, H, hd = q.shape
    qg = q.reshape(B, 2, H // 2, hd)
    s = np.float32(0.02)
    want = np.asarray(sparq_decode_attn_pallas(
        jnp.asarray(qg), jnp.asarray(kd), jnp.asarray(km), jnp.float32(s),
        jnp.asarray(vd), jnp.asarray(vm), jnp.float32(s), jnp.asarray(kpos),
        jnp.int32(20), bk=8, interpret=True))
    got = ref_sparq_decode_attn(_t(qg), _t(kd), _t(km), torch.tensor(s),
                                _t(vd), _t(vm), torch.tensor(s), _t(kpos),
                                torch.tensor(20, dtype=torch.int32),
                                bk=8).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cur,window", [(19, 0), (31, 0), (19, 12),
                                        (30, 12)])
def test_contiguous_bk_page_size_equals_paged_bitwise(cur, window):
    """One page == one Tk tile: the same bytes laid out as pages through a
    permuted block table give K2's plain version bit for bit."""
    B, KV, G, hd, ps, NB = 3, 2, 4, 16, 8, 4
    q, kd, km, vd, vm, kpos = _contig_case(seed=4, B=B, Tk=NB * ps, KV=KV,
                                           G=G, hd=hd)
    rng = np.random.default_rng(9)
    P = B * NB + 2
    bt = rng.permutation(P)[:B * NB].reshape(B, NB).astype(np.int32)
    pools = [np.zeros((P, ps, KV, hd), np.int8) for _ in range(4)]
    for pool, plane in zip(pools, (kd, km, vd, vm)):
        for b in range(B):
            for t in range(NB):
                pool[bt[b, t]] = plane[b, t * ps:(t + 1) * ps]
    s = np.float32(0.02)
    want = tops.sparq_decode_attention(
        _t(q), _t(kd), _t(km), torch.tensor(s), _t(vd), _t(vm),
        torch.tensor(s), _t(kpos), torch.tensor(cur, dtype=torch.int32),
        window=window, bk=ps)
    sv = torch.full((B,), float(s))
    got = tops.sparq_paged_decode_attention(
        _t(q), _t(pools[0]), _t(pools[1]), sv, _t(pools[2]), _t(pools[3]),
        sv, _t(bt), torch.full((B,), cur, dtype=torch.int32), window=window)
    assert torch.equal(want, got)


# ----------------------------------------------------------------------
# CachedTensor / CacheStore
# ----------------------------------------------------------------------

CACHE_CODECS = [("5opt", dict(bits=4, opts=5, signed=True)),
                ("a8w8", dict(enabled=False, signed=True)),
                ("fp32", None)]


def _cache_pair(codec, shape):
    if codec is None:
        return (jcache.CacheStore.init(shape, JCC.fp32()),
                tcache.CacheStore.init(shape, TCC.fp32(), "cpu"))
    return (jcache.CacheStore.init(
                shape, JCC.sparq_cache(JCfg(**codec), impl="reference")),
            tcache.CacheStore.init(shape, TCC.sparq_cache(TCfg(**codec)),
                                   "cpu"))


def _assert_same_cache(js, ts):
    for jp, tp in ((js.k, ts.k), (js.v, ts.v)):
        np.testing.assert_array_equal(np.asarray(jp.data), tp.data.numpy())
        if jp.meta is not None:
            np.testing.assert_array_equal(np.asarray(jp.meta),
                                          tp.meta.numpy())
        np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
        np.testing.assert_array_equal(np.asarray(jp.read()),
                                      tp.read().numpy())
    assert int(js.pos) == int(ts.pos)


@pytest.mark.parametrize("name,codec", CACHE_CODECS,
                         ids=[c[0] for c in CACHE_CODECS])
def test_cache_store_update_read_and_bytes_match(name, codec):
    """A prefill slab, then two decode tokens whose range exceeds the
    prefill's: identical planes, the scale frozen at the first write,
    identical read() and modeled bytes."""
    shape = (2, 12, 2, 16)
    js, ts = _cache_pair(codec, shape)
    rng = np.random.default_rng(6)
    update = jax.jit(lambda c, k, v: c.update(k, v))
    frozen = None
    for T, amp in ((5, 1.0), (1, 3.0), (1, 3.0)):
        k = (rng.standard_normal((2, T, 2, 16)) * amp).astype(np.float32)
        v = (rng.standard_normal((2, T, 2, 16)) * amp).astype(np.float32)
        k[rng.random(k.shape) < 0.25] = 0.0
        js = update(js, jnp.asarray(k), jnp.asarray(v))
        ts.update(_t(k), _t(v))
        _assert_same_cache(js, ts)
        if frozen is None:
            frozen = ts.k.scale.clone()
            if codec is not None:       # the prefill slab's own range
                assert float(frozen) == np.float32(
                    np.float32(np.abs(k).max()) / np.float32(127))
        assert torch.equal(ts.k.scale, frozen)   # later writes reuse it
    assert jcache.modeled_cache_bytes([js]) == \
        tcache.modeled_cache_bytes([ts])
    jcc = JCC.fp32() if codec is None else JCC.sparq_cache(JCfg(**codec))
    tcc = TCC.fp32() if codec is None else TCC.sparq_cache(TCfg(**codec))
    assert tcache.ctrl_bytes_per_value(tcc) == jcache.ctrl_bytes_per_value(jcc)
    assert tcache.bytes_per_value(tcc) == jcache.bytes_per_value(jcc)


def test_cache_write_clamps_at_capacity_as_reference():
    """A slab written past the end lands at the last slots (the
    reference's dynamic_update_slice clamp), not out of bounds."""
    shape = (1, 6, 1, 4)
    js, ts = _cache_pair(dict(bits=4, opts=5, signed=True), shape)
    x = np.arange(1, 17, dtype=np.float32).reshape(1, 4, 1, 4)
    js = js._replace(pos=jnp.int32(4))
    ts.pos = torch.tensor(4, dtype=torch.int32)
    js = js.update(jnp.asarray(x), jnp.asarray(x))
    ts.update(_t(x), _t(x))
    _assert_same_cache(js, ts)
