"""Port parity, kernel layer: the plain PyTorch versions of the three
hand-written kernels, and the KV codec, against `repro.kernels` (its jnp
oracles and its Pallas kernels in interpret mode) on the grids of
tests/test_kernels.py, test_paging.py and test_prefill.py.

Tolerances: the quantized matmul and the codec are integer arithmetic
with one fixed f32 epilogue order, so they must be exact. The attention
functions sum f32 products in an order each framework's einsum picks; on
O(1) inputs that moves results by a few f32 ulps, so they are held to
rtol = atol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparq import SparqConfig as JCfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sparq_decode_attn import sparq_paged_decode_attn_pallas
from repro.kernels.sparq_matmul import sparq_matmul_pallas
from repro.kernels.sparq_prefill_attn import sparq_chunked_prefill_attn_pallas
from repro_torch.core.quantizer import QScale as TQScale
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.sparq_decode_attn import ref_sparq_paged_decode_attn
from repro_torch.kernels.sparq_prefill_attn import \
    ref_sparq_chunked_prefill_attn

ATOL = RTOL = 1e-5
CODECS = [
    dict(bits=4, opts=5, signed=True),
    dict(bits=4, opts=3, signed=True, rounding=False),
    dict(bits=4, opts=2, signed=True),
    dict(bits=3, opts=6, signed=True),
    dict(bits=2, opts=7, signed=True, vsparq=False),
    dict(bits=4, opts=5, signed=False),          # paper's unsigned mode
    dict(bits=4, opts=3, signed=False, vsparq=False),
    dict(enabled=False, signed=True),            # plain A8W8
    # the rest of the paper's CNN codecs (unsigned post-ReLU codes)
    dict(bits=4, opts=2, signed=False),
    dict(bits=3, opts=6, signed=False, rounding=False),
    dict(bits=2, opts=7, signed=False, vsparq=False),
    dict(enabled=False, signed=False),           # uniform A8W8
    dict(enabled=False, signed=False, act_bits=4),   # naive A4W8
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _kw(cfg):
    return dict(bits=cfg.bits, opts_shifts=cfg.shifts, rounding=cfg.rounding,
                vsparq=cfg.vsparq, signed=cfg.signed, max_val=cfg.max_val,
                enabled=cfg.enabled)


def _mm_inputs(m, k, n, signed, seed=0, sparsity=0.3, qmax=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if not signed:
        x = np.maximum(x, 0)
    x[rng.random((m, k)) < sparsity] = 0.0     # exercise vSPARQ's pair rule
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    cs = (np.abs(w).max(0) / 127).astype(np.float32)
    codes = np.clip(np.round(w / cs), -127, 127).astype(np.int8)
    qmax = qmax or (127 if signed else 255)
    a = np.float32(np.abs(x).max()) / np.float32(qmax)
    return x, codes, a, cs


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: str(c))
@pytest.mark.parametrize("shape", [(16, 128, 64), (40, 70, 24),
                                   (32, 144, 16), (24, 216, 24)])
def test_quantized_matmul_exact(codec, shape):
    """Plain version == JAX quantized_matmul (reference) == the Pallas
    kernel in interpret mode, bit for bit, for every codec of
    test_kernels.py and the paper's CNN, including a ragged shape (M, K, N
    not tile multiples; K padded in whole pairs) and the CNN's im2col
    shapes (K = 9 * cin, N 16 and 24)."""
    m, k, n = shape
    jc, tc = JCfg(**codec), TCfg(**codec)
    x, codes, a, cs = _mm_inputs(m, k, n, jc.signed, qmax=jc.max_val)
    from repro.core.quantizer import QScale as JQScale
    want = np.asarray(jops.quantized_matmul(
        jnp.asarray(x), jnp.asarray(codes),
        JQScale(jnp.float32(a), 8, jc.signed), jnp.asarray(cs), jc,
        impl="reference"))
    got = tops.quantized_matmul(_t(x), _t(codes),
                                TQScale(torch.tensor(a), 8, tc.signed),
                                _t(cs), tc).numpy()
    np.testing.assert_array_equal(want, got)
    if shape == (16, 128, 64):
        pal = np.asarray(sparq_matmul_pallas(
            jnp.asarray(x), jnp.asarray(codes), jnp.float32(a),
            jnp.asarray(cs), bm=16, bn=64, bk=64, interpret=True,
            **_kw(jc)))
        np.testing.assert_array_equal(pal, got)


def test_quantized_matmul_bf16_and_leading_dims():
    jc, tc = JCfg.opt5(signed=True), TCfg.opt5(signed=True)
    x, codes, a, cs = _mm_inputs(12, 64, 32, True, seed=3)
    x3 = x.reshape(3, 4, 64)
    from repro.core.quantizer import QScale as JQScale
    want = jops.quantized_matmul(
        jnp.asarray(x3, jnp.bfloat16), jnp.asarray(codes),
        JQScale(jnp.float32(a), 8, True), jnp.asarray(cs), jc,
        impl="reference")
    got = tops.quantized_matmul(_t(x3).to(torch.bfloat16), _t(codes),
                                TQScale(torch.tensor(a), 8, True), _t(cs), tc)
    assert got.shape == (3, 4, 32)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(ValueError):
        tops.quantized_matmul(_t(x[:, :63]), _t(codes[:63]),
                              TQScale(torch.tensor(a), 8, True), _t(cs), tc)


def test_dispatch_rejects_other_devices():
    q = torch.zeros((2, 1, 4, 8), device="meta")
    pool = torch.zeros((3, 4, 2, 8), dtype=torch.int8, device="meta")
    sc = torch.zeros((2,), device="meta")
    bt = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no SPARQ kernel"):
        tops.sparq_paged_decode_attention(q, pool, pool, sc, pool, pool, sc,
                                          bt, sc.to(torch.int32))


@pytest.mark.parametrize("codec", [CODECS[0], CODECS[1], CODECS[4],
                                   CODECS[7]], ids=lambda c: str(c))
def test_kv_codec_quant_pack_meta_exact(codec):
    """ref_sparq_quant, sparq_pack, meta_shifts and _meta_decode32 (the KV
    write and read datapath) bit for bit, per lane of the last axis, with
    a per-slot scale broadcast over leading axes."""
    jc, tc = JCfg(**codec), TCfg(**codec)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[rng.random(x.shape) < 0.25] = 0.0
    sc = (np.abs(x).max(axis=(1, 2, 3)) / jc.max_val).astype(np.float32)
    jcodes, jmeta = jref.ref_sparq_quant(jnp.asarray(x),
                                         jnp.asarray(sc)[:, None, None, None],
                                         **_kw(jc))
    tcodes, tmeta = tref.ref_sparq_quant(_t(x), _t(sc)[:, None, None, None],
                                         **_kw(tc))
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())
    np.testing.assert_array_equal(np.asarray(jmeta), tmeta.numpy())
    jdata = jops.sparq_pack(jcodes, jmeta)
    tdata = tops.sparq_pack(tcodes, tmeta)
    np.testing.assert_array_equal(np.asarray(jdata), tdata.numpy())
    np.testing.assert_array_equal(np.asarray(jref.meta_shifts(jmeta)),
                                  tref.meta_shifts(tmeta).numpy())
    np.testing.assert_array_equal(
        np.asarray(jref._meta_decode32(jdata, jmeta, jnp.float32(0.37))),
        tref._meta_decode32(tdata, tmeta, torch.tensor(0.37)).numpy())
    assert tops.bytes_per_value(tc) == jops.bytes_per_value(jc)
    assert tops.data_bytes_per_value(tc) == jops.data_bytes_per_value(jc)


def _random_pool(rng, P, ps, KV, hd):
    """Packed planes as the codec writes them: window codes in [-15, 15]
    (or full int8 magnitudes on mux'd lanes) and arbitrary meta bytes."""
    data = rng.integers(-15, 16, (P, ps, KV, hd)).astype(np.int8)
    meta = rng.integers(0, 128, (P, ps, KV, hd)).astype(np.int8)
    return data, meta


def _decode_case(seed=0, B=4, KV=2, G=4, hd=16, ps=8, NB=5, P=24):
    rng = np.random.default_rng(seed)
    kd, km = _random_pool(rng, P, ps, KV, hd)
    vd, vm = _random_pool(rng, P, ps, KV, hd)
    bt = rng.permutation(P - 1)[:B * NB].reshape(B, NB).astype(np.int32)
    bt[1, 3:] = -1                      # partially allocated table
    cur = np.array([NB * ps - 1, 2 * ps + 3, -1, 5], np.int32)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    ks = (rng.random(B) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random(B) * 0.02 + 0.005).astype(np.float32)
    return q, kd, km, ks, vd, vm, vs, bt, cur


@pytest.mark.parametrize("window", [0, 12])
def test_paged_decode_plain_matches_oracle_and_pallas(window):
    """Ragged cur (full, mid-page, an inactive slot, one page), a partially
    allocated block table, with and without a window."""
    args = _decode_case()
    want = np.asarray(jref.ref_sparq_paged_decode_attn(
        *map(jnp.asarray, args), window=window))
    pal = np.asarray(sparq_paged_decode_attn_pallas(
        *map(jnp.asarray, args), window=window, interpret=True))
    got = ref_sparq_paged_decode_attn(*map(_t, args), window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)
    assert np.all(got[2] == 0.0)        # inactive slot: exact zeros


def test_paged_decode_dispatcher_shapes():
    q, kd, km, ks, vd, vm, vs, bt, cur = _decode_case(seed=1)
    B, KV, G, hd = q.shape
    q4 = q.reshape(B, 1, KV * G, hd)
    want = np.asarray(jops.sparq_paged_decode_attention(
        jnp.asarray(q4), *map(jnp.asarray, (kd, km, ks, vd, vm, vs, bt,
                                            cur)), impl="reference"))
    got = tops.sparq_paged_decode_attention(
        _t(q4), *map(_t, (kd, km, ks, vd, vm, vs, bt, cur))).numpy()
    assert got.shape == want.shape == (B, 1, KV * G, hd)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _prefill_case(seed=0):
    """The stream of test_prefill.py's kernel grid: slot 0 continues at
    pos 7..12 (hist 7, a run straddling a page boundary), slot 1 resumes
    at a segment boundary (pos 4..7, hist 4), slot 2 is fresh, one tile
    is padding."""
    rng = np.random.default_rng(seed)
    S, NB, ps, KV, G, hd, P, C = 3, 4, 4, 2, 2, 8, 8, 16
    kd, km = _random_pool(rng, P, ps, KV, hd)
    vd, vm = _random_pool(rng, P, ps, KV, hd)
    bt = -np.ones((S, NB), np.int32)
    bt[0, :2] = [1, 2]
    bt[1, :1] = [3]
    seq_id = np.full(C, -1, np.int32)
    pos = np.zeros(C, np.int32)
    hist = np.zeros(C, np.int32)
    seq_id[0:6], pos[0:6], hist[0:6] = 0, np.arange(7, 13), 7
    seq_id[8:12], pos[8:12], hist[8:12] = 1, np.arange(4, 8), 4
    seq_id[12:15], pos[12:15], hist[12:15] = 2, np.arange(0, 3), 0
    tile_seq = np.array([0, 0, 1, 2], np.int32)
    q = rng.standard_normal((C, KV, G, hd)).astype(np.float32)
    kc = rng.standard_normal((C, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((C, KV, hd)).astype(np.float32)
    ks = (rng.random(S) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random(S) * 0.02 + 0.005).astype(np.float32)
    return (q, kc, vc, kd, km, ks, vd, vm, vs, bt, seq_id, pos, hist,
            tile_seq)


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_prefill_plain_matches_oracle_and_pallas(window):
    args = _prefill_case()
    want = np.asarray(jref.ref_sparq_chunked_prefill_attn(
        *map(jnp.asarray, args), window=window))
    pal = np.asarray(sparq_chunked_prefill_attn_pallas(
        *map(jnp.asarray, args), window=window, bq=4, interpret=True))
    got = ref_sparq_chunked_prefill_attn(*map(_t, args),
                                         window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)
    seq_id = args[10]
    assert np.all(got[seq_id < 0] == 0.0)   # padding rows: exact zeros


def test_chunked_prefill_dispatcher_shapes():
    (q, kc, vc, kd, km, ks, vd, vm, vs, bt, sid, pos, hist,
     ts) = _prefill_case(seed=2)
    C, KV, G, hd = q.shape
    q3 = q.reshape(C, KV * G, hd)
    rest = (kc, vc, kd, km, ks, vd, vm, vs, bt, sid, pos, hist, ts)
    want = np.asarray(jops.sparq_chunked_prefill_attention(
        jnp.asarray(q3), *map(jnp.asarray, rest), impl="reference", bq=4))
    got = tops.sparq_chunked_prefill_attention(
        _t(q3), *map(_t, rest), bq=4).numpy()
    assert got.shape == want.shape == (C, KV * G, hd)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _c_params(source: str, symbol: str):
    """Parameter types of `extern "C" int symbol(...)` in a csrc source."""
    import re
    from repro_torch.kernels.build import CSRC
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r'\((.*?)\)\s*\{', text,
                  re.S)
    assert m, f"{symbol} not found in {source}"
    return [p.strip().rsplit(" ", 1)[0] for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", ["sparq_matmul", "sparq_paged_decode_attn",
                                  "sparq_chunked_prefill_attn",
                                  "sparq_quant", "sparq_decode_attn",
                                  "sparq_dequant"])
def test_kernel_binding_matches_c_signature(name):
    """Each wrapper's ctypes argtypes follow its C entry point parameter by
    parameter (pointers c_void_p, int c_int, float c_float): a mismatch
    only shows on the card, as a refused call or a garbled argument."""
    import ctypes
    from repro_torch.kernels import build
    k = build.KERNELS[name]
    want = {"int": ctypes.c_int, "float": ctypes.c_float}
    params = _c_params(k.source, k.symbol)
    assert len(params) == len(k.argtypes), (params, k.argtypes)
    for c_type, arg in zip(params, k.argtypes):
        assert arg is (ctypes.c_void_p if "*" in c_type else want[c_type]), \
            (c_type, arg)
