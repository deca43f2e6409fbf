"""K4's fused KV writes and K6's float mode, on the CPU.

K4 (`csrc/sparq_quant.cu`) does a whole KV write on the card: a paged
decode update in one launch, a prefill chunk and a contiguous prefill slab
in two (a scale pass, then the write), a contiguous decode append in one.
Each write's plain version (`kernels/sparq_quant.py::ref_kv_write_paged`,
`ref_kv_write_chunk`, `ref_kv_write_contiguous`, which CPU tensors take
through `kernels.ops`) is held here against the JAX package's own write
(`repro.models.paging.PagedCacheStore.update` / `write_chunk`,
`repro.models.cache.CacheStore.update`), and a numpy emulation of the
kernel's control flow (scale resolution order, the scale pass's integer
maxima, page, row and trash addressing, the stored-form encoder
`sparq_encode_stored`) against the plain version. K6's float mode
(`CachedTensor.read`) is held against the JAX read and an emulation of its
epilogue on every (store, meta) byte pair.

Tolerance: none. Every write is integer arithmetic after one IEEE f32
division, so pools (all but the trash page, which inactive slots, padding
and unallocated blocks write in an undefined order), scales and positions
must be equal, and K6's floats bit for bit.
"""
import copy
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparq import SparqConfig as JCfg
from repro.models import cache as jcache
from repro.models import paging as jpaging
from repro.models.cache import CacheConfig as JCC
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.kernels import build as _b
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sparq_dequant as dq
from repro_torch.kernels import sparq_quant as sq
from repro_torch.kernels.build import CSRC
from repro_torch.models import cache as tcache
from repro_torch.models import paging as tpaging
from test_torch_kernels import CODECS, _kw

KV_CODECS = {"5opt": dict(bits=4, opts=5, signed=True),
             "a8w8": dict(enabled=False, signed=True)}
# (page size, hd, KV heads): pages of 16 and 128; hd 16 (the reduced
# tinyllama), 64 (tinyllama) and 128 (granite, one KV head)
GEOMS = [(16, 16, 2), (16, 64, 4), (16, 128, 1), (128, 16, 2),
         (128, 64, 4), (128, 128, 1)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Cases held against the JAX writes, which run eagerly: under jit, XLA
# turns the scale's division by max_val into a multiplication by its
# reciprocal, which moves a scale by an ulp (IEEE division is the op both
# packages write). Eager JAX compiles each op of the codec for every new
# shape, so these cover page sizes 16 and 128, hd 16, 64 and 128, both
# dtypes and both codecs in a few shapes; the emulation tests below run
# every combination.
JAX_PAGED = [(16, 16, 2, "f32", "5opt"), (128, 64, 4, "bf16", "a8w8"),
             (16, 128, 1, "bf16", "5opt")]
JAX_CHUNK = [(128, 16, 2, "bf16", "5opt"), (16, 64, 4, "f32", "a8w8"),
             (128, 128, 1, "f32", "5opt")]
JAX_CONTIG = [(16, 2, "bf16", "a8w8"), (64, 4, "f32", "5opt")]


def _cfgs(codec):
    c = KV_CODECS[codec]
    return JCfg(**c), TCfg(**c)


def _kv(rng, shape, dtype, amp=1.0):
    """K/V values exact in `dtype` (bf16-rounded when bf16), as the f32
    numpy array and the torch tensor of that dtype."""
    x = (rng.standard_normal(shape) * amp).astype(np.float32)
    x[rng.random(shape) < 0.25] = 0.0        # vSPARQ's partner-zero rule
    t = torch.from_numpy(x).to(DTYPES[dtype])
    return t.to(torch.float32).numpy(), t


def _jx(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                                 else jnp.float32)


# ----------------------------------------------------------------------
# numpy emulation of the kernel (csrc/sparq_common.cuh, csrc/sparq_quant.cu)
# ----------------------------------------------------------------------

def _msb(x):
    return sum((x >= (1 << k)).astype(np.int64) for k in range(1, 8))


def _select_shift(m, c):
    need = np.maximum(m - (c.bits - 1), 0)
    out = np.full_like(m, max(c.shifts))
    for opt in sorted(c.shifts, reverse=True):   # the smallest that covers
        out = np.where(need <= opt, opt, out)
    return out


def _bsparq(x, c):
    wmask = (1 << c.bits) - 1
    s = _select_shift(_msb(x), c)
    q = (x >> s) & wmask
    if not c.rounding:
        return q << s, s
    rbit = np.where(s > 0, (x >> np.maximum(s - 1, 0)) & 1, 0)
    v = np.minimum((q + rbit) << s, c.max_val)
    s = _select_shift(_msb(v), c)
    return ((v >> s) & wmask) << s, s


def emu_encode_pair(q0, q1, c):
    """sparq_encode_pair: reconstructed codes and the pair's meta byte."""
    if not c.enabled:
        return q0, q1, np.zeros_like(q0)
    m0, m1 = np.abs(q0), np.abs(q1)
    (t0, s0), (t1, s1) = _bsparq(m0, c), _bsparq(m1, c)
    mux = np.zeros_like(m0)
    if c.vsparq:
        z0, z1 = m0 == 0, m1 == 0
        t0, s0 = np.where(z1, m0, t0), np.where(z1, 0, s0)
        t1, s1 = np.where(z0, m1, t1), np.where(z0, 0, s1)
        mux = (z0 | z1).astype(np.int64)
    return (np.where(q0 < 0, -t0, t0), np.where(q1 < 0, -t1, t1),
            mux * 64 + s0 * 8 + s1)


def emu_encode_stored(q0, q1, c):
    """sparq_encode_stored: the window codes sign * (|r| >> shift)."""
    r0, r1, meta = emu_encode_pair(q0, q1, c)
    st0 = np.sign(r0) * (np.abs(r0) >> ((meta >> 3) & 7))
    st1 = np.sign(r1) * (np.abs(r1) >> (meta & 7))
    return st0, st1, meta


def emu_encode_rows(x, a, c):
    """encode_store over rows: x f32 [R, n], a f32 [R] -> (data, meta)."""
    qmax = np.float32(c.max_val)
    qmin = -qmax if c.signed else np.float32(0)
    q = np.clip(np.rint(x / a[:, None]), qmin, qmax).astype(np.int64)
    st0, st1, meta = emu_encode_stored(q[:, 0::2], q[:, 1::2], c)
    data = np.empty_like(q)
    data[:, 0::2], data[:, 1::2] = st0, st1
    return data.astype(np.int8), np.repeat(meta, 2, axis=1).astype(np.int8)


def emu_resolve(stored, amax, c):
    """resolve(): frozen if > 0, else max(amax, 1e-8) / max_val in f32."""
    dyn = np.maximum(amax, np.float32(1e-8)) / np.float32(c.max_val)
    return np.where(stored > 0, stored, dyn).astype(np.float32)


def _page_row(bt, s, pos, live, ps, trash):
    eff = np.maximum(pos, 0)
    page = bt[s, np.minimum(eff // ps, bt.shape[1] - 1)]
    page = np.where(live & (page >= 0), page, trash)
    return page * ps + eff % ps


def emu_paged(planes, pools, scales, bt, pos, c):
    """The PAGED group kernel: block (slot, plane) resolves the slot's
    scale from its own row, then writes it at its page row."""
    S = planes[0].shape[0]
    ps, trash = pools[0].shape[1], pools[0].shape[0] - 1
    rows = _page_row(bt, np.arange(S), pos, pos >= 0, ps, trash)
    out = []
    for p in range(2):
        x = planes[p].reshape(S, -1)
        a = emu_resolve(scales[p], np.abs(x).max(axis=1), c)
        d, m = emu_encode_rows(x, a, c)
        pools[2 * p].reshape(-1, x.shape[1])[rows] = d
        pools[2 * p + 1].reshape(-1, x.shape[1])[rows] = m
        out.append(np.where(pos >= 0, a, scales[p]))
    return out[0], out[1], np.where(pos >= 0, pos + 1, pos)


def emu_chunk(planes, pools, scales, bt, sid, pos, hist, pos_after, c):
    """CHUNK_SCALE then CHUNK_WRITE: token maxima as the int bits of
    non-negative floats (-1: not a first-segment token), folded per slot
    by an integer max, then each token written at its page row."""
    C = sid.shape[0]
    S = bt.shape[0]
    ps, trash = pools[0].shape[1], pools[0].shape[0] - 1
    s_safe = np.maximum(sid, 0)
    rows = _page_row(bt, s_safe, pos, sid >= 0, ps, trash)
    out = []
    for p in range(2):
        x = planes[p].reshape(C, -1)
        amax = np.abs(x).max(axis=1).astype(np.float32)
        maxima = np.where((sid >= 0) & (hist == 0), amax.view(np.int32), -1)
        slot_max = np.full(S, -1, np.int32)
        for i in range(C):                         # atomicMax, any order
            if maxima[i] >= 0:
                slot_max[sid[i]] = max(slot_max[sid[i]], maxima[i])
        scale = np.where(slot_max >= 0,
                         emu_resolve(scales[p], slot_max.view(np.float32),
                                     c), scales[p]).astype(np.float32)
        d, m = emu_encode_rows(x, scale[s_safe], c)
        pools[2 * p].reshape(-1, x.shape[1])[rows] = d
        pools[2 * p + 1].reshape(-1, x.shape[1])[rows] = m
        out.append(scale)
    return out[0], out[1], pos_after.copy()


def emu_contiguous(planes, data, scales, pos, c):
    """CONTIG_ONE (T = 1: one block a plane reduces the slab) or
    CONTIG_SCALE + CONTIG_WRITE (maxima of 8 rows a block, folded by every
    write block); rows at min(pos, Tmax - T) + t."""
    B, T = planes[0].shape[:2]
    Tmax = data[0].shape[1]
    start = min(int(pos), Tmax - T)
    out = []
    for p in range(2):
        x = planes[p].reshape(B * T, -1)
        rmax = np.abs(x).max(axis=1)
        if T == 1:
            amax = rmax.max()
        else:
            pad = np.zeros(-(-B * T // 8) * 8, np.float32)
            pad[:B * T] = rmax
            amax = pad.reshape(-1, 8).max(axis=1).max()
        a = emu_resolve(scales[p], np.float32(amax), c)
        d, m = emu_encode_rows(x, np.full(B * T, a, np.float32), c)
        data[2 * p][:, start:start + T] = d.reshape(B, T, *data[0].shape[2:])
        data[2 * p + 1][:, start:start + T] = \
            m.reshape(B, T, *data[0].shape[2:])
        out.append(np.float32(a))
    return out[0], out[1], np.int32(pos + T)


# ----------------------------------------------------------------------
# scenarios
# ----------------------------------------------------------------------

def _paged_stores(codec, S, P, ps, NB, KV, hd, bt, pos, k_scale, v_scale):
    jc, tc = _cfgs(codec)
    js = jpaging.PagedCacheStore.init(S, P, ps, NB, KV, hd,
                                      JCC.sparq_cache(jc, "reference"))
    ts = tpaging.PagedCacheStore.init(S, P, ps, NB, KV, hd,
                                      tcache.CacheConfig.sparq_cache(tc),
                                      "cpu")
    rng = np.random.default_rng(11)
    fill = [rng.integers(-8, 8, ts.k_data.shape).astype(np.int8)
            for _ in range(4)]                     # stale bytes of old use
    js = dataclasses.replace(
        js, **dict(zip(("k_data", "k_meta", "v_data", "v_meta"),
                       map(jnp.asarray, fill))),
        k_scale=jnp.asarray(k_scale), v_scale=jnp.asarray(v_scale),
        block_table=jnp.asarray(bt), seq_pos=jnp.asarray(pos))
    ts.k_data, ts.k_meta, ts.v_data, ts.v_meta = (
        torch.from_numpy(f.copy()) for f in fill)
    ts.k_scale, ts.v_scale = (torch.from_numpy(np.array(s, np.float32))
                              for s in (k_scale, v_scale))
    ts.block_table = torch.from_numpy(bt.copy())
    ts.seq_pos = torch.from_numpy(pos.copy())
    return js, ts, tc


def paged_case(codec, ps, hd, KV):
    """5 slots: calibrated (block 1), uncalibrated at a page's last row
    (its next token lands in an unallocated block), inactive, active in an
    unallocated block, and one past NB * ps (the block clamps to NB - 1)."""
    bt = np.array([[0, 3, -1], [1, -1, -1], [2, -1, -1], [4, -1, -1],
                   [5, -1, 6]], np.int32)
    pos = np.array([ps + 2, ps - 1, -1, ps + 1, 3 * ps + 4], np.int32)
    k_scale = np.array([0.02, 0, 0, 0, 0.05], np.float32)
    v_scale = np.array([0.03, 0, 0.01, 0, 0.04], np.float32)
    return _paged_stores(codec, 5, 7, ps, 3, KV, hd, bt, pos, k_scale,
                         v_scale)


def chunk_case(codec, ps, hd, KV, dtype):
    """16 tokens: slot 0's first segment (uncalibrated), slot 1's later
    segment across a page boundary (calibrated), slot 2's first segment
    under a stored scale (which wins) into an unallocated block, 4 padding
    tokens; slot 3 has no token and keeps its unset scale."""
    bt = np.array([[0, 1, -1], [2, 3, -1], [4, -1, -1], [5, -1, -1]],
                  np.int32)
    seq_id = np.array([0] * 6 + [1] * 4 + [2] * 2 + [-1] * 4, np.int32)
    pos = np.array(list(range(6)) + list(range(ps - 2, ps + 2))
                   + [ps - 1, ps] + [0] * 4, np.int32)
    hist = np.array([0] * 6 + [ps - 2] * 4 + [0] * 2 + [0] * 4, np.int32)
    spa = np.array([6, ps + 2, ps + 1, -1], np.int32)
    js, ts, tc = _paged_stores(
        codec, 4, 6, ps, 3, KV, hd, bt, np.full(4, -1, np.int32),
        np.array([0, 0.03, 0.02, 0], np.float32),
        np.array([0, 0.02, 0.05, 0], np.float32))
    rng = np.random.default_rng(5)
    k, tk = _kv(rng, (16, KV, hd), dtype)
    v, tv = _kv(rng, (16, KV, hd), dtype, amp=2.0)
    tile_seq = np.zeros(2, np.int32)
    arrays = (seq_id, pos, hist, tile_seq, spa)
    jmeta = jpaging.ChunkMeta(*map(jnp.asarray, arrays))
    tmeta = tpaging.ChunkMeta(*(torch.from_numpy(a.copy()) for a in arrays))
    return js, ts, tc, (k, tk, v, tv), jmeta, tmeta


def _assert_same_store(js, ts):
    for name in ("k_data", "k_meta", "v_data", "v_meta"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name))[:-1],
                                      getattr(ts, name).numpy()[:-1],
                                      err_msg=name)
    for name in ("k_scale", "v_scale", "seq_pos"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(),
                                      err_msg=name)


def _numpy_store(ts):
    return ([getattr(ts, n).numpy().copy() for n in
             ("k_data", "k_meta", "v_data", "v_meta")],
            (ts.k_scale.numpy().copy(), ts.v_scale.numpy().copy()),
            ts.block_table.numpy().copy(), ts.seq_pos.numpy().copy())


def _assert_emulated(pools, new, ts):
    for i, name in enumerate(("k_data", "k_meta", "v_data", "v_meta")):
        np.testing.assert_array_equal(pools[i][:-1],
                                      getattr(ts, name).numpy()[:-1],
                                      err_msg=name)
    for want, name in zip(new, ("k_scale", "v_scale", "seq_pos")):
        np.testing.assert_array_equal(want, getattr(ts, name).numpy(),
                                      err_msg=name)


# ----------------------------------------------------------------------
# plain versions against the JAX writes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ps,hd,KV,dtype,codec", JAX_PAGED)
def test_paged_update_matches_jax(ps, hd, KV, dtype, codec):
    js, ts, _ = paged_case(codec, ps, hd, KV)
    rng = np.random.default_rng(1)
    for amp in (1.0, 3.0):                     # the second finds scales set
        k, tk = _kv(rng, (5, 1, KV, hd), dtype, amp)
        v, tv = _kv(rng, (5, 1, KV, hd), dtype, amp * 2)
        js = js.update(_jx(k, dtype), _jx(v, dtype))
        ts.update(tk, tv)
        _assert_same_store(js, ts)
    assert float(ts.k_scale[2]) == 0.0         # inactive: untouched


@pytest.mark.parametrize("ps,hd,KV,dtype,codec", JAX_CHUNK)
def test_chunk_write_matches_jax(ps, hd, KV, dtype, codec):
    js, ts, _, (k, tk, v, tv), jmeta, tmeta = chunk_case(codec, ps, hd, KV,
                                                         dtype)
    js = js.write_chunk(_jx(k, dtype), _jx(v, dtype), jmeta)
    ts.write_chunk(tk, tv, tmeta)
    _assert_same_store(js, ts)
    assert ts.k_scale[1] == np.float32(0.03)   # frozen: later segment
    assert ts.k_scale[2] == np.float32(0.02)   # frozen: stored wins
    assert ts.k_scale[3] == 0.0                # no first-segment token


def _contig_pair(codec, B, Tmax, KV, hd):
    jc, tc = _cfgs(codec)
    return (jcache.CacheStore.init((B, Tmax, KV, hd),
                                   JCC.sparq_cache(jc, "reference")),
            tcache.CacheStore.init((B, Tmax, KV, hd),
                                   tcache.CacheConfig.sparq_cache(tc),
                                   "cpu"), tc)


def _assert_same_contig(js, ts):
    for jp, tp in ((js.k, ts.k), (js.v, ts.v)):
        np.testing.assert_array_equal(np.asarray(jp.data), tp.data.numpy())
        np.testing.assert_array_equal(np.asarray(jp.meta), tp.meta.numpy())
        np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
    assert int(js.pos) == int(ts.pos)


# into 8 slots: the prefill slab, two decode tokens, then a slab past
# capacity (the start clamps so it fits, as dynamic_update_slice does)
TMAX = 8
CONTIG_STEPS = ((4, 1.0), (1, 3.0), (1, 3.0), (4, 1.0))


@pytest.mark.parametrize("hd,KV,dtype,codec", JAX_CONTIG)
def test_contiguous_update_matches_jax(hd, KV, dtype, codec):
    js, ts, _ = _contig_pair(codec, 2, TMAX, KV, hd)
    rng = np.random.default_rng(2)
    for T, amp in CONTIG_STEPS:
        k, tk = _kv(rng, (2, T, KV, hd), dtype, amp)
        v, tv = _kv(rng, (2, T, KV, hd), dtype, amp)
        js = js.update(_jx(k, dtype), _jx(v, dtype))
        ts.update(tk, tv)
        _assert_same_contig(js, ts)


def _jitted_write(kind, codec):
    """(JAX store after one jitted write, the port's store before it, a
    function that runs the port's plain write on a store)."""
    import jax
    if kind == "paged":
        js, ts, _ = paged_case(codec, 16, 64, 4)
        rng = np.random.default_rng(3)
        k, tk = _kv(rng, (5, 1, 4, 64), "f32")
        v, tv = _kv(rng, (5, 1, 4, 64), "f32", 2.0)
        js = jax.jit(lambda st, a, b: st.update(a, b))(js, _jx(k, "f32"),
                                                       _jx(v, "f32"))
        return js, ts, lambda st: st.update(tk, tv)
    if kind == "chunk":
        js, ts, _, (k, tk, v, tv), jmeta, tmeta = chunk_case(codec, 16, 64,
                                                             4, "f32")
        js = jax.jit(lambda st, a, b, m: st.write_chunk(a, b, m))(
            js, _jx(k, "f32"), _jx(v, "f32"), jmeta)
        return js, ts, lambda st: st.write_chunk(tk, tv, tmeta)
    js, ts, _ = _contig_pair(codec, 2, TMAX, 4, 64)
    rng = np.random.default_rng(4)
    k, tk = _kv(rng, (2, 4, 4, 64), "f32")
    v, tv = _kv(rng, (2, 4, 4, 64), "f32", 3.0)
    js = jax.jit(lambda st, a, b: st.update(a, b))(js, _jx(k, "f32"),
                                                   _jx(v, "f32"))
    return js, ts, lambda st: st.update(tk, tv)


@pytest.mark.parametrize("kind", ["paged", "chunk", "contiguous"])
def test_plain_writes_within_an_ulp_of_jitted_jax(kind):
    """The JAX write as it runs in the served step, under jit, where XLA
    divides by max_val as a multiplication by its reciprocal: the port's
    plain write (IEEE division, as the kernel) gives every scale within one
    ulp of it (tolerance: 1 ulp), the same positions, and, handed the
    jitted scales as its stored ones, the same pool bytes."""
    js, ts, write = _jitted_write(kind, "5opt")
    before = copy.deepcopy(ts)
    write(ts)
    if kind == "contiguous":
        pairs = [(js.k.scale, ts.k.scale), (js.v.scale, ts.v.scale)]
        assert int(js.pos) == int(ts.pos)
    else:
        pairs = [(js.k_scale, ts.k_scale), (js.v_scale, ts.v_scale)]
        np.testing.assert_array_equal(np.asarray(js.seq_pos),
                                      ts.seq_pos.numpy())
    for j, t in pairs:
        np.testing.assert_array_max_ulp(np.asarray(j), t.numpy(), maxulp=1)
    if kind == "contiguous":
        before.k.scale = torch.from_numpy(np.asarray(js.k.scale).copy())
        before.v.scale = torch.from_numpy(np.asarray(js.v.scale).copy())
        write(before)
        _assert_same_contig(js, before)
    else:
        before.k_scale = torch.from_numpy(np.asarray(js.k_scale).copy())
        before.v_scale = torch.from_numpy(np.asarray(js.v_scale).copy())
        write(before)
        _assert_same_store(js, before)


# ----------------------------------------------------------------------
# the kernel's control flow, emulated, against the plain versions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("codec", list(KV_CODECS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ps,hd,KV", GEOMS)
def test_paged_kernel_emulation_matches_plain(ps, hd, KV, dtype, codec):
    _, ts, tc = paged_case(codec, ps, hd, KV)
    rng = np.random.default_rng(1)
    for amp in (1.0, 3.0):
        k, tk = _kv(rng, (5, 1, KV, hd), dtype, amp)
        v, tv = _kv(rng, (5, 1, KV, hd), dtype, amp * 2)
        pools, scales, bt, pos = _numpy_store(ts)
        new = emu_paged((k, v), pools, scales, bt, pos, tc)
        ts.update(tk, tv)
        _assert_emulated(pools, new, ts)


@pytest.mark.parametrize("codec", list(KV_CODECS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ps,hd,KV", GEOMS)
def test_chunk_kernel_emulation_matches_plain(ps, hd, KV, dtype, codec):
    _, ts, tc, (k, tk, v, tv), _, tmeta = chunk_case(codec, ps, hd, KV,
                                                     dtype)
    pools, scales, bt, _ = _numpy_store(ts)
    m = [t.numpy() for t in tmeta]
    new = emu_chunk((k, v), pools, scales, bt, m[0], m[1], m[2], m[4], tc)
    ts.write_chunk(tk, tv, tmeta)
    _assert_emulated(pools, new, ts)


@pytest.mark.parametrize("codec", list(KV_CODECS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,hd,KV", [(2, 16, 2), (3, 64, 4), (2, 128, 1)])
def test_contiguous_kernel_emulation_matches_plain(B, hd, KV, dtype, codec):
    """B = 3 gives a slab of 15 rows: a partial 8-row scale-pass block."""
    _, ts, tc = _contig_pair(codec, B, TMAX, KV, hd)
    rng = np.random.default_rng(2)
    for T, amp in CONTIG_STEPS:
        k, tk = _kv(rng, (B, T, KV, hd), dtype, amp)
        v, tv = _kv(rng, (B, T, KV, hd), dtype, amp)
        planes = [t.numpy().copy() for t in (ts.k.data, ts.k.meta,
                                             ts.v.data, ts.v.meta)]
        new = emu_contiguous((k, v), planes, (ts.k.scale.numpy(),
                                              ts.v.scale.numpy()),
                             ts.pos.numpy(), tc)
        ts.update(tk, tv)
        for want, got in zip(planes, (ts.k.data, ts.k.meta, ts.v.data,
                                      ts.v.meta)):
            np.testing.assert_array_equal(want, got.numpy())
        for want, got in zip(new, (ts.k.scale, ts.v.scale, ts.pos)):
            np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("codec", [c for c in CODECS if c["signed"]],
                         ids=str)
def test_stored_encoder_exhaustive(codec):
    """sparq_encode_stored on every pair of signed codes equals
    sparq_pack(ref_sparq_quant(...)) (codes fed as floats at scale 1), and
    its sparq_encode_pair equals the reconstructed codes."""
    c = TCfg(**codec)
    a = np.arange(-c.max_val, c.max_val + 1, dtype=np.int64)
    q0, q1 = np.repeat(a, a.size), np.tile(a, a.size)
    x = torch.from_numpy(np.stack([q0, q1], 1).astype(np.float32))
    codes, meta = tref.ref_sparq_quant(x, torch.tensor(1.0), **_kw(c))
    stored = tref.sparq_pack(codes, meta).numpy()
    st0, st1, mb = emu_encode_stored(q0, q1, c)
    np.testing.assert_array_equal(stored, np.stack([st0, st1], 1))
    np.testing.assert_array_equal(meta.numpy(), np.stack([mb, mb], 1))
    r0, r1, _ = emu_encode_pair(q0, q1, c)
    np.testing.assert_array_equal(codes.numpy(), np.stack([r0, r1], 1))


# ----------------------------------------------------------------------
# K6: float mode
# ----------------------------------------------------------------------

def _byte_grid():
    """Every (store, meta) byte pair on both lane parities, (1, 1024, 1,
    128) int8."""
    b = np.arange(-128, 128, dtype=np.int64)
    st, mt = np.repeat(b, 256), np.tile(b, 256)
    st = np.concatenate([st, np.roll(st, 1)]).astype(np.int8)
    mt = np.concatenate([mt, np.roll(mt, 1)]).astype(np.int8)
    return st.reshape(1, -1, 1, 128), mt.reshape(1, -1, 1, 128)


def emu_k6_float(st, mt, scale, bf16):
    """K6's float epilogue: the int32 product's low byte as int8, widened,
    times the scale in f32; bf16 by round to nearest even, as bits."""
    q, m = st.astype(np.int64), mt.astype(np.int64)
    lane = np.arange(st.shape[-1]) % 2
    s = np.where(lane == 1, m & 7, (m >> 3) & 7)
    r = np.sign(q) * (np.abs(q) << s)
    code = ((r & 0xff) ^ 0x80) - 0x80            # low byte, sign-extended
    f = code.astype(np.float32) * np.float32(scale)
    if not bf16:
        return f
    u = f.view(np.uint32).astype(np.uint64)
    return ((u + 0x7fff + ((u >> 16) & 1)) >> 16).astype(np.uint16)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32",
                                                               "bf16"])
@pytest.mark.parametrize("scale", [0.0123, 1 / 127, 3.7])
def test_k6_float_mode_every_byte_pair(dtype, scale):
    st, mt = _byte_grid()
    sc = np.float32(scale)
    jc, tc = _cfgs("5opt")
    jt = jcache.CachedTensor(data=jnp.asarray(st), meta=jnp.asarray(mt),
                             scale=jnp.asarray(sc), layout="sparq",
                             codec=jc, impl="reference")
    tt = tcache.CachedTensor(data=torch.from_numpy(st),
                             meta=torch.from_numpy(mt),
                             scale=torch.tensor(sc), layout="sparq",
                             codec=tc)
    got = tt.read(dtype)
    jdt = None if dtype is None else jnp.bfloat16
    want = np.asarray(jt.read(jdt).astype(jnp.float32))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    plain = dq.ref_sparq_dequant(torch.from_numpy(st), torch.from_numpy(
        mt)).to(torch.float32) * torch.tensor(sc)
    if dtype is not None:
        plain = plain.to(dtype)
    assert torch.equal(got, plain)
    emu = emu_k6_float(st, mt, sc, dtype is not None)
    bits = got.view(torch.int16).numpy().view(np.uint16) if dtype \
        else got.numpy()
    np.testing.assert_array_equal(bits, emu)


# ----------------------------------------------------------------------
# the wrappers, with the kernel's launch replaced by a recorder
# ----------------------------------------------------------------------

def _c_names(source, symbol):
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r'\((.*?)\)\s*\{', text,
                  re.S)
    return [p.strip().rsplit(" ", 1)[1].lstrip("*")
            for p in m.group(1).split(",")]


@pytest.fixture
def recorder(monkeypatch):
    names = _c_names(sq.KERNEL.source, sq.KERNEL.symbol)
    calls = []

    def launch(*args):
        assert len(args) == len(names)
        calls.append({n: (a.value if hasattr(a, "value") else a)
                      for n, a in zip(names, args)})
    monkeypatch.setattr(sq.KERNEL, "launch", launch)
    monkeypatch.setattr(_b, "stream_ptr", lambda t: 0)
    return calls


def _codec():
    return tops._codec_kw(TCfg(bits=4, opts=5, signed=True))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrappers_launch_the_modes(recorder, dtype):
    """paged: one PAGED launch; chunk: CHUNK_SCALE then CHUNK_WRITE on one
    scratch; contiguous: CONTIG_ONE at T = 1, else CONTIG_SCALE then
    CONTIG_WRITE; each with the sizes, trash page and pointers of its
    call, and K/V passed in their own dtype."""
    dt = DTYPES[dtype]
    S, P, ps, NB, KV, hd = 5, 7, 16, 3, 4, 64
    pools = [torch.zeros((P + 1, ps, KV, hd), dtype=torch.int8)
             for _ in range(4)]
    sc = [torch.zeros(S), torch.zeros(S)]
    bt = torch.zeros((S, NB), dtype=torch.int32)
    pos = torch.zeros(S, dtype=torch.int32)
    k = torch.zeros((S, 1, KV, hd), dtype=dt)
    sq.kv_write_paged_cuda(k, k.clone(), *pools, *sc, bt, pos, **_codec())
    (c,) = recorder
    assert (c["mode"], c["x_bf16"], c["rows"], c["n"], c["n_slots"],
            c["ps"], c["NB"], c["trash"]) == (
        sq.PAGED, int(dt == torch.bfloat16), S, KV * hd, S, ps, NB, P)
    assert (c["k"], c["pos"], c["block_table"], c["v_meta"]) == (
        k.data_ptr(), pos.data_ptr(), bt.data_ptr(), pools[3].data_ptr())
    recorder.clear()
    C = 32
    ints = [torch.zeros(C, dtype=torch.int32) for _ in range(3)]
    kc = torch.zeros((C, KV, hd), dtype=dt)
    sq.kv_write_chunk_cuda(kc, kc.clone(), *pools, *sc, bt, *ints, pos,
                           **_codec())
    assert [c["mode"] for c in recorder] == [sq.CHUNK_SCALE, sq.CHUNK_WRITE]
    assert recorder[0]["maxima"] == recorder[1]["maxima"] != 0
    assert {c["rows"] for c in recorder} == {C}
    recorder.clear()
    planes = [torch.zeros((2, 12, KV, hd), dtype=torch.int8)
              for _ in range(4)]
    z, p0 = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    for T, modes in ((1, [sq.CONTIG_ONE]),
                     (5, [sq.CONTIG_SCALE, sq.CONTIG_WRITE])):
        xk = torch.zeros((2, T, KV, hd), dtype=dt)
        sq.kv_write_contiguous_cuda(xk, xk.clone(), *planes, z, z, p0,
                                    **_codec())
        assert [c["mode"] for c in recorder] == modes
        assert {(c["rows"], c["T"], c["Tmax"]) for c in recorder} == {
            (2 * T, T, 12)}
        recorder.clear()


def test_wrappers_reject_what_the_kernel_does_not_take(recorder):
    P, ps, KV, hd, S = 3, 16, 2, 16, 2
    pools = [torch.zeros((P, ps, KV, hd), dtype=torch.int8)
             for _ in range(4)]
    sc = [torch.zeros(S), torch.zeros(S)]
    bt = torch.zeros((S, 2), dtype=torch.int32)
    pos = torch.zeros(S, dtype=torch.int32)

    def paged(k, pl=pools, b=bt):
        sq.kv_write_paged_cuda(k, k, *pl, *sc, b, pos, **_codec())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        paged(torch.zeros((S, 1, KV, hd), dtype=torch.float16))
    with pytest.raises(ValueError, match="one token a slot"):
        paged(torch.zeros((S, 2, KV, hd)))
    with pytest.raises(ValueError, match="contiguous"):
        paged(torch.zeros((S, 1, hd, KV)).transpose(2, 3))
    with pytest.raises(ValueError, match="k_meta"):
        paged(torch.zeros((S, 1, KV, hd)),
              [pools[0], pools[1].to(torch.int32), *pools[2:]])
    with pytest.raises(ValueError, match="block_table"):
        paged(torch.zeros((S, 1, KV, hd)), b=bt.to(torch.int64))
    odd = torch.zeros((S, 1, KV, 15))
    with pytest.raises(ValueError, match="odd"):
        paged(odd)
    buf = torch.zeros(pools[0].numel() + 1, dtype=torch.int8)
    with pytest.raises(ValueError, match="lane pair"):
        paged(torch.zeros((S, 1, KV, hd)),
              [buf[1:].view(pools[0].shape), *pools[1:]])
    many = torch.zeros((sq.MAX_SLOTS + 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        sq.kv_write_chunk_cuda(torch.zeros((4, KV, hd)),
                               torch.zeros((4, KV, hd)), *pools, *sc, many,
                               *[torch.zeros(4, dtype=torch.int32)] * 3,
                               pos, **_codec())
    planes = [torch.zeros((1, 4, KV, hd), dtype=torch.int8)
              for _ in range(4)]
    z, p0 = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        x = torch.zeros((1, 5, KV, hd))
        sq.kv_write_contiguous_cuda(x, x, *planes, z, z, p0, **_codec())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dq.sparq_dequant_cuda(planes[0].reshape(4, -1),
                              planes[1].reshape(4, -1), z, torch.float16)
    assert recorder == []


def test_writes_on_another_device_raise():
    """Dispatch goes by device: CPU -> plain, CUDA -> K4, else raise."""
    x = torch.zeros((2, 1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no SPARQ kernel"):
        tops.kv_write_paged(x, x, *[None] * 8, TCfg(bits=4, opts=5,
                                                    signed=True))
