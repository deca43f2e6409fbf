"""Port parity, the recurrent families' layers: `repro_torch.models.rglru`,
`repro_torch.models.rwkv6`, the windowed attention and the sliding-window
ring cache against the JAX package's on the same numpy inputs, and the
plain version of K4's ring write (`kernels/sparq_quant.py::
ref_kv_write_ring`, which CPU tensors take through `kernels.ops`) against
the reference's eager `CachedTensor.write_slots` and a numpy emulation of
the kernel's control flow.

Tolerance: ATOL (1e-5) on f32 values of O(1) (the einsums and scans sum
in other orders in XLA and PyTorch); none for cache bytes, scales, slot
positions and positions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.core.sparq import SparqConfig as JCfg
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import cache as jcache
from repro.models import rglru as jrg
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtr
from repro.models.cache import CacheConfig as JCC
from repro_torch import interop
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.kernels import build as _b
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparq_quant as sq
from repro_torch.models import attention as tattn
from repro_torch.models import cache as tcache
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as ttr
from repro_torch.models.cache import CacheConfig as TCC
from test_torch_kv_write import emu_encode_rows, emu_resolve
from test_torch_mla import _c_names

ATOL = 1e-5
CODEC = dict(bits=4, opts=5, signed=True)
INT8 = dict(enabled=False, signed=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small tensors (see
    tests/test_torch_preempt.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got,
        np.asarray(want), rtol=0, atol=ATOL, err_msg=what)


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(arch, **kw):
    return (jcfg_reduced(arch).replace(dtype=jnp.float32, remat=False, **kw),
            tcfg_reduced(arch).replace(dtype=torch.float32, remat=False,
                                       **kw))


# ----------------------------------------------------------------------
# RG-LRU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches_jax(with_cache):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    kern = rng.standard_normal((4, 16)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 16)).astype(np.float32) \
        if with_cache else None
    jo, jc = jrg._causal_conv(jnp.asarray(x), jnp.asarray(kern),
                              None if cache is None else jnp.asarray(cache))
    to, tc = trg._causal_conv(_t(x), _t(kern),
                              None if cache is None else _t(cache))
    _close(to, jo, "out")
    _close(tc, jc, "tail")


_jax_lru = jax.jit(jrg._lru_scan, static_argnames=("impl",))


@pytest.mark.parametrize("T", [13, 16])
@pytest.mark.parametrize("impl,h0", [("assoc", False), ("assoc", True),
                                     ("scan", False), ("scan", True)])
def test_lru_scan_matches_jax(impl, h0, T):
    """Both impls, from a given h0 and without one (the reference's scan
    needs an array: zeros stand for none), at an odd and an even T (the
    associative scan's two recursion cases)."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 0.99, (2, T, 8)).astype(np.float32)
    bx = rng.standard_normal((2, T, 8)).astype(np.float32)
    h = rng.standard_normal((2, 8)).astype(np.float32) if h0 else None
    jh = jnp.asarray(h) if h0 else (
        jnp.zeros((2, 8), jnp.float32) if impl == "scan" else None)
    jhs, jlast = _jax_lru(jnp.asarray(a), jnp.asarray(bx), jh, impl=impl)
    ths, tlast = trg._lru_scan(_t(a), _t(bx), None if h is None else _t(h),
                               impl)
    _close(ths, jhs, "hs")
    _close(tlast, jlast, "h_last")


_jax_rglru = jax.jit(jrg.rglru_block, static_argnames=("cfg", "mode"))


def test_rglru_block_matches_jax():
    """Train, prefill (the associative scan; the state cache written) and
    two decode steps (the sequential scan, the carried state read and
    overwritten), f32, on the port's seeded weights and their JAX copy."""
    jc, tc = _cfgs("recurrentgemma-9b")
    tp = trg.rglru_init(torch.Generator().manual_seed(2), tc, "cpu")
    tp["lam"] = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 2, tc.lru_width).astype(np.float32))
    p = _to_jax(tp)
    rng = np.random.default_rng(3)
    B, T = 2, 11
    x = rng.standard_normal((B, T, tc.d_model)).astype(np.float32)
    jo, _ = _jax_rglru(p, jnp.asarray(x), jc, mode="train")
    to, _ = trg.rglru_block(tp, _t(x), tc, mode="train")
    _close(to, jo, "train")
    jcache_ = jrg.rglru_cache_init(jc, B, jnp.float32)
    tcache_ = trg.rglru_cache_init(tc, B, "cpu", torch.float32)
    for step in range(3):
        mode = "prefill" if step == 0 else "decode"
        xs = x if step == 0 else rng.standard_normal(
            (B, 1, tc.d_model)).astype(np.float32)
        jo, jcache_ = _jax_rglru(p, jnp.asarray(xs), jc, cache=jcache_,
                                 mode=mode)
        to, tcache_ = trg.rglru_block(tp, _t(xs), tc, cache=tcache_,
                                      mode=mode)
        _close(to, jo, f"{mode} {step}")
        _close(tcache_.h, jcache_.h, f"h {step}")
        _close(tcache_.conv, jcache_.conv, f"conv {step}")


# ----------------------------------------------------------------------
# RWKV6
# ----------------------------------------------------------------------

def _wkv_inputs(seed, B=2, T=13, H=2, hs=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hs)).astype(np.float32) * 0.5
               for _ in range(3))
    logw = -np.exp(rng.uniform(-3, 1, (B, T, H, hs))).clip(
        max=5).astype(np.float32)
    u = rng.standard_normal((H, hs)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hs, hs)).astype(np.float32)
    return r, k, v, logw, u, s0


_jax_wkv_scan = jax.jit(jrwkv._wkv_scan)
_jax_wkv_chunked = jax.jit(jrwkv._wkv_chunked, static_argnames=("chunk",))


@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_wkv_matches_jax(form):
    """The exact recurrence and the chunked form (T 13 against a chunk of
    8: padded, then sliced), from a nonzero state."""
    args = _wkv_inputs(4)
    if form == "scan":
        jy, js = _jax_wkv_scan(*map(jnp.asarray, args))
        ty, ts = trwkv._wkv_scan(*map(_t, args))
    else:
        jy, js = _jax_wkv_chunked(*map(jnp.asarray, args), chunk=8)
        ty, ts = trwkv._wkv_chunked(*map(_t, args), 8)
    assert ty.shape == tuple(jy.shape)
    _close(ty, jy, "y")
    _close(ts, js, "state")


_jax_time_mix = jax.jit(jrwkv.time_mix, static_argnames=("cfg", "mode"))
_jax_channel_mix = jax.jit(jrwkv.channel_mix, static_argnames=("cfg",))


def _rwkv_params(tc, seed):
    """The port's seeded block params with the vectors moved off their
    constant init (mus, u, w0, the group norm), so every term counts."""
    tp = trwkv.rwkv_block_init(torch.Generator().manual_seed(seed), tc,
                               "cpu")
    rng = np.random.default_rng(seed)
    D = tc.d_model
    for k in tp:
        if k.startswith("mu_"):
            tp[k] = _t(rng.uniform(0, 1, D).astype(np.float32))
    tp["u"] = _t(rng.standard_normal(D).astype(np.float32) * 0.5)
    tp["w0"] = _t(rng.uniform(-2, 1, D).astype(np.float32))
    tp["ln_x_scale"] = _t(rng.uniform(0.5, 1.5, D).astype(np.float32))
    tp["ln_x_bias"] = _t(rng.standard_normal(D).astype(np.float32) * 0.1)
    tp["w_B"] = tp["w_B"] * 50
    return tp


def test_time_and_channel_mix_match_jax():
    """time_mix in train mode (chunked) and with a cache (prefill, then
    two decode steps through the exact recurrence: state and tm_last
    carried), channel_mix without and with a carried last input."""
    jc, tc = _cfgs("rwkv6-7b")
    tp = _rwkv_params(tc, 5)
    p = _to_jax(tp)
    rng = np.random.default_rng(6)
    B, T, D = 2, 11, tc.d_model
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jo, _ = _jax_time_mix(p, jnp.asarray(x), jc, mode="train")
    to, _ = trwkv.time_mix(tp, _t(x), tc, mode="train")
    _close(to, jo, "train")
    H = D // tc.head_size
    jcache_ = jrwkv.RWKVCache(jnp.zeros((B, H, tc.head_size, tc.head_size)),
                              jnp.zeros((B, D)), jnp.zeros((B, D)))
    tcache_ = trwkv.rwkv_cache_init(tc, B, "cpu", torch.float32)
    for step in range(3):
        mode = "prefill" if step == 0 else "decode"
        xs = x if step == 0 else rng.standard_normal(
            (B, 1, D)).astype(np.float32)
        jo, jcache_ = _jax_time_mix(p, jnp.asarray(xs), jc, cache=jcache_,
                                    mode=mode)
        to, tcache_ = trwkv.time_mix(tp, _t(xs), tc, cache=tcache_,
                                     mode=mode)
        _close(to, jo, f"{mode} {step}")
        _close(tcache_.state, jcache_.state, f"state {step}")
        _close(tcache_.tm_last, jcache_.tm_last, f"tm_last {step}")
    last = rng.standard_normal((B, D)).astype(np.float32)
    for lst in (None, last):
        jo = _jax_channel_mix(p, jnp.asarray(x), jc,
                              last=None if lst is None else jnp.asarray(lst))
        to = trwkv.channel_mix(tp, _t(x), tc,
                               last=None if lst is None else _t(lst))
        _close(to, jo, f"channel mix, last {lst is not None}")


def test_wkv_scan_carries_the_input_dtype():
    """In bf16 the recurrence carries its state in bf16 and casts each
    step's decay to bf16, as the reference's; the bonus term (u is f32)
    and so y are f32, the returned state bf16."""
    r, k, v, logw, u, s0 = _wkv_inputs(7, T=3)
    bf = jnp.bfloat16
    jy, js = _jax_wkv_scan(*(jnp.asarray(a).astype(bf) for a in
                             (r, k, v)), jnp.asarray(logw), jnp.asarray(u),
                           jnp.asarray(s0).astype(bf))
    ty, ts = trwkv._wkv_scan(*(_t(a).bfloat16() for a in (r, k, v)),
                             _t(logw), _t(u), _t(s0).bfloat16())
    assert (str(ty.dtype), str(ts.dtype)) == ("torch.float32",
                                              "torch.bfloat16")
    assert (jy.dtype, js.dtype) == (jnp.float32, bf)
    np.testing.assert_allclose(ts.float().numpy(),
                               np.asarray(js.astype(jnp.float32)),
                               rtol=1e-2, atol=2e-2)


# ----------------------------------------------------------------------
# windowed attention
# ----------------------------------------------------------------------

_jax_flash = jax.jit(jattn.flash_attention, static_argnames=(
    "causal", "q_chunk", "kv_chunk", "window", "q_offset", "kv_offset"))


@pytest.mark.parametrize("causal,window,q_offset,kv_offset",
                         [(True, 5, 3, -2), (True, 0, 4, 0),
                          (False, 6, 0, 0), (True, 4, 8, 3)])
def test_flash_attention_window_and_offsets_match_jax(causal, window,
                                                      q_offset, kv_offset):
    rng = np.random.default_rng(window + q_offset)
    q = rng.standard_normal((2, 10, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 14, 2, 8)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, q_chunk=4, kv_chunk=6, window=window,
              q_offset=q_offset, kv_offset=kv_offset)
    want = _jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tattn.flash_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, want)


_jax_local = jax.jit(jattn.local_attention, static_argnames=("window",))


@pytest.mark.parametrize("T", [5, 8, 21])
def test_local_attention_matches_jax(T):
    """T below, at and above the window of 8 (three blocks, the last
    padded), GQA 4 over one KV head."""
    rng = np.random.default_rng(T)
    q = rng.standard_normal((2, T, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, T, 1, 16)).astype(np.float32)
            for _ in range(2))
    want = _jax_local(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      window=8)
    got = tattn.local_attention(_t(q), _t(k), _t(v), window=8)
    assert got.shape == q.shape
    _close(got, want)


# ----------------------------------------------------------------------
# the ring: K4's ring write (plain version), insert, decode attention
# ----------------------------------------------------------------------

def _jax_write_slots(ct, x, slots):
    """The reference's eager `CachedTensor.write_slots`."""
    return ct.write_slots(x, slots)


def emu_ring(planes, data, scales, slot_pos, pos, c):
    """K4's ring mode in numpy: the contiguous modes' scale resolution (one
    block's reduction at T = 1, the maxima of 8 rows a block otherwise),
    row t of a batch row at slot (pos + t) % W, slot_pos stamped there."""
    B, T = planes[0].shape[:2]
    W = data[0].shape[1]
    t_slot = (pos + np.arange(T)) % W
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
        rest = data[2 * p].shape[2:]
        data[2 * p][:, t_slot] = d.reshape(B, T, *rest)
        data[2 * p + 1][:, t_slot] = m.reshape(B, T, *rest)
        out.append(np.float32(a))
    slot_pos[:, t_slot] = pos + np.arange(T)
    return out[0], out[1], np.int32(pos + T)


# (T, amplitude) of successive ring writes into W = 8 slots from pos 5:
# a slab that wraps (slots 5, 6, 7, 0, 1, 2), a decode write, a full-window
# slab (every slot, rotated), a decode write at a wrapped slot
RING_STEPS = ((6, 1.0), (1, 3.0), (8, 2.0), (1, 0.5))


@pytest.mark.parametrize("codec", ["5opt", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ring_write_matches_jax_write_slots(codec, dtype):
    """`ops.kv_write_ring` on CPU tensors (K4's plain ring write) against
    the reference's eager `write_slots` plane by plane, and against the
    numpy emulation of the kernel: codes, meta and scales bit for bit
    through wrapping slots, the scales resolved at the first write and
    frozen; slot_pos and pos as the reference's `ring_insert` sets them."""
    B, W, KV, hd = 2, 8, 1, 16
    c = CODEC if codec == "5opt" else INT8
    jc = JCC.sparq_cache(JCfg(**c), impl="reference")
    tcfg = TCfg(**c)
    ring = tcache.RingKVCache.init((B, W, KV, hd), TCC.sparq_cache(tcfg),
                                   "cpu")
    ring.pos = torch.tensor(5, dtype=torch.int32)
    jk, jv = (jcache.CachedTensor.init((B, W, KV, hd), jc) for _ in range(2))
    jsp = np.full((B, W), -1, np.int32)
    jpos = 5
    rng = np.random.default_rng(9)
    for T, amp in RING_STEPS:
        xs = []
        for _ in range(2):
            x = (rng.standard_normal((B, T, KV, hd)) * amp).astype(
                np.float32)
            x[rng.random(x.shape) < 0.25] = 0.0
            xs.append(torch.from_numpy(x).to(dtype))
        slots = (jpos + np.arange(T)) % W
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        jk = _jax_write_slots(jk, jnp.asarray(xs[0].float().numpy()).astype(
            jd), jnp.asarray(slots))
        jv = _jax_write_slots(jv, jnp.asarray(xs[1].float().numpy()).astype(
            jd), jnp.asarray(slots))
        jsp[:, slots] = jpos + np.arange(T)
        jpos += T
        planes = [t.numpy().copy() for t in (ring.k.data, ring.k.meta,
                                             ring.v.data, ring.v.meta)]
        sp = ring.slot_pos.numpy().copy()
        emu = emu_ring([x.float().numpy() for x in xs], planes,
                       (ring.k.scale.numpy(), ring.v.scale.numpy()), sp,
                       int(ring.pos), tcfg)
        ttr.ring_insert(ring, *xs)
        for jp, tp in ((jk, ring.k), (jv, ring.v)):
            np.testing.assert_array_equal(np.asarray(jp.data),
                                          tp.data.numpy())
            np.testing.assert_array_equal(np.asarray(jp.meta),
                                          tp.meta.numpy())
            np.testing.assert_array_equal(np.asarray(jp.scale),
                                          tp.scale.numpy())
        np.testing.assert_array_equal(ring.slot_pos.numpy(), jsp)
        assert int(ring.pos) == jpos
        for want, got in zip(planes, (ring.k.data, ring.k.meta, ring.v.data,
                                      ring.v.meta)):
            np.testing.assert_array_equal(want, got.numpy())
        np.testing.assert_array_equal(sp, ring.slot_pos.numpy())
        for want, got in zip(emu, (ring.k.scale, ring.v.scale, ring.pos)):
            np.testing.assert_array_equal(want, got.numpy())


def test_write_slots_ring_on_the_int8_grid():
    """The port of tests/test_cache.py::test_write_slots_ring: two tokens
    at the wrapping slots 3 and 0 of a 4-slot int8-grid ring read back at
    0.5, the slots between untouched; the fp layout's `write_slots` is a
    plain indexed write."""
    ring = tcache.RingKVCache.init((1, 4, 1, 8), TCC.sparq_cache(
        TCfg(**INT8)), "cpu")
    ring.pos = torch.tensor(3, dtype=torch.int32)
    x = torch.full((1, 2, 1, 8), 0.5)
    ring.insert(x, x)
    out = ring.k.read().numpy()
    assert np.abs(out[0, 3] - 0.5).max() < 0.01
    assert np.abs(out[0, 0] - 0.5).max() < 0.01
    assert (out[0, 1:3] == 0).all()
    assert ring.slot_pos.tolist() == [[4, -1, -1, 3]] and int(ring.pos) == 5
    fp = tcache.CachedTensor.init((1, 4, 8), TCC.fp32(), "cpu")
    fp.write_slots(x[:, :, 0], torch.tensor([3, 0]))
    assert (fp.data[0, [0, 3]] == 0.5).all() and (fp.data[0, 1:3] == 0).all()


def _jax_ring(cfg_j, B, layout):
    cc = JCC.fp32() if layout == "fp" else JCC.sparq_cache(
        JCfg(**CODEC), impl="reference")
    return jtr.ring_init(cfg_j, B, cache_cfg=cc), cc


def _jax_ring_insert(ring, k, v):
    """The reference's `ring_insert`, its scales resolved eagerly first (the
    IEEE division of an eager write) and the write jitted with them."""
    if ring.k.is_sparq:
        ring = ring._replace(
            k=dataclasses.replace(ring.k, scale=ring.k._resolve_scale(k)),
            v=dataclasses.replace(ring.v, scale=ring.v._resolve_scale(v)))
    return _jitted_insert(ring, k, v)


_jitted_insert = jax.jit(jtr.ring_insert)
_jax_ring_decode = jax.jit(jtr.ring_decode_attention,
                           static_argnames=("window",))


@pytest.mark.parametrize("layout", ["fp", "sparq"])
def test_ring_priming_and_decode_match_jax(layout):
    """A 13-token prompt into a window of 8 (pos 5, the last 8 tokens at
    rotated slots, the sparq scale from that slab), then three decode
    writes that evict the oldest slots: planes, scales, slot_pos and pos
    equal the reference's after each; `ring_decode_attention` (fp: the
    full plane masked by slot position; sparq: the plain K5 over the
    rotated slot_pos) within ATOL of the reference's at every step, the
    port's ring started from the JAX one by `interop.cache_from_jax`."""
    jc, tc = _cfgs("recurrentgemma-9b", local_window=8)
    B, KV, hd, H = 2, tc.n_kv_heads, tc.head_dim, tc.n_heads
    rng = np.random.default_rng(11 + len(layout))
    jring, _ = _jax_ring(jc, B, layout)
    tcc = TCC.fp32() if layout == "fp" else TCC.sparq_cache(TCfg(**CODEC))
    tring = ttr.ring_init(tc, B, "cpu", tcc)
    k, v = (rng.standard_normal((B, 13, KV, hd)).astype(np.float32)
            for _ in range(2))
    jring = _jax_ring_insert(jring._replace(pos=jnp.int32(5)),
                             jnp.asarray(k[:, -8:]), jnp.asarray(v[:, -8:]))
    tring.pos = torch.tensor(5, dtype=torch.int32)
    ttr.ring_insert(tring, _t(k[:, -8:]), _t(v[:, -8:]))

    def same(what):
        for jp, tp in ((jring.k, tring.k), (jring.v, tring.v)):
            np.testing.assert_array_equal(np.asarray(jp.data),
                                          tp.data.numpy(), err_msg=what)
            if layout == "sparq":
                np.testing.assert_array_equal(np.asarray(jp.meta),
                                              tp.meta.numpy(), err_msg=what)
                np.testing.assert_array_equal(np.asarray(jp.scale),
                                              tp.scale.numpy(), err_msg=what)
        np.testing.assert_array_equal(np.asarray(jring.slot_pos),
                                      tring.slot_pos.numpy(), err_msg=what)
        assert int(jring.pos) == int(tring.pos), what
    same("primed")
    assert tring.slot_pos[0].tolist() == [8, 9, 10, 11, 12, 5, 6, 7]
    for step in range(3):
        kn, vn = (rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
                  for _ in range(2))
        jring = _jax_ring_insert(jring, jnp.asarray(kn), jnp.asarray(vn))
        ttr.ring_insert(tring, _t(kn), _t(vn))
        same(f"decode {step}")
        q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
        want = _jax_ring_decode(jnp.asarray(q), jring, window=8)
        got = ttr.ring_decode_attention(_t(q), tring, 8)
        _close(got, want, f"decode attention {step}")
        from_jax = interop.cache_from_jax(
            [jax.tree.map(lambda a: np.asarray(a)[None], jring)], tcc)[0]
        assert isinstance(from_jax, tcache.RingKVCache)
        _close(ttr.ring_decode_attention(_t(q), from_jax, 8), want,
               f"from the JAX ring {step}")


def _packed(rng, B, T, KV, hd, cfg):
    """§5.1 stored planes of random K/V quantized at a step of 0.02."""
    x = torch.from_numpy(rng.normal(size=(B, T, KV, hd)).astype(np.float32))
    codes, meta = tops.sparq_quantize(x, torch.tensor(0.02), cfg)
    return tops.sparq_pack(codes, meta), meta


def test_ring_and_paged_masking_agree():
    """The port of tests/test_paging.py::test_ring_and_paged_masking_agree:
    the ring (rotated slots, kpos = slot_pos) and the paged pool (logical
    order through a block table) express the same attention set; the
    plain K5 and K2 agree to fp tolerance."""
    rng = np.random.default_rng(5)
    B, KV, G, hd, W, ps = 2, 2, 2, 8, 8, 4
    cfg = TCfg.opt5(signed=True)
    Tk, cur = 16, 14
    kd, km = _packed(rng, B, Tk, KV, hd, cfg)
    vd, vm = _packed(rng, B, Tk, KV, hd, cfg)
    q = torch.from_numpy(rng.normal(size=(B, 1, KV * G, hd)).astype(
        np.float32))
    s = torch.tensor(0.02)
    ring = [torch.zeros((B, W, KV, hd), dtype=torch.int8) for _ in range(4)]
    ring_pos = torch.full((B, W), -1, dtype=torch.int32)
    for p in range(cur + 1):
        for dst, src in zip(ring, (kd, km, vd, vm)):
            dst[:, p % W] = src[:, p]
        ring_pos[:, p % W] = p
    want = tops.sparq_decode_attention(
        q, ring[0], ring[1], s, ring[2], ring[3], s, ring_pos,
        torch.tensor(cur, dtype=torch.int32), window=W)
    NB = Tk // ps
    perm = torch.from_numpy(rng.permutation(B * NB).astype(np.int32))
    bt = perm.reshape(B, NB)

    def pool(plane):
        out = torch.zeros((B * NB, ps, KV, hd), dtype=torch.int8)
        out[bt.reshape(-1).long()] = plane.reshape(B * NB, ps, KV, hd)
        return out
    sv = s.expand(B)
    got = tops.sparq_paged_decode_attention(
        q, pool(kd), pool(km), sv, pool(vd), pool(vm), sv, bt,
        torch.full((B,), cur, dtype=torch.int32), window=W)
    np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------------------------
# K4's ring mode: the wrapper's launches
# ----------------------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    """Replace K4's launch by a recorder of its named C arguments (the CPU
    tensors' pointers stand in for device ones)."""
    calls = []
    names = [n for _, n in _c_names(sq.KERNEL.source, sq.KERNEL.symbol)]

    def launch(*args):
        assert len(args) == len(names)
        calls.append({n: (a.value if hasattr(a, "value") else a)
                      for n, a in zip(names, args)})
    monkeypatch.setattr(sq.KERNEL, "launch", launch)
    monkeypatch.setattr(_b, "stream_ptr", lambda t: 0)
    return calls


def test_ring_write_launches(recorder):
    """CONTIG_ONE at T = 1, else CONTIG_SCALE then CONTIG_WRITE, each with
    the ring's slot_pos (the contiguous append passes none); a slot_pos of
    the wrong shape or a slab longer than the window raises before any
    launch."""
    B, W, KV, hd = 2, 8, 1, 16
    planes = [torch.zeros((B, W, KV, hd), dtype=torch.int8)
              for _ in range(4)]
    z, p0 = torch.zeros(()), torch.tensor(5, dtype=torch.int32)
    sp = torch.full((B, W), -1, dtype=torch.int32)
    kw = tops._codec_kw(TCfg(**CODEC))
    for T, modes in ((1, [sq.CONTIG_ONE]),
                     (W, [sq.CONTIG_SCALE, sq.CONTIG_WRITE])):
        x = torch.zeros((B, T, KV, hd), dtype=torch.bfloat16)
        sq.kv_write_ring_cuda(x, x.clone(), *planes, z, z, sp, p0, **kw)
        assert [c["mode"] for c in recorder] == modes
        assert {(c["rows"], c["n"], c["n_v"], c["T"], c["Tmax"],
                 c["slot_pos"], c["pos"]) for c in recorder} == {
            (B * T, KV * hd, KV * hd, T, W, sp.data_ptr(), p0.data_ptr())}
        recorder.clear()
    x = torch.zeros((B, 1, KV, hd))
    sq.kv_write_contiguous_cuda(x, x.clone(), *planes, z, z, p0, **kw)
    assert recorder[0]["slot_pos"] is None
    recorder.clear()
    with pytest.raises(ValueError, match="slot_pos"):
        sq.kv_write_ring_cuda(x, x.clone(), *planes, z, z, sp[:, :4], p0,
                              **kw)
    with pytest.raises(ValueError, match="exceeds"):
        tops.kv_write_ring(torch.zeros((B, W + 1, KV, hd)),
                           torch.zeros((B, W + 1, KV, hd)), *planes, z, z,
                           sp, p0, TCfg(**CODEC))
    assert recorder == []


def test_ring_decode_reads_the_packed_planes(monkeypatch):
    """On the sparq layout the ring's decode goes to the fused decode
    (K5's wrapper on the card) with kpos = slot_pos, cur = pos - 1 and
    the window, and never reads a plane whole."""
    _, tc = _cfgs("recurrentgemma-9b", local_window=8)
    ring = ttr.ring_init(tc, 2, "cpu", TCC.sparq_cache(TCfg(**CODEC)))
    x = torch.randn((2, 3, 1, tc.head_dim))
    ring.insert(x, x)
    seen = {}

    def fake(q, *a, window=0, bk=None):
        seen.update(kpos=a[6], cur=a[7], window=window)
        return torch.zeros(q.shape)
    monkeypatch.setattr(tops, "sparq_decode_attention", fake)
    monkeypatch.setattr(tcache.CachedTensor, "read", None)
    ttr.ring_decode_attention(torch.zeros((2, 1, tc.n_heads, tc.head_dim)),
                              ring, 8)
    assert seen["kpos"] is ring.slot_pos and int(seen["cur"]) == 2
    assert seen["window"] == 8
