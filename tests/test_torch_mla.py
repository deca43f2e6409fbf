"""Port parity, MLA and deepseek-v2-lite-16b: `repro_torch.models.mla`
against `repro.models.mla` on the same numpy inputs, the two-width
contiguous write of K4's plain version against the reference's eager
`CachedTensor.append`, the plain version of K7 (`kernels/sparq_mla_decode.
py::ref_sparq_mla_decode`, which CPU tensors take through `kernels.ops`)
against `_sparq_mla_decode`, and the reduced deepseek end to end.

Tolerance: MLA_ATOL (1e-5) on f32 values of O(1) for `mla_block` and the
latent decode (the einsums sum in other orders in XLA and PyTorch);
LOGIT_ATOL (2e-4) on logits as in tests/test_torch_moe.py; none for cache
bytes, scales, weight codes and greedy tokens.
"""
import dataclasses
import re

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
from repro.models import mla as jmla
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
from repro_torch.kernels import build as _b
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparq_mla_decode as k7
from repro_torch.kernels import sparq_quant as sq
from repro_torch.kernels.build import CSRC
from repro_torch.launch import serve as tserve
from repro_torch.models import cache as tcache
from repro_torch.models import mla as tmla
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.model import Model as TModel
from repro_torch.models.quantize import quantize_params as tquantize
from test_torch_kv_write import emu_contiguous

MLA_ATOL = 1e-5
LOGIT_ATOL = 2e-4
ARCH = "deepseek-v2-lite-16b"
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
CODEC = dict(bits=4, opts=5, signed=True)
MLA_SITES = {"mla_q", "mla_dkv", "mla_uk", "mla_uv", "mla_out"}


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
    """A port param tree (the JAX layout) as the reference's arrays: the
    tests draw weights with the port's seeded init, which is quicker than
    jax.random's eager draws."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _f32(cfg_get, **kw):
    return cfg_get(ARCH).replace(dtype=jnp.float32, remat=False, **kw)


def _tf32(cfg_get, **kw):
    return cfg_get(ARCH).replace(dtype=torch.float32, remat=False, **kw)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_jax(reduced):
    assert ARCH in ARCHS
    jc = (jcfg_reduced if reduced else jcfg)(ARCH)
    tc = (tcfg_reduced if reduced else tcfg)(ARCH)
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        want = DTYPES.get(want, want) if not isinstance(
            want, (int, float, str, bool, tuple)) else want
        assert getattr(tc, f.name) == want, (jc.name, f.name)
    assert tc.kv_lora_rank and tc.first_dense_layers == 1
    kinds = TModel(tc, device="cpu").kinds
    assert kinds == JModel(jc).kinds
    assert kinds == ["mla_dense"] + ["mla_moe"] * (tc.n_layers - 1)


# ----------------------------------------------------------------------
# the layer on its own
# ----------------------------------------------------------------------

def _caches(layout, B, Tmax, cfg_j, cfg_t):
    if layout == "fp":
        jc, tc = JCC.fp32(), TCC.fp32()
    else:
        jc = JCC.sparq_cache(JCfg(**CODEC), impl="reference")
        tc = TCC.sparq_cache(TCfg(**CODEC))
    return (jmla.mla_cache_init(cfg_j, B, Tmax, cache_cfg=jc),
            tmla.mla_cache_init(cfg_t, B, Tmax, "cpu", tc))


def _assert_same_cache(jc, tc, exact=True):
    """Packed planes bit for bit (`exact`) and their scales equal; fp
    planes hold the f32 latents, which XLA and PyTorch round an ulp apart,
    within MLA_ATOL. Not `exact`: the prefill's scales, each the max |x|
    of latents an ulp apart, within an ulp."""
    for jp, tp in ((jc.c_kv, tc.c_kv), (jc.k_pe, tc.k_pe)):
        if tp.meta is None:
            np.testing.assert_allclose(tp.data.numpy(), np.asarray(jp.data),
                                       rtol=0, atol=MLA_ATOL)
        elif exact:
            np.testing.assert_array_equal(np.asarray(jp.data),
                                          tp.data.numpy())
            np.testing.assert_array_equal(np.asarray(jp.meta),
                                          tp.meta.numpy())
        if exact:
            np.testing.assert_array_equal(np.asarray(jp.scale),
                                          tp.scale.numpy())
        else:
            np.testing.assert_array_max_ulp(np.asarray(jp.scale),
                                            tp.scale.numpy(), maxulp=1)
    assert int(jc.pos) == int(tc.pos)


_jax_mla_block = jax.jit(jmla.mla_block,
                         static_argnames=("cfg", "mode", "ctx"))


@pytest.mark.parametrize("layout", ["fp", "sparq"])
def test_mla_block_matches_jax(layout):
    """Train (naive form), prefill (naive form, the cache written) and two
    decode steps (absorbed form: the full-plane read on fp planes, the
    tiled latent decode on sparq planes) on the same f32 inputs and
    JAX-drawn weights, the reference jitted. The prefill's caches agree
    to an ulp of scale (the latents do, and XLA divides by max_val as a
    multiplication by its reciprocal); the decode steps start the port
    from the JAX cache (`interop.cache_from_jax`), and then bytes, frozen
    scales and positions equal."""
    jc, tc = _f32(jcfg_reduced), _tf32(tcfg_reduced)
    tp = tmla.mla_init(torch.Generator().manual_seed(5), tc, "cpu")
    tp["c_norm"] = torch.from_numpy(np.random.default_rng(5).uniform(
        -0.5, 0.5, tc.kv_lora_rank).astype(np.float32))   # a gain of 1 + c
    p = _to_jax(tp)
    B, T, Tmax = 2, 9, 16
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T))
    jo, _ = _jax_mla_block(p, jnp.asarray(x), jc, positions=jnp.asarray(pos),
                           mode="train")
    to, _ = tmla.mla_block(tp, torch.from_numpy(x), tc,
                           positions=torch.from_numpy(pos.copy()),
                           mode="train")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=MLA_ATOL, err_msg="train")
    jcache_, tcache_ = _caches(layout, B, Tmax, jc, tc)
    jo, jcache_ = _jax_mla_block(p, jnp.asarray(x), jc,
                                 positions=jnp.asarray(pos), cache=jcache_,
                                 mode="prefill")
    to, tcache_ = tmla.mla_block(tp, torch.from_numpy(x), tc,
                                 positions=torch.from_numpy(pos.copy()),
                                 cache=tcache_, mode="prefill")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=MLA_ATOL, err_msg="prefill")
    _assert_same_cache(jcache_, tcache_, exact=False)
    tcache_ = interop.cache_from_jax(
        [jax.tree.map(lambda a: np.asarray(a)[None], jcache_)],
        TCC.fp32() if layout == "fp" else TCC.sparq_cache(TCfg(**CODEC)))[0]
    assert isinstance(tcache_, tcache.MLACache)
    for step in range(2):
        xd = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        pd = np.full((B, 1), T + step)
        jo, jcache_ = _jax_mla_block(p, jnp.asarray(xd), jc,
                                     positions=jnp.asarray(pd),
                                     cache=jcache_, mode="decode")
        to, tcache_ = tmla.mla_block(tp, torch.from_numpy(xd), tc,
                                     positions=torch.from_numpy(pd),
                                     cache=tcache_, mode="decode")
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=MLA_ATOL, err_msg=f"decode {step}")
        _assert_same_cache(jcache_, tcache_)


# ----------------------------------------------------------------------
# K4: the two-width contiguous write, plain version
# ----------------------------------------------------------------------

_jax_write = jax.jit(lambda ct, x, scale, pos: dataclasses.replace(
    ct, scale=scale).append(x, pos))


def _jax_append(ct, x, pos=0):
    """The reference's `CachedTensor.append`: its scale resolved eagerly
    (`_resolve_scale`, the IEEE division by max_val of an eager append;
    under jit XLA multiplies by the reciprocal), then the append jitted
    with that scale in place of the stored one, which it then keeps (a
    scale > 0 is frozen): the eager append's bytes and scale, without
    compiling each of its ops for every shape."""
    return _jax_write(ct, x, ct._resolve_scale(x), jnp.int32(pos))


def _slab(rng, shape, dtype, amp=1.0):
    x = (rng.standard_normal(shape) * amp).astype(np.float32)
    x[rng.random(shape) < 0.25] = 0.0        # vSPARQ's partner-zero rule
    t = torch.from_numpy(x).to(dtype)
    return t.to(torch.float32).numpy(), t


# (r, dr): the reduced widths and deepseek-v2-lite's
WIDTHS = [(32, 16), (512, 64)]
# the prefill slab, two decode tokens, a slab past capacity (the start
# clamps so it fits), each at its own range
MLA_STEPS = ((5, 1.0), (1, 3.0), (1, 0.5), (5, 2.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r,dr", WIDTHS)
def test_two_width_write_matches_jax_append(r, dr, dtype):
    """`MLACache.update` (K4's plain contiguous write with rows of r and
    dr) against the reference's `CachedTensor.append` (`_jax_append`),
    one plane at a time: codes, meta, scales (resolved at the first write,
    each plane its own, then frozen) and positions bit for bit; and a
    numpy emulation of the kernel's control flow (`emu_contiguous`, each
    plane's rows at its own width) against the plain write."""
    B, Tmax = 2, 8
    jc = JCC.sparq_cache(JCfg(**CODEC), impl="reference")
    tc = TCC.sparq_cache(TCfg(**CODEC))
    jt = jcache.CachedTensor.init
    jplanes = [jt((B, Tmax, r), jc), jt((B, Tmax, dr), jc)]
    jpos = 0
    ts = tcache.MLACache.init(B, Tmax, r, dr, tc, "cpu")
    rng = np.random.default_rng(r + dr)
    for T, amp in MLA_STEPS:
        c, tcv = _slab(rng, (B, T, r), dtype, amp)
        pe, tpe = _slab(rng, (B, T, dr), dtype, amp * 4)
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        jplanes = [_jax_append(pl, jnp.asarray(x).astype(jd), jpos)
                   for pl, x in zip(jplanes, (c, pe))]
        jpos += T
        planes = [t.numpy().copy() for t in (ts.c_kv.data, ts.c_kv.meta,
                                             ts.k_pe.data, ts.k_pe.meta)]
        emu = emu_contiguous((c, pe), planes, (ts.c_kv.scale.numpy(),
                                               ts.k_pe.scale.numpy()),
                             ts.pos.numpy(), TCfg(**CODEC))
        ts.update(tcv, tpe)
        for jp, tp in zip(jplanes, ts.planes):
            np.testing.assert_array_equal(np.asarray(jp.data),
                                          tp.data.numpy())
            np.testing.assert_array_equal(np.asarray(jp.meta),
                                          tp.meta.numpy())
            np.testing.assert_array_equal(np.asarray(jp.scale),
                                          tp.scale.numpy())
        assert int(ts.pos) == jpos        # the reference's pos + T
        for want, got in zip(planes, (ts.c_kv.data, ts.c_kv.meta,
                                      ts.k_pe.data, ts.k_pe.meta)):
            np.testing.assert_array_equal(want, got.numpy())
        for want, got in zip(emu, (ts.c_kv.scale, ts.k_pe.scale, ts.pos)):
            np.testing.assert_array_equal(want, got.numpy())
    assert float(ts.c_kv.scale) != float(ts.k_pe.scale)


def _c_names(source, symbol):
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r'\((.*?)\)\s*\{', text,
                  re.S)
    assert m, f"{symbol} not found in {source}"
    return [(p.strip().rsplit(" ", 1)[0], p.strip().rsplit(" ", 1)[1]
             .lstrip("*")) for p in m.group(1).split(",")]


@pytest.fixture
def recorder(monkeypatch):
    """Replace both kernels' launches by recorders of their named C
    arguments (the CPU tensors' pointers stand in for device ones)."""
    calls = []

    def rec(kernel):
        names = [n for _, n in _c_names(kernel.source, kernel.symbol)]

        def launch(*args):
            assert len(args) == len(names)
            calls.append({n: (a.value if hasattr(a, "value") else a)
                          for n, a in zip(names, args)})
        monkeypatch.setattr(kernel, "launch", launch)
    rec(sq.KERNEL)
    rec(k7.KERNEL)
    monkeypatch.setattr(_b, "stream_ptr", lambda t: 0)
    return calls


@pytest.mark.parametrize("name", ["sparq_quant", "sparq_mla_decode"])
def test_kernel_binding_matches_c_signature(name):
    """The ctypes argtypes follow the C entry point (pointers c_void_p,
    int c_int, float c_float), K4's with its second plane width."""
    import ctypes
    k = _b.KERNELS[name]
    want = {"int": ctypes.c_int, "float": ctypes.c_float}
    params = _c_names(k.source, k.symbol)
    assert len(params) == len(k.argtypes)
    for (c_type, _), arg in zip(params, k.argtypes):
        assert arg is (ctypes.c_void_p if "*" in c_type else want[c_type])
    assert k.replaces == {"sparq_quant": "src/repro/kernels/sparq_quant.py:79",
                          "sparq_mla_decode": "src/repro/models/mla.py:58"
                          }[name]


@pytest.mark.parametrize("r,dr", WIDTHS)
def test_two_width_write_launches(recorder, r, dr):
    """CONTIG_ONE at T = 1, else CONTIG_SCALE then CONTIG_WRITE, each with
    n = r and n_v = dr; a GQA write passes n_v = n."""
    B, Tmax = 2, 12
    planes = [torch.zeros((B, Tmax, w), dtype=torch.int8)
              for w in (r, r, dr, dr)]
    z, p0 = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    for T, modes in ((1, [sq.CONTIG_ONE]),
                     (5, [sq.CONTIG_SCALE, sq.CONTIG_WRITE])):
        c = torch.zeros((B, T, r), dtype=torch.bfloat16)
        pe = torch.zeros((B, T, dr), dtype=torch.bfloat16)
        sq.kv_write_contiguous_cuda(c, pe, *planes, z, z, p0,
                                    **tops._codec_kw(TCfg(**CODEC)))
        assert [x["mode"] for x in recorder] == modes
        assert {(x["rows"], x["n"], x["n_v"], x["T"], x["Tmax"])
                for x in recorder} == {(B * T, r, dr, T, Tmax)}
        assert recorder[0]["v_meta"] == planes[3].data_ptr()
        recorder.clear()
    kv = torch.zeros((B, 1, 2, 16))
    pools = [torch.zeros((B, Tmax, 2, 16), dtype=torch.int8)
             for _ in range(4)]
    sq.kv_write_contiguous_cuda(kv, kv.clone(), *pools, z, z, p0,
                                **tops._codec_kw(TCfg(**CODEC)))
    assert (recorder[0]["n"], recorder[0]["n_v"]) == (32, 32)
    with pytest.raises(ValueError, match="v_data"):
        sq.kv_write_contiguous_cuda(c, pe[:, :, :dr - 2].contiguous(),
                                    *planes, z, z, p0,
                                    **tops._codec_kw(TCfg(**CODEC)))


# ----------------------------------------------------------------------
# K7: the latent decode, plain version
# ----------------------------------------------------------------------

def _mla_planes(seed, B=2, Tmax=24, pos=13, r=32, dr=16, H=4):
    """A reduced-width latent cache written by the reference (every slot
    holds a key; those at pos and beyond must be masked), and random
    queries."""
    jc = JCC.sparq_cache(JCfg(**CODEC), impl="reference")
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((B, Tmax, r)).astype(np.float32)
    pe = (rng.standard_normal((B, Tmax, dr)) * 2).astype(np.float32)
    jt = jcache.CachedTensor.init
    cache = jmla.MLACache(_jax_append(jt((B, Tmax, r), jc), jnp.asarray(c)),
                          _jax_append(jt((B, Tmax, dr), jc),
                                      jnp.asarray(pe)),
                          jnp.asarray(pos, jnp.int32))
    q_lat = rng.standard_normal((B, 1, H, r)).astype(np.float32)
    q_pe = rng.standard_normal((B, 1, H, dr)).astype(np.float32)
    tc = TCC.sparq_cache(TCfg(**CODEC))
    tcache_ = interop.cache_from_jax(
        [jax.tree.map(lambda a: np.asarray(a)[None], cache)], tc)[0]
    return cache, tcache_, q_lat, q_pe


_jax_mla_decode = jax.jit(jmla._sparq_mla_decode,
                          static_argnames=("sm_scale", "out_dtype", "bk"))


@pytest.mark.parametrize("bk", [8, 128])
@pytest.mark.parametrize("pos", [13, 16, 24])
def test_plain_mla_decode_matches_jax(bk, pos):
    """`ops.sparq_mla_decode` on CPU tensors (the plain version) against
    the reference's `_sparq_mla_decode` (jitted: no write in it) at a tile
    of 8 and of 128 keys, pos inside a tile, on a tile boundary and at
    the capacity; and against the full-plane read plus a plain softmax
    (tests/test_cache.py's oracle)."""
    cache, tc, q_lat, q_pe = _mla_planes(pos, pos=pos)
    assert isinstance(tc, tcache.MLACache) and int(tc.pos) == pos
    sm = (32 + 16) ** -0.5
    want = np.asarray(_jax_mla_decode(
        jnp.asarray(q_lat), jnp.asarray(q_pe), cache, sm_scale=sm,
        out_dtype=jnp.float32, bk=bk))
    got = tops.sparq_mla_decode(
        torch.from_numpy(q_lat), torch.from_numpy(q_pe), tc.c_kv.data,
        tc.c_kv.meta, tc.c_kv.scale, tc.k_pe.data, tc.k_pe.meta,
        tc.k_pe.scale, tc.pos, sm_scale=sm, out_dtype=torch.float32,
        bk=bk).numpy()
    assert got.shape == want.shape == q_lat.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=MLA_ATOL)
    c_full, pe_full = cache.c_kv.read(), cache.k_pe.read()
    s = (jnp.einsum("bthr,bsr->bhts", q_lat, c_full) +
         jnp.einsum("bthe,bse->bhts", q_pe, pe_full)) * sm
    s = jnp.where((jnp.arange(24) < pos)[None, None, None], s, -jnp.inf)
    oracle = np.asarray(jnp.einsum("bhts,bsr->bthr",
                                   jax.nn.softmax(s, axis=-1), c_full))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=MLA_ATOL)


def _bf16(x):
    """x (f32) rounded to the nearest bf16, ties to even, as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _split_f16(x, n):
    """x split into n f16 terms, each the rounding (to nearest, ties to
    even, subnormals kept) of what the earlier ones leave: the kernel's
    split_f16."""
    x = np.asarray(x, np.float32)
    terms = []
    for _ in range(n):
        t = x.astype(np.float16).astype(np.float32)
        terms.append(t)
        x = (x - t).astype(np.float32)
    return terms


# clusters of n K7 blocks (204,160 bytes of shared memory, one an SM) an
# NVIDIA H100 80GB HBM3 holds at once, as its cudaOccupancyMaxActiveClusters
# gives them (probes/k7_probe.py prints the card's): the capacity the
# recorded launches and the plan tests take in place of the card's answer
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15,
                 9: 9, **{n: 7 for n in range(10, 17)}}


def _runs(live, tile, n_splits):
    """The kernel's cut of the live keys t < live: ceil(live / tile) tiles
    in n_splits runs of ceil(tiles / n_splits); run z as a range of tiles,
    empty when it starts past them."""
    tiles = -(-live // tile)
    tps = -(-tiles // n_splits)
    return [range(min(z * tps, tiles), min((z + 1) * tps, tiles))
            for z in range(n_splits)]


def _emulate_k7(q_lat, q_pe, c, pe, cs, ps, pos, sm, tile, n_splits,
                q_terms=k7.Q_TERMS, p_terms=k7.P_TERMS):
    """K7's arithmetic in numpy. c, pe: the planes' codes before their
    scales (exact in f16). q times its plane's scale and sm in f32, each
    head row times 2^k (k = 14 - floor(log2 of its largest |entry|),
    clamped to [-100, 100]) and split into q_terms f16 terms; per split,
    its run of the live tiles of `tile` keys (`_runs`), each tile's live
    keys (t < min(pos, Tk)) scored on the tensor cores (exact products,
    modelled as f64 sums rounded to f32) and the row's 2^k undone, the f32
    online softmax (corr 0 for the first tile), p 2^15 split into p_terms
    f16 terms for P V (f64 sums rounded to f32), acc = acc corr + P V in
    f32; then the cluster's combine: w = e^(m - M) in f32 (0 for an empty
    split), l and the accumulators summed in split order in f32, out = sum
    / max(l, 1e-30) * (c_scale 2^-15)."""
    f32 = np.float32
    B, H, r = q_lat.shape
    Tk = c.shape[1]
    live = max(0, min(pos, Tk))
    qs = np.concatenate([(q_lat * f32(cs)).astype(f32) * f32(sm),
                         (q_pe * f32(ps)).astype(f32) * f32(sm)], -1)
    mx = np.abs(qs).max(-1, keepdims=True)
    e = np.frexp(np.where(mx > 0, mx, f32(1)))[1] - 1      # ilogbf
    un = np.where(mx > 0, np.ldexp(f32(1), np.clip(e - 14, -100, 100)),
                  f32(1)).astype(f32)
    q_split = [t.astype(np.float64) for t in
               _split_f16((qs / un).astype(f32), q_terms)]
    keys = np.concatenate([c, pe], -1).astype(np.float64)
    out = np.zeros((B, H, r), f32)
    for b in range(B):
        parts = []
        for run in _runs(live, tile, n_splits):
            m = np.full(H, -np.inf, f32)
            l_ = np.zeros(H, f32)
            acc = np.zeros((H, r), f32)
            for u in run:
                k0 = u * tile
                nk = min(tile, live - k0)
                kt = keys[b, k0:k0 + nk]
                s = (sum(q[b] @ kt.T for q in q_split).astype(f32)
                     * un[b]).astype(f32)
                m_new = np.maximum(m, s.max(1))
                corr = np.where(np.isneginf(m), f32(0),
                                np.exp(m - m_new)).astype(f32)
                p = np.exp(s - m_new[:, None]).astype(f32)
                l_ = (l_ * corr + p.sum(1, dtype=f32)).astype(f32)
                pv = sum(t.astype(np.float64) @ kt[:, :r] for t in
                         _split_f16(p * f32(32768), p_terms)).astype(f32)
                acc = (acc * corr[:, None] + pv).astype(f32)
                m = m_new
            parts.append((m, l_, acc))
        M = np.max([x[0] for x in parts], 0)
        lsum = np.zeros(H, f32)
        x = np.zeros((H, r), f32)
        for m, l_, acc in parts:
            w = np.zeros(H, f32)
            ok = ~np.isneginf(m)
            w[ok] = np.exp(m[ok] - M[ok])
            lsum = (lsum + w * l_).astype(f32)
            x = (x + w[:, None] * acc).astype(f32)
        out[b] = (x / np.maximum(lsum, f32(1e-30))[:, None]).astype(f32) \
            * (f32(cs) * f32(2 ** -15))
    return out


@pytest.mark.parametrize("pos", [0, 1, 13, 16, 17, 24])
def test_k7_emulation_matches_plain(pos):
    """The kernel's arithmetic (q and p split into f16 terms over the
    exact codes, the online softmax across a split's tiles, the live
    prefix a split derives from pos alone, an empty split weighing 0, a
    cache with no live key giving zeros, the cluster's combine) against
    the plain version: at the card's plan for these 24 slots (one tile of
    32 keys), and at plans of several tiles a split and several splits
    (tiles of 4 keys in 3 splits, of 8 in 2 with a ragged last split, of 4
    in 5, where a pos of few live tiles leaves splits empty)."""
    from repro_torch.kernels.ref import _meta_decode32
    _, tc, q_lat, q_pe = _mla_planes(3, pos=pos)
    sm = (32 + 16) ** -0.5
    args = (torch.from_numpy(q_lat[:, 0]), torch.from_numpy(q_pe[:, 0]),
            tc.c_kv.data, tc.c_kv.meta, tc.c_kv.scale, tc.k_pe.data,
            tc.k_pe.meta, tc.k_pe.scale, tc.pos)
    want = k7.ref_sparq_mla_decode(*args, sm_scale=sm).numpy()
    one = torch.ones(())
    c = _meta_decode32(tc.c_kv.data, tc.c_kv.meta, one).numpy()
    pe = _meta_decode32(tc.k_pe.data, tc.k_pe.meta, one).numpy()
    cs, ps = float(tc.c_kv.scale), float(tc.k_pe.scale)
    card = k7.plan(2, 4, 32, 16, 24, H100_CLUSTERS)
    assert (card.tile, card.n_splits) == (32, 1)
    for tile, n in ((card.tile, card.n_splits), (4, 3), (8, 2), (4, 5)):
        got = _emulate_k7(q_lat[:, 0], q_pe[:, 0], c, pe, cs, ps, pos, sm,
                          tile, n)
        np.testing.assert_allclose(got, want, rtol=0, atol=MLA_ATOL,
                                   err_msg=f"tile {tile}, {n} splits")
    if pos == 0:
        assert not want.any()


def test_k7_codes_exact_in_bf16():
    """For every stored byte, meta byte and lane parity, the §5.1 decode
    before its scale (the plain version's `_meta_decode32` at scale 1) is
    q * 2^shift, the kernel's decode, and is exact in bf16 and in f16 (at
    most 8 significant bits, |code| <= 2^14 < f16's 65504): so the
    kernel's f16 tile holds the codes exactly."""
    from repro_torch.kernels.ref import _meta_decode32
    q, m = np.meshgrid(np.arange(-128, 128), np.arange(-128, 128),
                       indexing="ij")
    q, m = q.reshape(-1), m.reshape(-1)
    data = torch.from_numpy(np.stack([q, q], -1).astype(np.int8))[None]
    meta = torch.from_numpy(np.stack([m, m], -1).astype(np.int8))[None]
    codes = _meta_decode32(data, meta, torch.ones(())).numpy()[0]
    for parity in (0, 1):
        shift = (m & 7) if parity else ((m >> 3) & 7)
        lane = codes[:, parity]
        np.testing.assert_array_equal(lane,
                                      (q * (1 << shift)).astype(np.float32))
        np.testing.assert_array_equal(_bf16(lane), lane)
        np.testing.assert_array_equal(
            lane.astype(np.float16).astype(np.float32), lane)
    assert np.abs(codes).max() == 128 << 7


@pytest.mark.parametrize("name,shape,want", [
    ("mla", (8, 16, 512, 64, 296), (10, 9)),
    ("reduced", (8, 4, 32, 16, 296), (10, 9)),
    ("long", (8, 16, 512, 64, 8192), (256, 9)),
    ("64K at B 1", (1, 16, 512, 64, 65536), (2048, 16)),
])
def test_k7_plan(name, shape, want):
    """`plan` at the mla phase's, the reduced and the long shapes and a
    65,536-key cache at B 1 (which the ticket design refused) under the
    H100's cluster capacity: the tiles and splits; one block's shared
    memory within the card's, whatever Tk; the splits never above 16 nor
    above the tiles, and all the call's clusters held at once. The
    kernel's cut of the live tiles (`_runs`) at every pos: each live key
    in exactly one split, and no split walking more than ceil(live tiles
    / splits), so a long cache early in decode (pos 300 of 8192) does not
    leave its live tiles to one block."""
    B, H, r, dr, Tk = shape
    p = k7.plan(B, H, r, dr, Tk, H100_CLUSTERS)
    assert (p.n_tiles, p.n_splits) == want
    assert p.tile == k7.TILE and p.head_groups == 1
    assert p.smem == k7.smem_bytes(r, dr) <= _b.SMEM_LIMIT
    assert p.n_splits <= min(k7.MAX_SPLITS, p.n_tiles)
    assert H100_CLUSTERS[p.n_splits] >= B * p.head_groups
    for pos in sorted({0, 1, 31, 32, 33, 300, Tk // 2, Tk - 1, Tk,
                       Tk + 5}):
        live = min(pos, Tk)
        runs = _runs(live, p.tile, p.n_splits)
        seen = np.zeros(Tk, int)
        for run in runs:
            for u in run:
                k0 = u * p.tile
                seen[k0:min(k0 + p.tile, live)] += 1
        assert (seen[:live] == 1).all() and not seen[live:].any()
        assert max(map(len, runs)) == -(-(-(-live // p.tile)) // p.n_splits)


def test_k7_wrapper_launch(recorder, monkeypatch):
    """One launch with the call's sizes and `plan`'s clusters under the
    H100's capacity (2 splits for 40 slots at B 2; 16 splits for a
    65,536-key cache at B 1), no workspace, counter or run length (the
    kernel cuts the live tiles from pos), 16-byte vectors only for aligned
    planes of widths that are multiples of 16; shapes, dtypes and widths
    the kernel does not take raise."""
    monkeypatch.setattr(k7, "cluster_capacity",
                        lambda dev, r, dr: H100_CLUSTERS)
    B, H, r, dr, Tk = 2, 16, 512, 64, 40
    assert k7.smem_bytes(r, dr) == 204160 <= _b.SMEM_LIMIT
    assert k7.smem_bytes(32, 16) == 38272
    assert k7.instance(r, dr) == (5, 4) and k7.instance(32, 16) == (1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        k7.plan(1, 16, 768, 64, 40, H100_CLUSTERS)
    ql, qp = torch.zeros((B, H, r)), torch.zeros((B, H, dr))

    def planes(w, misalign=False, B=B, Tk=Tk):
        if not misalign:
            return [torch.zeros((B, Tk, w), dtype=torch.int8)
                    for _ in range(2)]
        buf = torch.zeros((2, B * Tk * w + 1), dtype=torch.int8)
        return [buf[i, 1:].view(B, Tk, w) for i in range(2)]
    one = torch.ones(())
    p = torch.tensor(17, dtype=torch.int32)
    for mis in (False, True):
        cd, cm = planes(r, mis)
        pd, pm = planes(dr)
        out = k7.sparq_mla_decode_cuda(ql, qp, cd, cm, one, pd, pm, one, p,
                                       sm_scale=0.1)
        assert out.shape == (B, H, r) and out.dtype == torch.float32
        (x,) = recorder
        assert (x["B"], x["H"], x["rank"], x["dr"], x["Tk"], x["n_splits"],
                x["vec"]) == (B, H, r, dr, Tk, 2, int(not mis))
        assert (x["cd"], x["pos"]) == (cd.data_ptr(), p.data_ptr())
        assert not {"ws", "counters", "tiles_per_split"} & set(x)
        recorder.clear()
    long_planes = planes(r, B=1, Tk=65536) + planes(dr, B=1, Tk=65536)
    k7.sparq_mla_decode_cuda(ql[:1], qp[:1], long_planes[0], long_planes[1],
                             one, long_planes[2], long_planes[3], one, p,
                             sm_scale=0.1)
    (x,) = recorder
    assert (x["B"], x["Tk"], x["n_splits"]) == (1, 65536, 16)
    recorder.clear()
    with pytest.raises(ValueError, match="q_lat"):
        k7.sparq_mla_decode_cuda(ql.double(), qp, cd, cm, one, pd, pm, one,
                                 p, sm_scale=0.1)
    with pytest.raises(ValueError, match="pe_data"):
        k7.sparq_mla_decode_cuda(ql, qp, cd, cm, one, pd[:, :, :8], pm, one,
                                 p, sm_scale=0.1)
    assert recorder == []


# ----------------------------------------------------------------------
# the reduced deepseek, end to end
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds():
    """The reduced deepseek cut to 2 layers (one mla_dense, one mla_moe)
    in f32 in both packages: the port's seeded weights and their JAX copy,
    both quantized by their own package, and the port's calibrated spans
    for both (the calibration code is the dense family's, held against
    JAX's in tests/test_torch_dense_family.py; here what is new is the
    MLA sites it sees)."""
    jc, tc = _f32(jcfg_reduced, n_layers=2), _tf32(tcfg_reduced, n_layers=2)
    jm, tm = JModel(jc), TModel(tc, device="cpu")
    tp = tm.init_params(0)
    jp = _to_jax(tp)
    calib = [{"tokens": np.random.default_rng(11).integers(
        0, jc.vocab_size, (2, 16))}]
    tscales = tm.calibrate(tp, calib)
    snapped = [{k: _snap(v.numpy()) for k, v in g.items()} for g in tscales]
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, tscales=tscales,
                jscales=[{k: jnp.asarray(v) for k, v in g.items()}
                         for g in snapped],
                tsnapped=[{k: torch.from_numpy(v) for k, v in g.items()}
                          for g in snapped],
                jq=jquantize(jp), tq=tquantize(tp))


def _snap(spans):
    """Each span moved up by the fewest ulps for which span / 127 and span
    x fl(1 / 127) round alike in f32: jitted, XLA divides the span by
    qmax as a multiplication by the reciprocal, the port (and an eager
    reference) by an IEEE division. With such spans the jitted reference
    computes the eager one's activation scales, so it can stand in for
    the eager layers (whose ops would compile one by one)."""
    v = np.asarray(spans, np.float32).copy()
    q = np.float32(127)
    r = np.float32(1) / q
    for i in range(v.size):
        while v.flat[i] / q != v.flat[i] * r:
            v.flat[i] = np.nextafter(v.flat[i], np.float32(np.inf))
    return v


def test_calibration_sees_every_mla_site(ds):
    """`Model.calibrate` (mode train, the naive form) gives a span at all
    five MLA sites of every layer, and at the FFN sites of the dense
    layer; `quant_sites` lists the reference's."""
    tm = ds["tm"]
    assert [set(g) for g in ds["tscales"]] == [
        MLA_SITES | {"ffn_gate", "ffn_up", "ffn_down"}, MLA_SITES]
    assert tm.quant_sites() == ds["jm"].quant_sites()
    assert set(tm.quant_sites()) == MLA_SITES | {"ffn_gate", "ffn_up",
                                                 "ffn_down"}
    assert all(bool((v > 0).all()) for g in ds["tscales"]
               for v in g.values())


def _jax_logits(jm, jp, toks, codec=None, jscales=None):
    """The JAX logits, the layers applied one by one (as tests/
    test_torch_dense_family.py::_jax_logits does eagerly), jitted: with
    `codec`, quantized over the `_snap`ped spans `jscales`."""
    cfg = jm.cfg

    def logits(p, toks, scales):
        x, _ = jm._embed_in(p, {"tokens": toks}, cfg.dtype)
        pos = jnp.broadcast_to(jnp.arange(toks.shape[1])[None], toks.shape)
        for gi, (kind, count) in enumerate(jm.groups_meta):
            for li in range(count):
                ctx = None if codec is None else JCtx(
                    mode="quantized", cfg=codec, impl="reference",
                    scales={s: v[li] for s, v in scales[gi].items()})
                x, _, _ = jtr.block_apply(
                    jax.tree.map(lambda a: a[li], p["blocks"][gi]), x, cfg,
                    kind, positions=pos, mode="train", ctx=ctx)
        x = jcommon.norm(p["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return jm._head(p, x)
    return np.asarray(jax.jit(logits)(jp, jnp.asarray(toks), jscales))


def test_logits_match_jax(ds):
    """Float logits, and 5opt logits over each package's int8 weight codes
    and the calibrated spans (`_snap`ped), against the JAX layers."""
    jm, tm = ds["jm"], ds["tm"]
    toks = np.random.default_rng(1).integers(0, 512, (2, 16))
    np.testing.assert_allclose(tm.logits(ds["tp"], {"tokens": toks}).numpy(),
                               _jax_logits(jm, ds["jp"], toks), rtol=0,
                               atol=LOGIT_ATOL, err_msg="off")
    want = _jax_logits(jm, ds["jq"], toks, JCfg(**CODEC), ds["jscales"])
    got = tm.logits(ds["tq"], {"tokens": toks},
                    TCtx(mode="quantized", cfg=TCfg(**CODEC)),
                    scales_groups=ds["tsnapped"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL,
                               err_msg="5opt")


def test_quantize_params_quantizes_the_same_leaves(ds):
    """The MLA projections and layer 0's FFN become codes; c_norm, the
    router, the expert banks and the shared experts stay float in both
    packages; the codes are equal."""
    jq = jax.tree.map(np.asarray, ds["jq"])
    tq = ds["tq"]
    jl = jax.tree_util.tree_leaves_with_path(jq)
    tl = jax.tree_util.tree_leaves_with_path(tq)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, j), (_, t) in zip(jl, tl):
        assert str(t.dtype) == f"torch.{j.dtype.name}", path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    for g in tq["blocks"]:
        assert all(set(g["attn"][k]) == {"q", "s"}
                   for k in ("wq", "w_dkv", "w_uk", "w_uv", "wo"))
        assert torch.is_tensor(g["attn"]["c_norm"])
    assert set(tq["blocks"][0]["ffn"]["w_up"]) == {"q", "s"}
    assert all(torch.is_tensor(tq["blocks"][1]["moe"][k])
               for k in ("router", "w_up", "sh_up"))


@pytest.mark.parametrize("layout", ["fp32", "sparq"])
def test_scan_engine_tokens_equal_jax(ds, layout):
    """The scan engine, batch 2, on the float model: over an fp32 latent
    cache, and over the 5opt sparq latent cache (K4's two-width write, the
    latent decode on packed planes); tokens and the modeled cache bytes
    (576 values a layer at full width: c_kv and k_pe) equal JAX's. The
    quantized weights and activations are held by the logits test."""
    jm, tm = ds["jm"], ds["tm"]
    toks = np.random.default_rng(3).integers(0, 512, (2, 10))
    jcc, tcc = (JCC.fp32(), TCC.fp32()) if layout == "fp32" else (
        JCC.sparq_cache(JCfg(**CODEC), impl="reference"),
        TCC.sparq_cache(TCfg(**CODEC)))
    jtoks, jstats = jserve.DecodeEngine(jm, jcc).generate(
        ds["jp"], {"tokens": jnp.asarray(toks)}, 6, warmup=False)
    eng = tserve.DecodeEngine(tm, tcc)
    ttoks, tstats = eng.generate(ds["tp"], {"tokens": toks}, 6,
                                 warmup=False)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert all(isinstance(c, tcache.MLACache) for c in eng.last_caches)
    for k in ("cache_data_bytes", "cache_total_bytes"):
        assert tstats[k] == jstats[k], k
    cfg = tm.cfg
    values = 2 * (10 + 6 + 8) * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    assert tcache.modeled_cache_bytes(eng.last_caches)["values"] == \
        cfg.n_layers * values


def test_fused_decode_matches_fp_on_the_int8_grid():
    """The port of tests/test_cache.py::test_fused_decode_nondense_archs_
    match_fp for deepseek (3 layers, capacity factor 1000): the greedy
    tokens over an fp32 latent cache equal those over the int8-grid
    sparq cache (the latent decode on packed planes)."""
    tc = tcfg_reduced(ARCH).replace(dtype=torch.float32, remat=False,
                                    capacity_factor=1000.0)
    tm = TModel(tc, device="cpu")
    tp = tm.init_params(0)
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 16))
    t_fp, _ = tserve.DecodeEngine(tm, TCC.fp32()).generate(
        tp, {"tokens": toks}, 6, warmup=False)
    t_i8, _ = tserve.DecodeEngine(tm, TCC.sparq_cache(
        TCfg(enabled=False, signed=True))).generate(
        tp, {"tokens": toks}, 6, warmup=False)
    np.testing.assert_array_equal(t_fp, t_i8)


def test_paged_engine_refuses_mla(ds):
    with pytest.raises(ValueError, match="standard-KV"):
        tserve.ContinuousBatchingEngine(
            ds["tm"], TCC.sparq_cache(TCfg(**CODEC)), device="cpu")


def test_cli_serves_deepseek_on_cpu():
    """`--arch deepseek-v2-lite-16b --reduced` through the scan engine on
    the CPU (3 layers, int8 weight codes, 5opt latent cache); `--engine
    paged` refuses it."""
    common = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
              "12", "--gen", "3", "--calibrate", "1", "--prequantize",
              "--kv-cache", "sparq", "--sparq", "5opt", "--device", "cpu"]
    stats = tserve.main(common)
    assert stats["tokens"].shape == (2, 3)
    assert stats["cache_total_bytes"] > 0
    with pytest.raises(ValueError, match="standard-KV"):
        tserve.main(common + ["--engine", "paged"])
