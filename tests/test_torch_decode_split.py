"""K2's and K5's split-key decode body, on the CPU.

`kernels/sparq_decode_attn.py::split_plan` is the rule by which both CUDA
kernels cut a slot's keys into splits (one block per slot, KV head and
split) and skip tiles; the kernels cannot run here, so this file holds
what they rest on:

(a) coverage: every key the plain version leaves unmasked lies in exactly
    one tile of one split the plan lists, with windows, inactive slots,
    block-table holes, ring `kpos` with -1 runs and lengths that are not a
    multiple of a split; the partition is the same for K5 at bk = page size
    and for K2 over the same bytes;
(b) arithmetic: an emulation of the kernels' order (per split, tiles in
    order: q.k in f64 rounded to f32 times the f32 scale; f32 statistics;
    the sum of p in f64 over 32 lanes and a butterfly; p.v in f64 per
    tile; then the splits combined in f64, l by lane and a butterfly, acc
    in split order) agrees with the
    plain versions, the JAX oracles and `chip_smoke.decode_f64_reference`,
    and its K5 at bk = ps equals its K2 bit for bit;
(c) shapes: every ported config at the CLI defaults fits one block of the
    body in shared memory.

Tolerance for (b): 1e-4 absolute, the gate `chip_smoke.py` holds the
kernels to. Decoded values reach ~50 (codes up to 15 << 7 times scales up
to 0.025), so outputs reach tens, where one f32 ulp is ~4e-6; the plain
versions' f32 sums over hundreds of keys lie up to a few 1e-5 from the f64
evaluation, the emulation closer.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.kernels import sparq_decode_attn as dec
from repro_torch.kernels.build import CSRC, SMEM_LIMIT
from repro_torch.kernels.ops import DEFAULT_BK

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def test_constants_are_the_kernels():
    """The split size, the block's threads and the shared-memory formula
    the wrappers use are the ones the CUDA body compiles."""
    src = (CSRC / "sparq_decode_common.cuh").read_text()
    assert f"constexpr int SPLIT_KEYS = {dec.SPLIT_KEYS};" in src
    assert f"constexpr int THREADS = {dec.THREADS};" in src
    assert "return ((hd + 3) & ~3) + 4;" in src
    assert [dec.row_stride(h) for h in (16, 64, 128, 6)] == [20, 68, 132, 12]
    # kps int64 offsets, q [G][hd] and scores [G][kps] in f64, then f32
    # K and V [kps][ld], corr [tiles][G] and the tiles' flags (int32)
    assert dec.smem_bytes(8, 64, 16) == 8 * (32 + 8 * 64 + 8 * 32) + 4 * (
        2 * 32 * 68 + 2 * 8) + 4 * 2
    flat = " ".join(src.split())
    assert ("sizeof(double) * ((kps + (kps & 1)) + (size_t)G * hd + gk + "
            "(gk & 1)) + sizeof(float) * (2 * (size_t)kps * ld + tps * G) + "
            "sizeof(int) * tps") in flat


# ----------------------------------------------------------------------
# (a) coverage
# ----------------------------------------------------------------------

def _assert_covers(live, tile):
    """Every live key lies in exactly one listed tile of one split; listed
    tiles hold a live key and lie inside their split; split indices are
    the kernels' blockIdx.z."""
    live = np.asarray(live, bool)
    B, n = live.shape
    geo = dec.split_geometry(n, tile)
    plans = dec.split_plan(live, tile)
    for b in range(B):
        seen = np.zeros(n, int)
        last = -1
        for sp in plans[b]:
            assert last < sp.index < geo.n_splits
            last = sp.index
            lo, hi = sp.keys
            assert lo == sp.index * geo.keys_per_split
            assert hi == min(n, lo + geo.keys_per_split)
            assert list(sp.tiles) == sorted(set(sp.tiles))
            for u in sp.tiles:
                keys = np.arange(u * tile, min(n, (u + 1) * tile))
                assert lo <= keys[0] and keys[-1] < hi
                assert live[b, keys].any()
                seen[keys] += 1
        assert np.all(seen[live[b]] == 1)
        # a split not listed holds no live key
        listed = {sp.index for sp in plans[b]}
        for s in set(range(geo.n_splits)) - listed:
            kps = geo.keys_per_split
            assert not live[b, s * kps:(s + 1) * kps].any()


PAGED = {
    # cur per slot (-1 inactive), block-table holes (slot, page)
    "ragged": ([599, 433, 17, 300, -1, 511, 64, 250], []),
    "holes": ([599, 433, 17, 300, -1, 511, 64, 250],
              [(0, 3), (5, 20), (5, 21), (3, 0)]),
    "boundaries": ([63, 64, 127, 128, 0, -1, 255, 256], [(1, 4)]),
}


@pytest.mark.parametrize("ps", [8, 16, 128])
@pytest.mark.parametrize("window", [0, 100, 7])
@pytest.mark.parametrize("case", sorted(PAGED))
def test_split_plan_covers_paged(case, window, ps):
    curs, holes = PAGED[case]
    NB = -(-640 // ps)
    bt = np.arange(len(curs) * NB, dtype=np.int32).reshape(len(curs), NB)
    for s, c in enumerate(curs):
        bt[s, (max(c, 0) // ps + 1):] = -1     # allocated up to cur
    for s, t in holes:
        bt[s, t * 16 // ps] = -1
    _assert_covers(dec.paged_live(bt, np.array(curs), ps, window), ps)


@pytest.mark.parametrize("bk", [16, 50, 128, 296])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("ring", [False, True])
def test_split_plan_covers_contiguous(ring, window, bk):
    """Tk 296 (not a multiple of a split or of bk 128), linear or ring
    kpos with a run of empty (-1) slots."""
    Tk, B = 296, 3
    kpos = np.broadcast_to(np.arange(Tk, dtype=np.int32), (B, Tk)).copy()
    if ring:
        kpos = (np.roll(kpos, 57, axis=1) + 40).astype(np.int32)
        kpos[:, 100:130] = -1
    for cur in (0, 63, 64, 286, 335):
        _assert_covers(dec.contig_live(kpos, cur, window), bk)


def test_split_geometry():
    assert dec.SPLIT_KEYS == 32
    assert dec.split_geometry(600, 16) == (16, 2, 32, 19)
    assert dec.split_geometry(296, 128) == (128, 1, 128, 3)
    assert dec.split_geometry(296, 16) == (16, 2, 32, 10)
    assert dec.split_geometry(5, 16) == (16, 2, 32, 1)
    assert dec.split_geometry(64, 48) == (48, 1, 48, 2)
    assert dec.split_geometry(100, 8) == (8, 4, 32, 4)
    with pytest.raises(ValueError):
        dec.split_geometry(0, 16)


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("cur", [286, 255, 63, 5])
def test_contiguous_at_page_size_cuts_as_paged(cur, window):
    """K5 at bk = ps and K2 over the same positions (a full block table,
    kpos = arange) list the same splits and tiles."""
    B, ps, Tk = 4, 16, 296
    NB = -(-Tk // ps)
    kpos = np.broadcast_to(np.arange(Tk, dtype=np.int32), (B, Tk)).copy()
    bt = np.random.default_rng(0).permutation(B * NB).reshape(B, NB) \
        .astype(np.int32)
    c5 = dec.contig_live(kpos, cur, window)
    c2 = dec.paged_live(bt, np.full(B, cur), ps, window)[:, :Tk]
    assert np.array_equal(c5, c2)
    assert dec.split_geometry(Tk, ps)[:3] == dec.split_geometry(NB * ps,
                                                                ps)[:3]
    assert dec.split_plan(c5, ps) == [
        [sp._replace(keys=(sp.keys[0], min(sp.keys[1], Tk))) for sp in p]
        for p in dec.split_plan(dec.paged_live(bt, np.full(B, cur), ps,
                                               window), ps)]


def test_check_k2_shape_fills_the_card():
    """check_k2's slots (slot 5's table unallocated from page 20) give
    about two blocks with live keys per SM of an H100 (132)."""
    curs = PAGED["ragged"][0]
    NB, ps = 40, 16
    bt = np.zeros((len(curs), NB), np.int32)
    bt[5, 20:] = -1
    plans = dec.split_plan(dec.paged_live(bt, np.array(curs), ps), ps)
    assert 4 * sum(len(p) for p in plans) == 260


# ----------------------------------------------------------------------
# (b) the kernels' arithmetic, emulated
# ----------------------------------------------------------------------

def _warp_sum(p):
    """f64 sum of p [..., T] as a warp takes it: lane j % 32 adds its keys
    in order, then a butterfly over 16, 8, 4, 2, 1."""
    T = p.shape[-1]
    lanes = torch.zeros(p.shape[:-1] + (32,), dtype=torch.float64)
    for j0 in range(0, T, 32):
        chunk = p[..., j0:j0 + 32].double()
        lanes[..., :chunk.shape[-1]] += chunk
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ o]
    return lanes[..., 0]


def emulate(q, k, v, live, tile):
    """The split-key body's order and rounding points in torch. q [B, KV,
    G, hd] f32; k, v decoded [B, n, KV, hd] f32; live [B, n] bool (the
    kernels' mask). Returns f32 [B, KV, G, hd]."""
    B, KV, G, hd = q.shape
    n = k.shape[1]
    sm = torch.tensor(hd ** -0.5, dtype=torch.float32)
    ninf = float("-inf")
    out = torch.zeros((B, KV, G, hd))
    for b, plan in enumerate(dec.split_plan(live.numpy(), tile)):
        parts = []
        for sp in plan:
            m = torch.full((KV, G), ninf)
            l = torch.zeros((KV, G))
            acc = torch.zeros((KV, G, hd))
            for u in sp.tiles:
                keys = torch.arange(u * tile, (u + 1) * tile)
                kk = keys.clamp(max=n - 1)
                ok = (keys < n) & live[b, kk]
                kt = torch.where(ok[:, None, None], k[b, kk], 0.0)
                vt = torch.where(ok[:, None, None], v[b, kk], 0.0)
                dot = torch.zeros((KV, G, tile), dtype=torch.float64)
                for d in range(hd):                # f64 sums in d order
                    dot += q[b, :, :, d, None].double() \
                        * kt[:, :, d].T[:, None, :].double()
                s = torch.where(ok, dot.float() * sm, ninf)
                m_new = torch.maximum(m, s.amax(-1))
                m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
                p = torch.where(ok, torch.exp(s - m_safe[..., None]), 0.0)
                corr = torch.where(torch.isneginf(m), 0.0,
                                   torch.exp(m - m_safe))
                l = l * corr + _warp_sum(p).float()
                m = m_new
                pv = torch.zeros((KV, G, hd), dtype=torch.float64)
                for j in range(tile):              # p.v, in key order
                    pv += p[..., j, None].double() * vt[j][:, None].double()
                acc = acc * corr[..., None] + pv.float()
            parts.append((m, l, acc))
        if not parts:
            continue                               # no live key: zeros
        # the last block: a warp per row; l by lane (split index % 32 of
        # the grid's splits, in order) and a butterfly, acc in split order
        mx = torch.stack([p_[0] for p_ in parts]).amax(0)
        lanes = torch.zeros((KV, G, 32), dtype=torch.float64)
        a = torch.zeros((KV, G, hd), dtype=torch.float64)
        for sp, (mz, lz, az) in zip(plan, parts):
            w = torch.where(torch.isneginf(mz), 0.0,
                            torch.exp(mz - mx)).double()
            lanes[..., sp.index % 32] += w * lz.double()
            a += w[..., None] * az.double()
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[..., torch.arange(32) ^ o]
        out[b] = a.float() / torch.clamp(lanes[..., 0].float(),
                                         min=1e-30)[..., None]
    return out


def _pool(rng, shape):
    return (rng.integers(-15, 16, shape).astype(np.int8),
            rng.integers(0, 128, shape).astype(np.int8))


def _k2_case(seed, curs, G=8, hd=64, ps=16, NB=40, KV=4, holes=()):
    """check_k2's layout from numpy's generator: permuted pages up to each
    slot's cur, optional holes."""
    rng = np.random.default_rng(seed)
    S = len(curs)
    P = sum(c // ps + 1 for c in curs if c >= 0) + 8
    kd, km = _pool(rng, (P + 1, ps, KV, hd))
    vd, vm = _pool(rng, (P + 1, ps, KV, hd))
    perm = rng.permutation(P).astype(np.int32)
    bt = np.full((S, NB), -1, np.int32)
    at = 0
    for s, c in enumerate(curs):
        if c >= 0:
            n = c // ps + 1
            bt[s, :n] = perm[at:at + n]
            at += n
    for s, t in holes:
        bt[s, t] = -1
    q = rng.standard_normal((S, KV, G, hd)).astype(np.float32)
    ks = (rng.random(S) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random(S) * 0.02 + 0.005).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (
        q, kd, km, ks, vd, vm, vs, bt, np.array(curs, np.int32)))


def _k5_case(seed, B=8, Tk=296, KV=4, G=8, hd=64, cur=286, ring=False):
    rng = np.random.default_rng(seed)
    kd, km = _pool(rng, (B, Tk, KV, hd))
    vd, vm = _pool(rng, (B, Tk, KV, hd))
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kpos = np.broadcast_to(np.arange(Tk, dtype=np.int32), (B, Tk)).copy()
    if ring:
        kpos = (np.roll(kpos, 57, axis=1) + 40).astype(np.int32)
        kpos[:, 100:130] = -1
    ks = np.array([rng.random() * 0.02 + 0.005], np.float32)
    vs = np.array([rng.random() * 0.02 + 0.005], np.float32)
    return tuple(torch.from_numpy(a) for a in (
        q, kd, km, ks, vd, vm, vs, kpos, np.array([cur], np.int32)))


@pytest.mark.parametrize("window", [0, CS.K2_WINDOW])
@pytest.mark.parametrize("shape", [(8, 64), (4, 16)])
def test_emulation_k2_at_check_k2_shapes(shape, window):
    """Against K2's plain version and the f64 evaluation, at check_k2's
    slots (a hole beyond slot 5's cur region, an inactive slot)."""
    G, hd = shape
    args = _k2_case(0, PAGED["ragged"][0], G=G, hd=hd,
                    holes=[(5, t) for t in range(20, 40)])
    k, v, live = CS.paged_keys(*args[1:], window=window)
    got = emulate(args[0], k, v, live, 16)
    want = dec.ref_sparq_paged_decode_attn(*args, window=window)
    exact = CS.decode_f64_reference(args[0], k, v, live)
    assert float((got - want).abs().max()) <= ATOL
    assert float((got.double() - exact).abs().max()) <= ATOL
    assert torch.all(got[4] == 0)                  # inactive slot


@pytest.mark.parametrize("window,ring", [(0, False), (CS.K2_WINDOW, True)])
def test_emulation_k5_at_check_k5_shapes(window, ring):
    """bk 128 over Tk 296 (a ragged last tile), linear or ring kpos."""
    args = _k5_case(1, ring=ring)
    k, v, live = CS.contig_keys(*args[1:], window=window)
    got = emulate(args[0], k, v, live, 128)
    want = dec.ref_sparq_decode_attn(*args, window=window, bk=128)
    exact = CS.decode_f64_reference(args[0], k, v, live)
    assert float((got - want).abs().max()) <= ATOL
    assert float((got.double() - exact).abs().max()) <= ATOL


def test_emulation_matches_jax_oracles():
    """test_torch_kernels' and test_torch_cache's small cases (hd 16, G 4,
    ps 8 / bk 16), both windows."""
    from test_torch_cache import _contig_case
    from test_torch_kernels import _decode_case
    args = _decode_case()
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    for window in (0, 12):
        want = np.asarray(jref.ref_sparq_paged_decode_attn(
            *map(jnp.asarray, args), window=window))
        k, v, live = CS.paged_keys(*targs[1:], window=window)
        got = emulate(targs[0], k, v, live, args[1].shape[1]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    q, kd, km, vd, vm, kpos = _contig_case(ring=True)
    B, _, H, hd = q.shape
    s, cur = np.float32(0.02), np.int32(30)
    for window in (0, 9):
        want = np.asarray(jops.sparq_decode_attention(
            jnp.asarray(q), jnp.asarray(kd), jnp.asarray(km), jnp.float32(s),
            jnp.asarray(vd), jnp.asarray(vm), jnp.float32(s),
            jnp.asarray(kpos), jnp.int32(cur), window=window,
            impl="reference", bk=16))
        st = torch.tensor([s])
        k, v, live = CS.contig_keys(*(torch.from_numpy(a) for a in (
            kd, km)), st, *(torch.from_numpy(a) for a in (vd, vm)), st,
            torch.from_numpy(kpos), torch.tensor([cur]), window=window)
        qg = torch.from_numpy(q).reshape(B, 2, H // 2, hd)
        got = emulate(qg, k, v, live, 16).reshape(q.shape).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [0, CS.K2_WINDOW])
@pytest.mark.parametrize("cur", [286, 255])
def test_emulation_k5_page_size_equals_k2_bitwise(cur, window):
    """K5 at bk = 16 and K2 over the same bytes scattered into a page pool
    through a permuted block table, at a cur that ends inside a split
    (286) and on a split boundary (255: 256 keys, eight whole splits)."""
    B, Tk, ps, KV, hd = 4, 296, 16, 4, 64
    args = _k5_case(2, B=B, cur=cur)
    q, kd, km, ks, vd, vm, vs, kpos, c = args
    NB = -(-Tk // ps)
    bt = torch.from_numpy(np.random.default_rng(3).permutation(
        B * NB).reshape(B, NB).astype(np.int32))

    def paged(plane):
        pad = torch.zeros((B, NB * ps - Tk, KV, hd), dtype=plane.dtype)
        pool = torch.empty((B * NB, ps, KV, hd), dtype=plane.dtype)
        pool[bt.reshape(-1).long()] = torch.cat([plane, pad], 1).reshape(
            B * NB, ps, KV, hd)
        return pool
    k5 = emulate(q, *CS.contig_keys(*args[1:], window=window), ps)
    k2 = emulate(q, *CS.paged_keys(
        paged(kd), paged(km), ks.expand(B), paged(vd), paged(vm),
        vs.expand(B), bt, c.expand(B), window=window), ps)
    assert torch.equal(k5, k2)
    want = dec.ref_sparq_decode_attn(*args, window=window, bk=ps)
    assert float((k5 - want).abs().max()) <= ATOL


# ----------------------------------------------------------------------
# (c) shapes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_ported_configs_fit_one_block(arch, reduced):
    """K2 at the CLI's default page size (16) and K5 at its default tile
    (ops.DEFAULT_BK, the largest a cache gives it) fit in shared memory."""
    cfg = (get_reduced_config if reduced else get_config)(arch)
    G = cfg.n_heads // cfg.n_kv_heads
    for tile in (16, DEFAULT_BK):
        dec.check_shape(G, cfg.head_dim, tile)
        assert dec.smem_bytes(G, cfg.head_dim, tile) <= SMEM_LIMIT


def test_check_shape_raises_above_the_limit():
    dec.check_shape(8, 128, 128)       # hd 128 at the scan path's tile
    dec.check_shape(48, 128, 16)       # granite-class heads at ps 16
    with pytest.raises(ValueError, match="shared memory"):
        dec.check_shape(48, 128, 128)
    with pytest.raises(ValueError, match="shared memory"):
        dec.check_shape(8, 64, 512)
