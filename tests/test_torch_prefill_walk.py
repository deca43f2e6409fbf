"""K3's tile walk and arithmetic plan, on the CPU.

`kernels/sparq_prefill_attn.py::walk` is the rule by which the CUDA kernel
skips key tiles; the kernel cannot run here, so this file holds what it
rests on:

(a) coverage: for every chunk the port's `PrefillScheduler` packs on
    seeded ragged traces (seg < C, partial query tiles, hist not a
    multiple of the page size, holes in the block table), and for hand-made
    edge cases, every (row, key) pair that the plain version's masks leave
    unmasked lies in a tile `walk` visits, with and without a window;
(b) arithmetic: an emulation of the kernel's tile order (key tiles of
    KEY_TILE keys visited as `walk` lists them; q.k, p.v and the sum of p
    in f64, rounded once to f32; scores, statistics and acc in f32) agrees
    with the plain version at `chip_smoke.py::check_k3`'s shapes and
    layouts, and with the JAX oracle at test_torch_kernels' small case;
(c) the fragment index math of the kernel's two m16n8k8 f64 products, with
    each key tile's scores split between the two warps of a row group and
    P V's columns split between them, emulated lane by lane.

Tolerance for (b): 1e-4 absolute, the gate `chip_smoke.py` holds the kernel
to. The decoded keys and values reach ~50 (codes up to 15 << 7 times scales
up to 0.025), so scores reach tens and outputs ~40, where one f32 ulp is
~4e-6. The plain version's f32 einsums sum up to 256 products in f32: on
the CPU its outputs lie up to 8.9e-5 from an f64 evaluation of the same
function, while the emulation (f64 sums, rounded once per tile) lies within
2.2e-5 of it; the two differ by at most 8.4e-5 at check_k3's shapes.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import sparq_prefill_attn as pre
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.ref import _meta_decode32
from repro_torch.launch.prefill import PrefillScheduler

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def test_key_tile_is_the_kernels():
    """walk's default tile is the tile the CUDA source compiles."""
    src = (CSRC / "sparq_chunked_prefill_attn.cu").read_text()
    assert f"constexpr int KT = {pre.KEY_TILE};" in src
    assert f"constexpr int HD = {pre.KERNEL_HD};" in src


# ----------------------------------------------------------------------
# (a) coverage
# ----------------------------------------------------------------------

def _unmasked(seq_id, pos, hist, tile_seq, bt, ps, window):
    """The plain version's masks: page_ok [C, NB * ps] over key positions
    of the tile's sequence, chunk_ok [C, C] over stream keys."""
    C = len(seq_id)
    bq = C // len(tile_seq)
    s_safe = np.maximum(np.repeat(tile_seq, bq), 0)
    kp = np.arange(bt.shape[1] * ps)
    valid = (seq_id >= 0)[:, None]
    page_ok = (bt[s_safe][:, kp // ps] >= 0) & valid \
        & (kp[None] < hist[:, None])
    chunk_ok = (seq_id[None] == seq_id[:, None]) & valid \
        & (pos[None] <= pos[:, None]) & (pos[None] >= hist[:, None])
    if window:
        page_ok &= kp[None] > pos[:, None] - window
        chunk_ok &= pos[None] > pos[:, None] - window
    return page_ok, chunk_ok


def _assert_covered(seq_id, pos, hist, tile_seq, bt, ps, window, key_tile):
    C = len(seq_id)
    bq = C // len(tile_seq)
    visits = pre.walk(tile_seq, seq_id, pos, hist, bt, ps, key_tile, window)
    page_ok, chunk_ok = _unmasked(seq_id, pos, hist, tile_seq, bt, ps,
                                  window)
    for i in range(C):
        if seq_id[i] < 0:
            continue
        qt = i // bq
        # the stream invariant walk relies on
        assert seq_id[i] == tile_seq[qt], (i, seq_id[i], tile_seq[qt])
        vis = visits[qt]
        for kp in np.nonzero(page_ok[i])[0]:
            assert kp // key_tile in vis.pages, ("page", i, kp, vis)
        for j in np.nonzero(chunk_ok[i])[0]:
            assert j // key_tile in vis.chunk, ("chunk", i, j, vis)
    return visits


def _scheduler_chunks(seed, C=64, bq=8, ps=4, seg=10, S=4, n_req=9):
    """Every chunk `PrefillScheduler` packs for a seeded ragged trace
    (requests join as slots free up), with the block table of the moment."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 3 * C, n_req)
    NB = -(-int(lengths.max()) // ps)
    sch = PrefillScheduler(None, chunk_size=C, align=bq, page_size=ps,
                           n_slots=S, seg=seg)
    host_bt = -np.ones((S, NB), np.int64)
    free = list(rng.permutation(S * NB))
    queue = list(enumerate(lengths.tolist()))
    free_slots = list(range(S))

    def grant(slot, blocks):
        for b in blocks:
            host_bt[slot, b] = free.pop()

    chunks = []
    while queue or sch.pending:
        while queue and free_slots:
            rid, n = queue.pop(0)
            sch.add(free_slots.pop(0), rid, rng.integers(1, 100, n))
        plan = sch.plan(lambda: len(free), grant, host_bt)
        assert plan is not None
        chunks.append((plan, host_bt.copy()))
        for slot, _ in plan.completed:
            free.extend(int(p) for p in host_bt[slot] if p >= 0)
            host_bt[slot] = -1
            free_slots.append(slot)
    return chunks


@pytest.mark.parametrize("key_tile", [16, pre.KEY_TILE])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_covers_scheduler_packings(seed, window, key_tile):
    """seg = 10 < C = 64 (hist moves inside a run and is not a multiple of
    ps = 4), ragged prompts end in partial query tiles, and one history page
    in five is punched out of the block table (-1)."""
    rng = np.random.default_rng(100 + seed)
    chunks = _scheduler_chunks(seed)
    assert len(chunks) > 5
    partial = moved = False
    for plan, bt in chunks:
        bt = bt.copy()
        bt[rng.random(bt.shape) < 0.2] = -1
        _assert_covered(plan.seq_id, plan.pos, plan.hist, plan.tile_seq, bt,
                        4, window, key_tile)
        runs = [plan.seq_id[i:i + 8] for i in range(0, 64, 8)]
        partial |= any((r >= 0).any() and (r < 0).any() for r in runs)
        for s in set(plan.seq_id[plan.seq_id >= 0].tolist()):
            moved |= len(set(plan.hist[plan.seq_id == s].tolist())) > 1
    assert partial and moved     # the trace did exercise both


def _edge_stream(case, C=32, bq=4):
    seq_id = np.full(C, -1, np.int32)
    pos = np.zeros(C, np.int32)
    hist = np.zeros(C, np.int32)
    tile_seq = np.full(C // bq, -1, np.int32)
    if case == "padding_only":
        pass
    elif case == "one_sequence":          # fills the chunk, hist mid-page
        seq_id[:] = 0
        pos[:] = np.arange(13, 13 + C)
        hist[:] = 13
        tile_seq[:] = 0
    elif case == "runs_of_one":           # single-token runs of 3 slots
        for k, (slot, p) in enumerate([(0, 40), (1, 0), (2, 7), (0, 41)]):
            seq_id[k * bq], pos[k * bq], hist[k * bq] = slot, p, p
            tile_seq[k] = slot
    return seq_id, pos, hist, tile_seq


EDGE = ["padding_only", "one_sequence", "runs_of_one"]


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("case", EDGE)
def test_walk_covers_edge_cases(case, window):
    seq_id, pos, hist, tile_seq = _edge_stream(case)
    bt = np.arange(3 * 12, dtype=np.int32).reshape(3, 12)
    bt[0, 2] = -1
    visits = _assert_covered(seq_id, pos, hist, tile_seq, bt, 4, window, 16)
    if case == "padding_only":
        assert all(v == pre.Visits((), ()) for v in visits)


def test_walk_skips_the_causal_half():
    """On check_k3's timed layout the chunk stage visits 48 of the 120
    (query tile, chunk tile) pairs of the 30 non-padding query tiles (slot
    0's tile k sees chunk tiles 0..(8 k + 7) // 64, slot 1's from tile 2
    on), and the page stage only slot 0's four history tiles."""
    runs = CS.K3_LAYOUTS["timed"][0]
    seq_id, pos, hist, tile_seq = CS.k3_stream(runs, 256, 8)
    bt = np.zeros((8, 34), np.int32)
    visits = pre.walk(tile_seq, seq_id, pos, hist, bt, 16)
    assert sum(len(v.chunk) for v in visits) == 48
    assert [v.pages for v in visits[:18]] == [(0, 1, 2, 3)] * 18
    assert all(v.pages == () for v in visits[18:])


# ----------------------------------------------------------------------
# (b) the kernel's arithmetic, emulated
# ----------------------------------------------------------------------

def _emulate_k3(args, window=0, key_tile=pre.KEY_TILE):
    """K3's tile order and rounding points in torch: per query tile, the
    page tiles then the chunk tiles that walk lists; per tile q.k in f64
    rounded to f32, times sm_scale in f32, masked; f32 online-softmax
    statistics; the tile's p.v and sum of p in f64, rounded once."""
    (q, kc, vc, kd, km, ks, vd, vm, vs, bt, sid, pos, hist, tile_seq) = args
    C, KV, G, hd = q.shape
    ps, NB = kd.shape[1], bt.shape[1]
    nt = len(tile_seq)
    bq = C // nt
    sm_scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    visits = pre.walk(tile_seq.numpy(), sid.numpy(), pos.numpy(),
                      hist.numpy(), bt.numpy(), ps, key_tile, window)
    out = torch.zeros((C, KV, G, hd), dtype=torch.float32)
    for qt, vis in enumerate(visits):
        ts = int(tile_seq[qt])
        if ts < 0:
            continue
        rows = slice(qt * bq, (qt + 1) * bq)
        q64 = q[rows].double()
        rok, rpos, rhist = sid[rows] >= 0, pos[rows], hist[rows]
        m = torch.full((bq, KV, G), float("-inf"))
        l = torch.zeros((bq, KV, G))
        acc = torch.zeros((bq, KV, G, hd))

        def update(k, v, ok):
            nonlocal m, l, acc
            s = torch.einsum("tkgh,jkh->tkgj", q64, k.double()).float()
            s = torch.where(ok[:, None, None, :], s * sm_scale,
                            float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.where(ok[:, None, None, :],
                            torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.double().sum(-1).float()
            m = m_new
            pv = torch.einsum("tkgj,jkh->tkgh", p.double(), v.double())
            acc = acc * corr[..., None] + pv.float()

        win = (lambda kpos: kpos[None] > rpos[:, None] - window) if window \
            else (lambda kpos: True)
        lo = max(0, int(rpos[rok].min()) - window + 1) if window else 0
        hi = int(rhist[rok].max())
        for u in vis.pages:
            kp = u * key_tile + torch.arange(key_tile)
            t = kp // ps
            page = torch.where(t < NB, bt[ts, t.clamp(max=NB - 1)], -1)
            live = (page >= 0) & (t * ps < hi) & ((t + 1) * ps > lo)
            pg, row = page.clamp(min=0).long(), kp % ps
            k = torch.where(live[:, None, None],
                            _meta_decode32(kd[pg, row], km[pg, row], ks[ts]),
                            0.0)
            v = torch.where(live[:, None, None],
                            _meta_decode32(vd[pg, row], vm[pg, row], vs[ts]),
                            0.0)
            ok = rok[:, None] & live[None] & (kp[None] < rhist[:, None]) \
                & win(kp)
            update(k, v, ok)
        for u in vis.chunk:
            j = u * key_tile + torch.arange(key_tile)
            inside = j < C
            jc = j.clamp(max=C - 1)
            k = torch.where(inside[:, None, None], kc[jc], 0.0)
            v = torch.where(inside[:, None, None], vc[jc], 0.0)
            kpos = pos[jc]
            ok = rok[:, None] & (inside & (sid[jc] == ts))[None] \
                & (kpos[None] <= rpos[:, None]) \
                & (kpos[None] >= rhist[:, None]) & win(kpos)
            update(k, v, ok)
        out[rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out


def _case(layout, seed=0):
    """chip_smoke.py's K3 inputs for a layout, from numpy's generator."""
    rng = np.random.default_rng(seed)
    S, KV, G, hd, ps, C, bq, NB, P = 8, 4, 8, 64, 16, 256, 8, 34, 40
    pools = [rng.integers(lo_, hi_, (P + 1, ps, KV, hd)).astype(np.int8)
             for lo_, hi_ in ((-15, 16), (0, 128)) * 2]
    runs, pages, holes = CS.K3_LAYOUTS[layout]
    bt = -np.ones((S, NB), np.int32)
    for slot, n in pages.items():
        bt[slot, :n] = rng.permutation(P)[:n]
    for slot, t in holes:
        bt[slot, t] = -1
    seq_id, pos, hist, tile_seq = CS.k3_stream(runs, C, bq)
    q = rng.standard_normal((C, KV, G, hd)).astype(np.float32)
    kc = rng.standard_normal((C, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((C, KV, hd)).astype(np.float32)
    ks = (rng.random(S) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random(S) * 0.02 + 0.005).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        q, kc, vc, pools[0], pools[1], ks, pools[2], pools[3], vs, bt,
        seq_id, pos, hist, tile_seq))


@pytest.mark.parametrize("window", [0, CS.K3_WINDOW])
@pytest.mark.parametrize("layout", sorted(CS.K3_LAYOUTS))
def test_emulation_matches_plain_at_check_k3_shapes(layout, window):
    """Against the plain version and against chip_smoke's f64 evaluation
    (`k3_f64_reference`), which the card's check holds the kernel to as
    well."""
    args = _case(layout)
    want = pre.ref_sparq_chunked_prefill_attn(*args, window=window)
    got = _emulate_k3(args, window)
    exact = CS.k3_f64_reference(*args, window=window)
    assert float((got - want).abs().max()) <= ATOL
    assert float((got.double() - exact).abs().max()) <= ATOL
    assert torch.all(got[args[10] < 0] == 0)


def test_emulation_matches_jax_oracle():
    """test_torch_kernels' small stream (hd 8, ps 4, bq 4), both windows."""
    from test_torch_kernels import _prefill_case
    args = _prefill_case()
    for window in (0, 5):
        want = np.asarray(jref.ref_sparq_chunked_prefill_attn(
            *map(jnp.asarray, args), window=window))
        got = _emulate_k3(tuple(torch.from_numpy(np.asarray(a))
                                for a in args), window).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", EDGE)
def test_emulation_matches_plain_on_edge_cases(case):
    rng = np.random.default_rng(5)
    seq_id, pos, hist, tile_seq = _edge_stream(case)
    C, KV, G, hd, ps, S, NB, P = 32, 2, 2, 8, 4, 3, 12, 36
    bt = rng.permutation(P)[:S * NB].reshape(S, NB).astype(np.int32)
    bt[0, 2] = -1
    kd, km, vd, vm = (rng.integers(lo_, hi_, (P, ps, KV, hd)).astype(np.int8)
                      for lo_, hi_ in ((-15, 16), (0, 128)) * 2)
    args = tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((C, KV, G, hd)).astype(np.float32),
        rng.standard_normal((C, KV, hd)).astype(np.float32),
        rng.standard_normal((C, KV, hd)).astype(np.float32), kd, km,
        np.full(S, 0.01, np.float32), vd, vm, np.full(S, 0.02, np.float32),
        bt, seq_id, pos, hist, tile_seq))
    for window in (0, 5):
        want = pre.ref_sparq_chunked_prefill_attn(*args, window=window)
        got = _emulate_k3(args, window, key_tile=16)
        assert float((got - want).abs().max()) <= ATOL
        assert torch.all(got[args[10] < 0] == 0)


# ----------------------------------------------------------------------
# (c) fragment index math of the two m16n8k8 f64 products, lane by lane
# ----------------------------------------------------------------------

def _dmma(d, a, b):
    """mma.sync.m16n8k8 f64 on lane fragments (g = L / 4, t = L % 4): lane L
    holds a[L] = (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]), b[L] =
    (B[t][g], B[t+4][g]) and d[L] = (D[g][2t], D[g][2t+1], D[g+8][2t],
    D[g+8][2t+1])."""
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for L in range(32):
        g, t = L // 4, L % 4
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[L]
        B[t, g], B[t + 4, g] = b[L]
    D = A @ B
    for L in range(32):
        g, t = L // 4, L % 4
        d[L] += (D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                 D[g + 8, 2 * t + 1])


def test_fragment_index_math():
    """One row group's 16 rows against one key tile, indexed as the
    kernel's two warps (half h = 0, 1) index their shared tiles: S = Q K^T
    over keys 32 h .. 32 h + 31 from A = Q[g (+8)][8 kk + t (+4)] and B =
    K[32 h + 8 nt + g][8 kk + t (+4)], each lane's scores written to the P
    tile at keys 32 h + 8 nt + 2t + {0, 1}; then P V for columns 32 h ..
    32 h + 31 over all keys from A = P[g (+8)][8 nt + t (+4)] and B = V[8 nt
    + t (+4)][32 h + 8 dt + g]. Small integers keep every sum exact."""
    rng = np.random.default_rng(0)
    KT, HD = pre.KEY_TILE, pre.KERNEL_HD
    Q = rng.integers(-4, 5, (16, HD)).astype(np.float64)
    K = rng.integers(-4, 5, (KT, HD)).astype(np.float64)
    V = rng.integers(-4, 5, (KT, HD)).astype(np.float64)
    L = np.arange(32)
    g, t = L // 4, L % 4
    P = np.zeros((16, KT))                  # the group's P tile
    for h in range(2):
        s = np.zeros((KT // 16, 32, 4))
        for kk in range(HD // 8):
            a = np.stack([Q[g, 8 * kk + t], Q[g + 8, 8 * kk + t],
                          Q[g, 8 * kk + t + 4], Q[g + 8, 8 * kk + t + 4]], 1)
            for nt in range(KT // 16):
                key = KT // 2 * h + 8 * nt + g
                _dmma(s[nt], a, np.stack([K[key, 8 * kk + t],
                                          K[key, 8 * kk + t + 4]], 1))
        for nt in range(KT // 16):
            for i in range(4):
                P[g + 8 * (i // 2), KT // 2 * h + 8 * nt + 2 * t + i % 2] = \
                    s[nt, :, i]
    np.testing.assert_array_equal(P, Q @ K.T)    # any P: P V is linear
    O = np.zeros((16, HD))
    for h in range(2):
        o = np.zeros((HD // 16, 32, 4))
        for nt in range(KT // 8):
            a = np.stack([P[g, 8 * nt + t], P[g + 8, 8 * nt + t],
                          P[g, 8 * nt + t + 4], P[g + 8, 8 * nt + t + 4]], 1)
            for dt in range(HD // 16):
                col = HD // 2 * h + 8 * dt + g
                _dmma(o[dt], a, np.stack([V[8 * nt + t, col],
                                          V[8 * nt + t + 4, col]], 1))
        for dt in range(HD // 16):
            for i in range(4):
                O[g + 8 * (i // 2), HD // 2 * h + 8 * dt + 2 * t + i % 2] = \
                    o[dt, :, i]
    np.testing.assert_array_equal(O, P @ V)
