"""K3's tile walk and arithmetic plan, on the CPU.

`kernels/sparq_prefill_attn.py::walk` is the rule by which the CUDA kernel
skips key tiles; the kernel cannot run here, so this file holds what it
rests on:

(a) coverage: for every chunk the port's `PrefillScheduler` packs on
    seeded ragged traces (seg < C, partial query tiles, hist not a
    multiple of the page size, holes in the block table), and for hand-made
    edge cases, every (row, key) pair that the plain version's masks leave
    unmasked lies in a tile `walk` visits, with and without a window, for
    pages smaller than the key tile, equal to it, larger than it (a tile a
    slice of one page) and of a size that neither divides nor is a
    multiple of it;
(b) arithmetic: an emulation of the kernel's tile order (key tiles of the
    instantiation's key tile visited as `walk` lists them; q.k, p.v and
    the sum of p in f64, rounded once to f32; scores, statistics and acc
    in f32) agrees with the plain version and `chip_smoke.k3_f64_reference`
    at every `chip_smoke.py::check_k3` shape and layout (the cli and wide
    paths' own among them), and with the JAX oracle at test_torch_kernels'
    small case; the row-block cut is exact;
(c) the fragment index math of the kernel's two m16n8k8 f64 products at
    every instantiation's head dim and key tile (and a head dim padded up),
    with each key tile's scores split between the two warps of a row group
    and P V's columns split between them, in column passes, emulated lane
    by lane.

Tolerance for (b): 1e-4 absolute against the f64 evaluation, the gate
`chip_smoke.py` holds the kernel to, and against the plain version at the
serving shape (hd 64 G 8); beyond it `chip_smoke.PLAIN_TOL` (1e-3), since
the plain version's own f32 sums lie up to ~4e-4 from f64 there (hd 128 at
G 48, hd 256). The decoded keys and values reach ~50 (codes up to 15 << 7
times scales up to 0.025), so scores reach tens and outputs ~40, where one
f32 ulp is ~4e-6; the emulation (f64 sums, rounded once per tile) lies
within ~2e-6 of f64.
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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test workers on one
    machine, and OpenMP threads spinning between this file's many small
    ops would take the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def test_key_tile_is_the_kernels():
    """walk's key tile at each head dim is the tile the CUDA source
    compiles for it."""
    src = (CSRC / "sparq_chunked_prefill_attn.cu").read_text()
    for hd, kt in pre.KEY_TILES.items():
        assert (f"template <> struct KeyTile<{hd}> {{ static constexpr int "
                f"value = {kt}; }};") in src
        assert pre.k3_traits(hd, 8, 8, 16).key_tile == kt


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


def _covers_traces(seed, window, key_tile, ps, C):
    rng = np.random.default_rng(100 + seed)
    chunks = _scheduler_chunks(seed, C=C, ps=ps)
    assert len(chunks) > 5
    partial = moved = False
    for plan, bt in chunks:
        bt = bt.copy()
        bt[rng.random(bt.shape) < 0.2] = -1
        _assert_covered(plan.seq_id, plan.pos, plan.hist, plan.tile_seq, bt,
                        ps, window, key_tile)
        runs = [plan.seq_id[i:i + 8] for i in range(0, C, 8)]
        partial |= any((r >= 0).any() and (r < 0).any() for r in runs)
        for s in set(plan.seq_id[plan.seq_id >= 0].tolist()):
            moved |= len(set(plan.hist[plan.seq_id == s].tolist())) > 1
    assert partial and moved     # the trace did exercise both


@pytest.mark.parametrize("key_tile", [16, 64])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_covers_scheduler_packings(seed, window, key_tile):
    """seg = 10 < C = 64 (hist moves inside a run and is not a multiple of
    ps = 4), ragged prompts end in partial query tiles, and one history page
    in five is punched out of the block table (-1)."""
    _covers_traces(seed, window, key_tile, 4, 64)


@pytest.mark.parametrize("key_tile", [16, 32, 64])
@pytest.mark.parametrize("ps", [128, 48])
@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_covers_scheduler_packings_past_the_key_tile(seed, window, ps,
                                                          key_tile):
    """The same traces at C = 128 with pages of 128 (a key tile a slice of
    one page: --page-size 128) and of 48 (neither a divisor nor a multiple
    of any key tile: tiles straddle pages)."""
    _covers_traces(seed, window, key_tile, ps, 128)


def test_walk_skips_page_slices_outside_the_history():
    """ps 128 > key tile 32: a live page's tiles outside [lo, hi) are not
    visited. One sequence at positions 300..307 with hist 300 (pages 0-2 of
    history) and a window of 200 (lo = 101): tiles 3 .. 9 hold keys in
    [101, 300); tiles 0-2 and 10, 11 do not; a hole at page 1 removes
    tiles 4-7."""
    seq_id = np.zeros(8, np.int32)
    pos = np.arange(300, 308, dtype=np.int32)
    hist = np.full(8, 300, np.int32)
    bt = np.array([[5, 6, 7, -1]], np.int32)
    v = pre.walk(np.zeros(1, np.int32), seq_id, pos, hist, bt, 128, 32, 200)
    assert v[0].pages == tuple(range(3, 10))
    bt[0, 1] = -1
    v = pre.walk(np.zeros(1, np.int32), seq_id, pos, hist, bt, 128, 32, 200)
    assert v[0].pages == (3, 8, 9)


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
    visits = pre.walk(tile_seq, seq_id, pos, hist, bt, 16, 64)
    assert sum(len(v.chunk) for v in visits) == 48
    assert [v.pages for v in visits[:18]] == [(0, 1, 2, 3)] * 18
    assert all(v.pages == () for v in visits[18:])


# ----------------------------------------------------------------------
# (b) the kernel's arithmetic, emulated
# ----------------------------------------------------------------------

def _emulate_k3(args, window=0, key_tile=64):
    """K3's tile order and rounding points in torch: per query tile, the
    page tiles then the chunk tiles that walk lists; per tile q.k in f64
    rounded to f32, times sm_scale in f32, masked; f32 online-softmax
    statistics from m = -inf, l = 0, acc = 0; the tile's p.v and sum of p
    in f64, rounded once; out = acc / max(l, 1e-30)."""
    (q, kc, vc, kd, km, ks, vd, vm, vs, bt, sid, pos, hist, tile_seq) = args
    C, KV, G, hd = q.shape
    ps, NB = kd.shape[1], bt.shape[1]
    nt = len(tile_seq)
    bq = C // nt
    sm_scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    visits = pre.walk(tile_seq.numpy(), sid.numpy(), pos.numpy(),
                      hist.numpy(), bt.numpy(), ps, key_tile, window)
    out = torch.zeros((C, KV, G, hd), dtype=torch.float32)
    ninf = float("-inf")
    for qt, vis in enumerate(visits):
        ts = int(tile_seq[qt])
        if ts < 0:
            continue
        rows = slice(qt * bq, (qt + 1) * bq)
        q64 = q[rows].double()
        rok, rpos, rhist = sid[rows] >= 0, pos[rows], hist[rows]
        win = (lambda kpos: kpos[None] > rpos[:, None] - window) if window \
            else (lambda kpos: True)

        def tile(kind, u, lo, hi):
            """K, V and the mask of one visited key tile."""
            if kind == "page":
                kp = u * key_tile + torch.arange(key_tile)
                t = kp // ps
                page = torch.where(t < NB, bt[ts, t.clamp(max=NB - 1)], -1)
                live = (page >= 0) & (t * ps < hi) & ((t + 1) * ps > lo)
                pg, row = page.clamp(min=0).long(), kp % ps
                k = torch.where(live[:, None, None], _meta_decode32(
                    kd[pg, row], km[pg, row], ks[ts]), 0.0)
                v = torch.where(live[:, None, None], _meta_decode32(
                    vd[pg, row], vm[pg, row], vs[ts]), 0.0)
                ok = rok[:, None] & live[None] & (kp[None] < rhist[:, None]) \
                    & win(kp)
                return k, v, ok
            j = u * key_tile + torch.arange(key_tile)
            inside = j < C
            jc = j.clamp(max=C - 1)
            k = torch.where(inside[:, None, None], kc[jc], 0.0)
            v = torch.where(inside[:, None, None], vc[jc], 0.0)
            kpos = pos[jc]
            ok = rok[:, None] & (inside & (sid[jc] == ts))[None] \
                & (kpos[None] <= rpos[:, None]) \
                & (kpos[None] >= rhist[:, None]) & win(kpos)
            return k, v, ok

        lo = max(0, int(rpos[rok].min()) - window + 1) if window else 0
        hi = int(rhist[rok].max())
        order = [("page", u) for u in vis.pages] + \
            [("chunk", u) for u in vis.chunk]
        m = torch.full((bq, KV, G), ninf)
        l = torch.zeros((bq, KV, G))
        acc = torch.zeros((bq, KV, G, hd))
        for kind, u in order:
            k, v, ok = tile(kind, u, lo, hi)
            s = torch.einsum("tkgh,jkh->tkgj", q64, k.double()).float()
            s = torch.where(ok[:, None, None, :], s * sm_scale, ninf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.where(ok[:, None, None, :],
                            torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isneginf(m), 0.0,
                               torch.exp(m - m_safe))
            l = l * corr + p.double().sum(-1).float()
            m = m_new
            pv = torch.einsum("tkgj,jkh->tkgh", p.double(), v.double())
            acc = acc * corr[..., None] + pv.float()
        out[rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out


def _case(layout, seed=0, KV=4, G=8, hd=64, ps=16, bq=8, C=256, S=8):
    """chip_smoke.py's K3 inputs for a layout (`k3_case`'s shapes: page
    counts and holes in pages of 16 positions, another page size covering
    the same positions), from numpy's generator."""
    rng = np.random.default_rng(seed)
    NB, P = -(-34 * 16 // ps), -(-40 * 16 // ps)
    pools = [rng.integers(lo_, hi_, (P + 1, ps, KV, hd)).astype(np.int8)
             for lo_, hi_ in ((-15, 16), (0, 128)) * 2]
    runs, pages, holes = CS.K3_LAYOUTS[layout]
    bt = -np.ones((S, NB), np.int32)
    for slot, n in pages.items():
        n = -(-n * 16 // ps)
        bt[slot, :n] = rng.permutation(P)[:n]
    for slot, t in holes:
        bt[slot, t * 16 // ps] = -1
    seq_id, pos, hist, tile_seq = CS.k3_stream(runs, C, bq)
    q = rng.standard_normal((C, KV, G, hd)).astype(np.float32)
    kc = rng.standard_normal((C, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((C, KV, hd)).astype(np.float32)
    ks = (rng.random(S) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random(S) * 0.02 + 0.005).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        q, kc, vc, pools[0], pools[1], ks, pools[2], pools[3], vs, bt,
        seq_id, pos, hist, tile_seq))


def _key_tile(args):
    """The key tile the wrapper would use for args."""
    q, kd, ts = args[0], args[3], args[13]
    C, KV, G, hd = q.shape
    return pre.k3_traits(hd, G, C // len(ts), kd.shape[1]).key_tile


# check_k3's shapes: (KV, G, hd, ps, bq, C) (the misaligned case computes
# the same function as the serving shape), each with the layouts its chunk
# holds
SHAPES = {name: cfg[:5] + cfg[6:] for name, (cfg, _) in CS.K3_SHAPES.items()
          if not cfg[5]}
CASES = [(shape, layout) for shape in sorted(SHAPES)
         for layout in CS.k3_layouts(SHAPES[shape][5], SHAPES[shape][4])]


@pytest.mark.parametrize("window", [0, CS.K3_WINDOW])
@pytest.mark.parametrize("shape,layout", CASES)
def test_emulation_matches_plain_at_check_k3_shapes(shape, layout, window):
    """At the key tile the wrapper picks: against the plain version and
    against chip_smoke's f64 evaluation (`k3_f64_reference`), which the
    card's check holds the kernel to as well."""
    KV, G, hd, ps, bq, C = SHAPES[shape]
    args = _case(layout, KV=KV, G=G, hd=hd, ps=ps, bq=bq, C=C)
    want = pre.ref_sparq_chunked_prefill_attn(*args, window=window)
    got = _emulate_k3(args, window, _key_tile(args))
    exact = CS.k3_f64_reference(*args, window=window)
    tol = ATOL if shape == "hd 64 G 8" else CS.PLAIN_TOL
    assert float((got - want).abs().max()) <= tol
    assert float((got.double() - exact).abs().max()) <= ATOL
    assert torch.all(got[args[10] < 0] == 0)


@pytest.mark.parametrize("argv", ["CLI_ARGS", "WIDE_ARGS"])
def test_driven_k3_shapes_are_checked(argv):
    """The K3 shape each CLI path of chip_smoke.py drives is a K3_SHAPES
    case of its own name, so check_k3 holds the kernel to f64 and the
    plain version at exactly that shape on the card; the reduced
    tinyllama at the CLI defaults, and full width at --chunk-align 16
    --page-size 128 (two row blocks, key tiles slicing a page)."""
    name = {"CLI_ARGS": "cli", "WIDE_ARGS": "wide"}[argv]
    shape = CS.cli_k3_shape(getattr(CS, argv))
    cfg, want = CS.K3_SHAPES[name]
    assert cfg == shape
    KV, G, hd, ps, bq, _, C = shape
    t = pre.k3_traits(hd, G, bq, ps)
    assert (t.hd, t.key_tile, t.rows, t.row_blocks) == want
    assert CS.k3_layouts(C, bq) == ["long history"]


def test_serving_k3_shape_is_checked():
    """The serve phase's K3 shape (full tinyllama, page 16, chunk 256 at
    chunk-align 8) is check_k3's serving shape."""
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama-1.1b")
    G = cfg.n_heads // cfg.n_kv_heads
    assert CS.K3_SHAPES["hd 64 G 8"][0] == (cfg.n_kv_heads, G, cfg.head_dim,
                                            16, 8, False, 256)


def _row_block_rows(C, bq, G, rows, rb):
    """Mask [C, G] of the (token, head) rows that row block rb of every
    query tile holds: tile rows [rb rows, (rb + 1) rows) of bq * G."""
    r = (np.arange(C) % bq)[:, None] * G + np.arange(G)[None]
    return torch.from_numpy((r >= rb * rows) & (r < (rb + 1) * rows))


@pytest.mark.parametrize("shape", ["bq*G 128", "hd 128 G 48 KV 1", "wide"])
def test_row_blocks_are_exact(shape):
    """The plain version run once per row block, every other row's query
    poisoned with NaN, gives that block's rows bit for bit, and the blocks
    together give the whole output: a row depends on its own query and
    statistics only, so cutting a query tile's rows into blocks is exact
    (granite's 384 rows a tile in blocks of 64: not a multiple of G; the
    wide path's 32-token chunk over a long history in pages of 128). On
    the serve-like layout where the chunk holds it."""
    KV, G, hd, ps, bq, C = SHAPES[shape]
    layout = ("serve-like" if "serve-like" in CS.k3_layouts(C, bq)
              else "long history")
    args = _case(layout, seed=4, KV=KV, G=G, hd=hd, ps=ps, bq=bq, C=C)
    C = args[0].shape[0]
    t = pre.k3_traits(hd, G, bq, ps)
    assert t.row_blocks > 1
    whole = pre.ref_sparq_chunked_prefill_attn(*args)
    joined = torch.full_like(whole, float("nan"))
    for rb in range(t.row_blocks):
        mine = _row_block_rows(C, bq, G, t.rows, rb)[:, None, :, None]
        q = torch.where(mine, args[0], float("nan"))
        got = pre.ref_sparq_chunked_prefill_attn(q, *args[1:])
        mine = mine.expand_as(got)
        assert torch.equal(got[mine], whole[mine])
        joined[mine] = got[mine]
    assert torch.equal(joined, whole)


def test_emulation_matches_jax_oracle():
    """test_torch_kernels' small stream (hd 8, ps 4, bq 4), both windows,
    at the wrapper's key tile."""
    from test_torch_kernels import _prefill_case
    args = _prefill_case()
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    for window in (0, 5):
        want = np.asarray(jref.ref_sparq_chunked_prefill_attn(
            *map(jnp.asarray, args), window=window))
        got = _emulate_k3(targs, window, _key_tile(targs)).numpy()
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


@pytest.mark.parametrize("HD,hd", [(16, 16), (16, 10), (32, 32), (64, 64),
                                   (128, 128), (128, 96), (256, 256)])
def test_fragment_index_math(HD, hd):
    """One row group's 16 rows against one key tile of the instantiation
    for head dim HD (KT = KEY_TILES[HD]), indexed as the kernel's two warps
    (half h = 0, 1) index their shared tiles: S = Q K^T over keys h KT / 2
    .. (h + 1) KT / 2 - 1 from A = Q[g (+8)][8 kk + t (+4)] and B =
    K[h KT / 2 + 8 nt + g][8 kk + t (+4)], each lane's scores written to
    the P tile at keys h KT / 2 + 8 nt + 2t + {0, 1}; then P V for columns
    h HD / 2 .. (h + 1) HD / 2 - 1 over all keys, in passes of DCH column
    tiles (acc updated after each pass), from A = P[g (+8)][8 nt + t (+4)]
    and B = V[8 nt + t (+4)][h HD / 2 + 8 (dc + dt) + g]. A head dim below
    HD has Q's and K's columns past hd zero (as they arrive in shared
    memory), which add nothing to S, and only the first hd output columns
    are kept. Small integers keep every sum exact."""
    rng = np.random.default_rng(HD + hd)
    KT = pre.KEY_TILES[HD]
    DCH = HD // 16 if HD <= 128 else 4      # Traits::DCH
    pad = np.arange(HD) < hd
    Q = rng.integers(-4, 5, (16, HD)).astype(np.float64) * pad
    K = rng.integers(-4, 5, (KT, HD)).astype(np.float64) * pad
    V = rng.integers(-4, 5, (KT, HD)).astype(np.float64) * pad
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
    np.testing.assert_array_equal(P, Q[:, :hd] @ K[:, :hd].T)
    O = np.zeros((16, HD))
    for h in range(2):
        acc = np.zeros((HD // 16, 32, 4))
        for dc in range(0, HD // 16, DCH):
            o = np.zeros((DCH, 32, 4))
            for nt in range(KT // 8):
                a = np.stack([P[g, 8 * nt + t], P[g + 8, 8 * nt + t],
                              P[g, 8 * nt + t + 4], P[g + 8, 8 * nt + t + 4]],
                             1)
                for dt in range(DCH):
                    col = HD // 2 * h + 8 * (dc + dt) + g
                    _dmma(o[dt], a, np.stack([V[8 * nt + t, col],
                                              V[8 * nt + t + 4, col]], 1))
            acc[dc:dc + DCH] += o
        for dt in range(HD // 16):
            for i in range(4):
                col = HD // 2 * h + 8 * dt + 2 * t + i % 2
                O[g + 8 * (i // 2), col] = acc[dt, :, i]
    np.testing.assert_array_equal(O[:, :hd], P @ V[:, :hd])
