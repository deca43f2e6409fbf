"""Port parity for tensor-parallel paged serving (`--tp N`), on the CPU.

The reference's own TP tests (tests/test_tp_serving.py) need a forced
multi-device JAX mesh; the port's mesh is a list of devices, so here every
shard of `make_tp_mesh(tp, devices=["cpu"] * tp)` lies on the CPU and runs
the kernels' plain versions, one call a shard, exactly as a card would run
the kernels. The setup is the reference file's: the reduced tinyllama
widened to 16 heads over 8 KV heads (every tp in {2, 4, 8} divides it; head
groups of G = 2), f32, pages of 4, 8 pages for 3 slots, chunked admission
(chunk 16, align 4, segments of 2) with the prefix cache on, and
test_scheduler's shared-system-prompt trace (seed 7). Weights come from
the JAX model through `interop`; neither engine quantizes its matmuls
(no QuantCtx, as the reference's test engine).

Held here, with no tolerance anywhere:
  * the port at TP 1 gives the JAX engine's tokens at TP 1;
  * the port at TP 2, 4 and 8 gives the port's TP 1 tokens, over the
    reference's six (tp, codec, policy) rows, with preemption and prefix
    hits really exercised;
  * at every decode step and after the run, every shard's planes are the
    TP 1 run's head slice, byte for byte, and its scales, block table and
    positions are TP 1's;
  * per-device pool bytes against the JAX store's modeled bytes;
  * test_scheduler's invariants replayed on every step of a sharded run;
  * the divisibility and device-count guards, sequential admission at
    TP 2, the global-scale case (a slot's largest |K| in shard 1's heads),
    the contiguous cache sharded through `Model.init_cache(mesh=)`, the
    three attention dispatchers per shard, a sharded swap round trip, and
    that the kernels' plans never read the KV-head count.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.core.sparq import SparqConfig as JCfg
from repro.distributed.sharding import set_activation_spec
from repro.launch import serve as jserve
from repro.models import paging as jpaging
from repro.models.cache import CacheConfig as JCC
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.distributed.sharding import paged_pool_specs, shard_heads
from repro_torch.kernels import ops
from repro_torch.kernels import sparq_decode_attn as dec
from repro_torch.kernels import sparq_prefill_attn as pre
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import TPMesh, make_tp_mesh
from repro_torch.models import paging
from repro_torch.models.cache import CacheConfig, ShardedCacheStore
from repro_torch.models.model import Model as TModel
from test_scheduler import _make_shared_trace
from test_torch_preempt import InvariantChecker

PS = 4
N_PAGES = 8             # tight: the shared trace wants ~30 pages at peak
MAX_ACTIVE = 3
MAX_SEQ_LEN = 24
KV, H = 8, 16

CODECS = {"a8w8": dict(enabled=False, signed=True),
          "5opt": dict(bits=4, opts=5, signed=True)}
PLANES = ("k_data", "k_meta", "v_data", "v_meta")
BOOK = ("k_scale", "v_scale", "block_table", "seq_pos")

ROWS = [(2, "a8w8", "requeue"), (2, "5opt", "swap"), (4, "a8w8", "swap"),
        (4, "5opt", "requeue"), (8, "a8w8", "requeue"), (8, "5opt", "swap")]
IDS = ["tp2-a8w8-requeue", "tp2-5opt-swap", "tp4-a8w8-swap",
       "tp4-5opt-requeue", "tp8-a8w8-requeue", "tp8-5opt-swap"]


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
    activation spec set; the JAX engine here runs on one device."""
    set_activation_spec(None)
    yield


def cpu_mesh(tp):
    return make_tp_mesh(tp, devices=["cpu"] * tp) if tp > 1 else None


@pytest.fixture(scope="module")
def tp_lm():
    """The reference's model: reduced tinyllama widened to 8 KV heads, in
    both packages, the port's weights converted from the JAX ones."""
    jc = jcfg_reduced("tinyllama-1.1b").replace(
        dtype=jnp.float32, remat=False, n_heads=H, n_kv_heads=KV)
    tc = tcfg_reduced("tinyllama-1.1b").replace(
        dtype=torch.float32, n_heads=H, n_kv_heads=KV)
    jm = JModel(jc)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = TModel(tc, device="cpu")
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp)


def _trace(vocab):
    return _make_shared_trace(seed=7, vocab=vocab)


def _port_engine(tm, codec_name, policy_mode, tp, prefill="chunked"):
    kw = dict(chunk_size=16, chunk_align=4, chunk_seg=2,
              prefix_cache=True) if prefill == "chunked" else {}
    cc = dataclasses.replace(
        CacheConfig.sparq_cache(TCfg(**CODECS[codec_name])), attn_bk=PS)
    return tserve.ContinuousBatchingEngine(
        tm, cc, page_size=PS, n_pages=N_PAGES, max_active=MAX_ACTIVE,
        max_seq_len=MAX_SEQ_LEN,
        policy=tserve.SchedulerPolicy(preempt=policy_mode,
                                      victim="last_joined"),
        prefill=prefill, device="cpu", mesh=cpu_mesh(tp), **kw)


def _state(caches):
    """Per layer: each shard's planes (a whole store: one shard) and each
    shard's bookkeeping, as numpy copies."""
    out = []
    for c in caches:
        out.append([({f: getattr(s, f).numpy().copy() for f in PLANES},
                     {f: getattr(s, f).numpy().copy() for f in BOOK})
                    for s in c.shards])
    return out


def _port_run(tm, tp_params, tp, codec_name, policy_mode,
              prefill="chunked"):
    """One port run over the shared trace: (tokens, stats, the state at
    every decode step and after the run, the invariant checker)."""
    eng = _port_engine(tm, codec_name, policy_mode, tp, prefill)
    check = InvariantChecker(ps=PS)
    states, live = [], {}

    def hook(snap):
        check(snap)
        live["caches"] = snap["caches"]
        states.append(_state(snap["caches"]))
    reqs = [tserve.Request(np.asarray(r.tokens), r.gen,
                           arrive_at=r.arrive_at)
            for r in _trace(tm.cfg.vocab_size)]
    res, stats = eng.run(tp_params, reqs, trace_hook=hook)
    states.append(_state(live["caches"]))
    return res, stats, states, check


@pytest.fixture(scope="module")
def runs(tp_lm):
    """Each (tp, codec, policy, prefill) port run, and the JAX engine's
    TP 1 run per codec, made once for the module."""
    cache = {}

    def port(tp, codec_name, policy_mode, prefill="chunked"):
        key = (tp, codec_name, policy_mode, prefill)
        if key not in cache:
            cache[key] = _port_run(tp_lm["tm"], tp_lm["tp"], *key)
        return cache[key]

    def jax_run(codec_name):
        key = ("jax", codec_name)
        if key not in cache:
            jcc = dataclasses.replace(JCC.sparq_cache(
                JCfg(**CODECS[codec_name]), impl="reference"), attn_bk=PS)
            eng = jserve.ContinuousBatchingEngine(
                tp_lm["jm"], jcc, page_size=PS, n_pages=N_PAGES,
                max_active=MAX_ACTIVE, max_seq_len=MAX_SEQ_LEN,
                policy=jserve.SchedulerPolicy(preempt="requeue",
                                              victim="last_joined"),
                prefill="chunked", chunk_size=16, chunk_align=4,
                chunk_seg=2, prefix_cache=True)
            res, stats = eng.run(tp_lm["jp"],
                                 _trace(tp_lm["jm"].cfg.vocab_size))
            cache[key] = ({r: np.asarray(t) for r, t in res.items()}, stats)
        return cache[key]
    return dict(port=port, jax=jax_run)


def _same_tokens(got, want):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")


def _assert_head_slices(states, base, tp):
    """Every step's and the final state: shard r's planes are TP 1's
    heads [h0, h1) byte for byte, its bookkeeping TP 1's."""
    assert len(states) == len(base)
    for i, (st, bs) in enumerate(zip(states, base)):
        for layer, (shards, (whole,)) in enumerate(zip(st, bs)):
            assert len(shards) == tp
            for r, (planes, book) in enumerate(shards):
                h0, h1 = shard_heads(KV, tp, r)
                for f in PLANES:
                    np.testing.assert_array_equal(
                        planes[f], whole[0][f][:, :, h0:h1],
                        err_msg=f"state {i}, layer {layer}, shard {r}, {f}")
                for f in BOOK:
                    np.testing.assert_array_equal(
                        book[f], whole[1][f],
                        err_msg=f"state {i}, layer {layer}, shard {r}, {f}")


# ----------------------------------------------------------------------
# tokens: TP 1 against the JAX engine, TP n against TP 1
# ----------------------------------------------------------------------

@pytest.mark.parametrize("codec_name", list(CODECS))
def test_tp1_matches_jax_engine(runs, codec_name):
    jres, jstats = runs["jax"](codec_name)
    res, stats, _, check = runs["port"](1, codec_name, "requeue")
    _same_tokens(res, jres)
    assert stats["tp"] == jstats["tp"] == 1
    assert stats["pool_bytes_per_device"] == stats["cache_total_bytes"] \
        == jstats["pool_bytes_per_device"]
    for k in ("decode_steps", "prefill_chunks", "preemptions",
              "prefix_hits", "prefix_shared_pages", "cow_copies"):
        assert stats[k] == jstats[k], k
    assert check.steps == stats["decode_steps"] > 0


@pytest.mark.parametrize("tp,codec_name,policy_mode", ROWS, ids=IDS)
def test_tp_token_equality(runs, tp, codec_name, policy_mode):
    """The reference's six rows: greedy tokens equal TP 1's (the JAX
    engine's), with preemption, prefix hits and (swap) swap traffic; the
    scheduler invariants hold at every step of the sharded run."""
    res, stats, _, check = runs["port"](tp, codec_name, policy_mode)
    assert stats["tp"] == tp
    assert check.steps == stats["decode_steps"] > 0
    assert stats["preemptions"] > 0, "pool not tight enough"
    assert stats["prefix_hits"] > 0 and stats["prefix_shared_pages"] > 0
    if policy_mode == "swap":
        assert stats["swap_bytes_out"] == stats["swap_bytes_in"] > 0
    _same_tokens(res, runs["jax"](codec_name)[0])


@pytest.mark.parametrize("tp,codec_name,policy_mode", ROWS, ids=IDS)
def test_tp_shards_hold_tp1_head_slices(runs, tp, codec_name, policy_mode):
    """The same rows against a TP 1 run under the same policy: the same
    schedule and counters, and at every step each shard's planes are the
    TP 1 planes' head slice and its bookkeeping TP 1's."""
    res, stats, states, _ = runs["port"](tp, codec_name, policy_mode)
    bres, bstats, base, _ = runs["port"](1, codec_name, policy_mode)
    _same_tokens(res, bres)
    for k in ("decode_steps", "prefill_chunks", "preemptions",
              "preempt_swap", "swap_bytes_out", "swap_bytes_in",
              "prefix_hits", "cow_copies", "peak_pages_used"):
        assert stats[k] == bstats[k], k
    _assert_head_slices(states, base, tp)


def test_sequential_admission_tp2(runs):
    """Sequential admission at TP 2: each prompt prefills alone into an
    unsharded contiguous cache on the lead device, adopted shard by shard;
    a requeue resume replays through K5 there. Tokens and every step's
    shard bytes are TP 1's."""
    res, stats, states, _ = runs["port"](2, "5opt", "requeue",
                                         "sequential")
    bres, bstats, base, _ = runs["port"](1, "5opt", "requeue", "sequential")
    assert stats["tp"] == 2 and stats["preemptions"] > 0
    assert stats["replay_steps"] == bstats["replay_steps"] > 0
    _same_tokens(res, bres)
    _assert_head_slices(states, base, 2)


# ----------------------------------------------------------------------
# accounting, guards, the mesh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_per_device_pool_accounting(tp_lm, tp):
    """`modeled_pool_bytes_per_device` is the JAX `modeled_pool_bytes` of
    the same stores with data and ctrl over tp; the planes lie sharded
    on the shards' devices and each device's shards share one copy of
    the bookkeeping."""
    eng = _port_engine(tp_lm["tm"], "5opt", "requeue", tp)
    stores, bts = eng._init_stores()
    jeng = jserve.ContinuousBatchingEngine(
        tp_lm["jm"], JCC.sparq_cache(JCfg(**CODECS["5opt"]), "reference"),
        page_size=PS, n_pages=N_PAGES, max_active=MAX_ACTIVE,
        max_seq_len=MAX_SEQ_LEN)
    glob = jpaging.modeled_pool_bytes(jax.eval_shape(jeng._init_stores))
    per = paging.modeled_pool_bytes_per_device(stores)
    assert paging.modeled_pool_bytes(stores)["total_bytes"] == \
        glob["total_bytes"]
    assert per["tp"] == tp
    assert per["data_bytes"] == glob["data_bytes"] / tp
    assert per["ctrl_bytes"] == glob["ctrl_bytes"] / tp
    assert per["other_bytes"] == glob["other_bytes"]
    assert per["total_bytes"] == pytest.approx(
        (glob["data_bytes"] + glob["ctrl_bytes"]) / tp + glob["other_bytes"])
    assert len(bts) == 1                        # every shard on the CPU
    for st in stores:
        shards = st.shards if tp > 1 else [st]
        for r, sh in enumerate(shards):
            assert sh.head0 == shard_heads(KV, tp, r)[0]
            for name, sharded in paged_pool_specs().items():
                t = getattr(sh, name)
                if sharded:
                    assert t.shape == (N_PAGES + 1, PS, KV // tp,
                                       tp_lm["tm"].cfg.head_dim), name
                else:
                    assert t is getattr(shards[0], name), name
        assert st.block_table is bts[0]


def test_kv_head_divisibility_guard(tp_lm):
    """A tp that would split a head group is refused up front, in the
    reference's words; the dispatchers' guard names the head group."""
    with pytest.raises(ValueError, match="must divide n_kv_heads=8"):
        _port_engine(tp_lm["tm"], "5opt", "requeue", 3)
    with pytest.raises(ValueError, match="never splits"):
        ops._tp_guard(8, 3)
    with pytest.raises(ValueError, match="never splits"):
        shard_heads(8, 3, 0)
    assert [shard_heads(8, 4, r) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]


def test_make_tp_mesh_guards(monkeypatch):
    """tp < 1 raises; on cuda the default mesh takes the first tp visible
    cards and raises with fewer (the count simulated: no card here);
    `devices=` places the shards, one a shard."""
    with pytest.raises(ValueError, match="--tp must be >= 1, got 0"):
        make_tp_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--tp 2 needs 2 visible cards"):
        make_tp_mesh(2, device="cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_tp_mesh(2, device="cuda")
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.lead == torch.device("cuda", 0) and mesh.tp == 2
    cpu = make_tp_mesh(4, device="cpu")
    assert cpu.devices == (torch.device("cpu"),) * 4
    assert cpu.distinct == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="one device a shard"):
        make_tp_mesh(2, devices=["cpu"])
    assert ops.tp_size(None) == 1 and ops.tp_size(cpu) == 4


def test_plans_do_not_read_the_kv_head_count():
    """K2/K5's split rule and K3's instantiation never see KV: a shard's
    kernel cuts its keys and picks its tiles as TP 1's does."""
    assert list(inspect.signature(dec.split_geometry).parameters) == [
        "n_keys", "tile"]
    assert list(inspect.signature(dec.split_plan).parameters) == [
        "live", "tile"]
    assert list(inspect.signature(pre.k3_traits).parameters) == [
        "hd", "G", "bq", "ps"]
    for fn in (dec.sub_keys, dec.smem_bytes):
        assert "KV" not in inspect.signature(fn).parameters


# ----------------------------------------------------------------------
# the pieces, one at a time
# ----------------------------------------------------------------------

def _codec():
    return TCfg(**CODECS["5opt"])


def _skewed(rng, shape, tp, big_shard=1):
    """K/V [..., KV, hd] whose largest |x| lies in shard `big_shard`'s
    heads (x 20 there): a shard seeing only its heads would freeze
    another scale."""
    x = rng.standard_normal(shape).astype(np.float32)
    h0, h1 = shard_heads(shape[-2], tp, big_shard)
    x[..., h0:h1, :] *= 20
    return torch.from_numpy(x)


@pytest.mark.parametrize("tp", [2, 4])
def test_global_scale_freezes_the_tp1_scale_on_every_shard(tp):
    """A decode update and a chunk write at TP `tp` whose largest |K|
    lies in shard 1's heads: every shard freezes the TP 1 scale (the
    range over all KV heads) and writes TP 1's bytes for its heads."""
    cc = CacheConfig.sparq_cache(_codec())
    S, P, NB, hd = 3, 6, 3, 8
    rng = np.random.default_rng(3)
    whole = paging.PagedCacheStore.init(S, P, PS, NB, KV, hd, cc, "cpu")
    sharded = paging.PagedCacheStore.init(S, P, PS, NB, KV, hd, cc, "cpu",
                                          mesh=cpu_mesh(tp))
    bt = torch.tensor([[0, 1, -1], [2, 3, -1], [4, -1, -1]],
                      dtype=torch.int32)
    for st in [whole] + sharded.replicas:
        st.block_table.copy_(bt)
    # a chunk: slot 0's first segment, slot 1's first two tokens
    sid = torch.tensor([0] * 5 + [1] * 2 + [-1], dtype=torch.int32)
    pos = torch.tensor([0, 1, 2, 3, 4, 0, 1, 0], dtype=torch.int32)
    meta = paging.ChunkMeta(sid, pos, torch.zeros(8, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32),
                            torch.tensor([5, 2, 0], dtype=torch.int32))
    k, v = _skewed(rng, (8, KV, hd), tp), _skewed(rng, (8, KV, hd), tp)
    whole.write_chunk(k, v, meta)
    sharded.write_chunk(k, v, meta)
    want = torch.amax(k[:5].abs()) / 127
    assert torch.equal(whole.k_scale[0], want)
    k1, v1 = (_skewed(rng, (S, 1, KV, hd), tp) for _ in range(2))
    whole.update(k1, v1)
    sharded.update(k1, v1)
    for r, sh in enumerate(sharded.shards):
        h0, h1 = shard_heads(KV, tp, r)
        for f in PLANES:
            assert torch.equal(getattr(sh, f),
                               getattr(whole, f)[:, :, h0:h1]), (r, f)
        for f in BOOK:
            assert torch.equal(getattr(sh, f), getattr(whole, f)), (r, f)
    # slot 2 had no chunk token: its first write resolves its scale
    assert sharded.k_scale[2] == torch.amax(k1[2].abs()) / 127


@pytest.mark.parametrize("tp", [2, 4])
def test_dispatchers_per_shard_equal_unsharded(tp):
    """K2, K3 and K5 through `ops` with a mesh: each shard's call over its
    head groups, concatenated in head order, equals the unsharded call
    bit for bit."""
    mesh = cpu_mesh(tp)
    g = torch.Generator().manual_seed(5)
    hd, G, S, P, NB = 8, H // KV, 3, 7, 3

    def i8(*shape):
        return torch.randint(-8, 8, shape, generator=g, dtype=torch.int8)

    def cut(t):
        return [t[:, :, slice(*shard_heads(KV, tp, r))].contiguous()
                for r in range(tp)]

    def rep(t):
        return [t] * tp
    pools = [i8(P + 1, PS, KV, hd) for _ in range(4)]
    sc = [torch.rand(S, generator=g) * 0.05 + 0.01 for _ in range(2)]
    bt = torch.tensor([[0, 1, -1], [2, 3, 4], [5, -1, -1]],
                      dtype=torch.int32)
    cur = torch.tensor([6, 10, -1], dtype=torch.int32)
    q = torch.randn((S, 1, H, hd), generator=g)
    want = ops.sparq_paged_decode_attention(
        q, pools[0], pools[1], sc[0], pools[2], pools[3], sc[1], bt, cur)
    kd, km, vd, vm = map(cut, pools)
    got = ops.sparq_paged_decode_attention(
        q, kd, km, rep(sc[0]), vd, vm, rep(sc[1]), rep(bt), rep(cur),
        mesh=mesh)
    assert torch.equal(got, want)
    C, bq = 8, 4
    qc = torch.randn((C, H, hd), generator=g)
    kc, vc = (torch.randn((C, KV, hd), generator=g) for _ in range(2))
    sid = torch.tensor([0] * 4 + [1] * 2 + [-1] * 2, dtype=torch.int32)
    pos = torch.tensor([8, 9, 10, 11, 12, 13, 0, 0], dtype=torch.int32)
    hist = torch.tensor([8] * 4 + [12] * 2 + [0] * 2, dtype=torch.int32)
    ts = torch.tensor([0, 1], dtype=torch.int32)
    want = ops.sparq_chunked_prefill_attention(
        qc, kc, vc, pools[0], pools[1], sc[0], pools[2], pools[3], sc[1],
        bt, sid, pos, hist, ts, bq=bq)
    got = ops.sparq_chunked_prefill_attention(
        qc, kc, vc, kd, km, rep(sc[0]), vd, vm, rep(sc[1]), rep(bt),
        rep(sid), rep(pos), rep(hist), rep(ts), bq=bq, mesh=mesh)
    assert torch.equal(got, want)
    planes = [i8(S, 12, KV, hd) for _ in range(4)]
    s1 = [torch.tensor(0.03), torch.tensor(0.02)]
    kpos = torch.arange(12, dtype=torch.int32)[None].expand(S, 12)
    c1 = torch.tensor(9, dtype=torch.int32)
    want = ops.sparq_decode_attention(
        q, planes[0], planes[1], s1[0], planes[2], planes[3], s1[1], kpos,
        c1, bk=PS)
    pk, pm, pv, pw = map(cut, planes)
    got = ops.sparq_decode_attention(
        q, pk, pm, rep(s1[0]), pv, pw, rep(s1[1]), rep(kpos), rep(c1),
        bk=PS, mesh=mesh)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_contiguous_cache_sharded_through_init_cache(tp_lm, tp):
    """`Model.init_cache(mesh=)`: a contiguous sparq cache whose planes
    shard on the KV heads; prefill and three decode steps (K4 and K5 once
    a shard a layer) give the unsharded logits bit for bit, each shard's
    planes the unsharded head slice, the scales and positions equal."""
    tm, params = tp_lm["tm"], tp_lm["tp"]
    cc = dataclasses.replace(CacheConfig.sparq_cache(_codec()), attn_bk=PS)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 11)))
    logits = {}
    caches = {}
    for t in (1, tp):
        cs = tm.init_cache(2, 16, cache_cfg=cc, mesh=cpu_mesh(t))
        out = [tm.prefill(params, {"tokens": toks}, cs)]
        tok = torch.argmax(out[0], -1)[:, None].to(torch.int32)
        pos = torch.tensor(11, dtype=torch.int32)
        for _ in range(3):
            out.append(tm.decode_step(params, tok, cs, pos))
            tok = torch.argmax(out[-1], -1)[:, None].to(torch.int32)
            pos = pos + 1
        logits[t], caches[t] = out, cs
    for a, b in zip(logits[1], logits[tp]):
        assert torch.equal(a, b)
    for whole, sharded in zip(caches[1], caches[tp]):
        assert isinstance(sharded, ShardedCacheStore)
        for r, sh in enumerate(sharded.shards):
            h0, h1 = shard_heads(KV, tp, r)
            for mine, full in ((sh.k, whole.k), (sh.v, whole.v)):
                assert torch.equal(mine.data, full.data[:, :, h0:h1])
                assert torch.equal(mine.meta, full.meta[:, :, h0:h1])
                assert torch.equal(mine.scale, full.scale)
            assert torch.equal(sh.pos, whole.pos)


def test_sharded_swap_round_trip():
    """gather -> SwapStore.put -> pop -> restore onto other pages of a
    TP 2 store: every shard's bytes and the scales come back verbatim,
    and the bytes moved are the unsharded store's."""
    cc = CacheConfig.sparq_cache(_codec())
    g = torch.Generator().manual_seed(2)
    stores = [paging.PagedCacheStore.init(3, 10, PS, 6, KV, 8, cc, "cpu",
                                          mesh=cpu_mesh(2))
              for _ in range(2)]
    for st in stores:
        for sh in st.shards:
            for f in PLANES:
                getattr(sh, f).copy_(torch.randint(
                    -128, 128, getattr(sh, f).shape, generator=g,
                    dtype=torch.int8))
        st.k_scale[1], st.v_scale[1] = 0.25, 0.5
    src, dst = [4, 1, 7], [0, 9, 3]
    groups = [paging.gather_slot_pages(st, 1, torch.tensor(src))
              for st in stores]
    want = [{f: [t.clone() for t in g_[f]] for f in PLANES}
            for g_ in groups]
    swap = paging.SwapStore()
    nbytes = swap.put(5, groups, pos=11)
    assert nbytes == 2 * (4 * 3 * PS * KV * 8 + 2 * 4)
    assert swap.n_pages(5) == 3
    planes, pos = swap.pop(5, "cpu")
    assert pos == 11 and swap.bytes_in == swap.bytes_out == nbytes
    for st, pl, w in zip(stores, planes, want):
        paging.restore_slot_pages(st, pl, 2, torch.tensor(dst), pos)
        for r, sh in enumerate(st.shards):
            for f in PLANES:
                assert torch.equal(getattr(sh, f)[torch.tensor(dst)],
                                   w[f][r]), (r, f)
            assert sh.k_scale[2] == 0.25 and sh.v_scale[2] == 0.5
            assert sh.seq_pos[2] == 11
            assert sh.block_table[2].tolist()[:3] == dst


def test_mesh_is_a_device_list():
    """A TPMesh is its devices in shard order; distinct devices keep the
    bookkeeping copies."""
    mesh = TPMesh((torch.device("cpu"),) * 2)
    assert mesh.tp == 2 and mesh.lead == torch.device("cpu")
    assert mesh.distinct == (torch.device("cpu"),)
