"""Port parity, the MoE family: `repro_torch.models.moe` against
`repro.models.moe` on the same numpy inputs, and dbrx-132b's reduced config
(GQA, LayerNorm, SwiGLU experts, 4 experts top-2) end to end against the
JAX package.

Tolerance: MOE_ATOL (1e-5) on f32 values of O(1) for `moe_apply`'s output
and aux terms (the f32 router and the expert products sum in different
orders in XLA and PyTorch); logits within LOGIT_ATOL as in
tests/test_torch_dense_family.py; slot tables, kept masks, weight codes
and greedy tokens exact; the bf16 combine bit for bit.
"""
import dataclasses

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
from repro.models import common as jcommon
from repro.models import moe as jmoe
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
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models.cache import CacheConfig as TCC
from repro_torch.models.common import QuantCtx as TCtx
from repro_torch.models.model import Model as TModel
from repro_torch.models.quantize import quantize_params as tquantize

MOE_ATOL = 1e-5
LOGIT_ATOL = 2e-4
ARCH = "dbrx-132b"
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


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


def test_config_equals_jax():
    assert ARCH in ARCHS
    for jget, tget in ((jcfg, tcfg), (jcfg_reduced, tcfg_reduced)):
        jc, tc = jget(ARCH), tget(ARCH)
        for f in dataclasses.fields(tc):
            want = getattr(jc, f.name)
            want = DTYPES.get(want, want) if not isinstance(
                want, (int, float, str, bool, tuple)) else want
            assert getattr(tc, f.name) == want, (jc.name, f.name)
        assert jc.kv_lora_rank == 0          # no MLA: nothing unported


# ----------------------------------------------------------------------
# moe_apply on its own
# ----------------------------------------------------------------------

# (mlp_type, shared experts, capacity mode): "exact" is C = N; "capacity"
# the default factor 1.25; "drop" a factor of 0.5, which overflows experts
MOE_CASES = [("swiglu", 0, "exact"), ("swiglu", 0, "drop"),
             ("gelu", 0, "drop"), ("geglu", 0, "exact"),
             ("geglu", 0, "drop"), ("swiglu", 1, "capacity"),
             ("gelu", 1, "drop")]


def _moe_cfg(mlp, shared, mode):
    return jcfg_reduced(ARCH).replace(
        mlp_type=mlp, n_shared_experts=shared, d_model=48, moe_d_ff=80,
        n_experts=6, experts_per_token=2, dtype=jnp.float32,
        capacity_factor=0.5 if mode == "drop" else 1.25)


@pytest.mark.parametrize("mlp,shared,mode", MOE_CASES,
                         ids=[f"{m}-sh{s}-{c}" for m, s, c in MOE_CASES])
def test_moe_apply_matches_jax(mlp, shared, mode):
    """y, lb_loss and z_loss on the same f32 inputs and JAX-drawn weights;
    exact capacity drops nothing, the "drop" cases must drop assignments
    (and lose each overflowing expert's last slot, as the reference's
    scatter does)."""
    jc = _moe_cfg(mlp, shared, mode)
    tc = tcfg_reduced(ARCH).replace(**{
        f.name: DTYPES.get(getattr(jc, f.name), getattr(jc, f.name))
        for f in dataclasses.fields(tcfg_reduced(ARCH))
        if f.name in ("mlp_type", "n_shared_experts", "d_model", "moe_d_ff",
                      "n_experts", "experts_per_token", "capacity_factor",
                      "dtype")})
    p = jmoe.moe_init(jax.random.PRNGKey(3), jc)
    x = np.random.default_rng(4).standard_normal((3, 11, 48)).astype(
        np.float32)
    exact = mode == "exact"
    jy, jaux = jax.jit(jmoe.moe_apply, static_argnums=(2,),
                       static_argnames=("exact_capacity",))(
        p, jnp.asarray(x), jc, exact_capacity=exact)
    tp = interop.to_torch(jax.tree.map(np.asarray, p))
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tc,
                              exact_capacity=exact)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=MOE_ATOL)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=MOE_ATOL, atol=0, err_msg=k)
    N = 33
    C = tmoe.capacity(N, tc, exact)
    _, _, _, ids = tmoe.route(torch.from_numpy(x.reshape(N, 48)),
                              tp["router"], 2)
    slot, kept = tmoe.slot_assignments(ids, 6, C)
    dropped = int((~kept).sum())
    if mode == "exact":
        assert dropped == 0
    if mode == "drop":
        assert dropped > 0, C


def _jax_slot_table(expert_ids, gate_vals, E, C):
    """The reference's slot table and gate table (`moe_apply`'s lines)."""
    N, K = expert_ids.shape
    flat_expert = expert_ids.reshape(-1)
    flat_token = jnp.repeat(jnp.arange(N), K)
    onehot = jax.nn.one_hot(flat_expert, E, dtype=jnp.int32)
    slot = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    keep = slot < C
    slot_c = jnp.where(keep, slot, C - 1)
    table = jnp.full((E, C), -1, jnp.int32).at[flat_expert, slot_c].set(
        jnp.where(keep, flat_token, -1), mode="drop")
    gates = jnp.zeros((E, C), jnp.float32).at[flat_expert, slot_c].set(
        jnp.where(keep, gate_vals.reshape(-1), 0.0), mode="drop")
    return table, gates


@pytest.mark.parametrize("C", [12, 5, 3])
def test_bf16_combine_equals_jax_scatter_add_bitwise(C):
    """The port's ascending-expert combine against eager JAX's scatter-add
    in bf16: many tokens share experts (duplicates in the scatter), and at
    C 5 and 3 experts overflow (dropped slots). The slot tables agree
    exactly first."""
    rng = np.random.default_rng(C)
    N, K, E, D = 12, 3, 4, 64
    ids = np.stack([rng.permutation(E)[:K] for _ in range(N)])
    gv = rng.uniform(0.05, 1.0, (N, K)).astype(np.float32)
    gv /= gv.sum(-1, keepdims=True)
    out = (rng.standard_normal((E, C, D)) * 3).astype(np.float32)
    jout = jnp.asarray(out, jnp.bfloat16)
    table, gates = _jax_slot_table(jnp.asarray(ids), jnp.asarray(gv), E, C)
    want = jnp.zeros((N, D), jnp.bfloat16).at[
        jnp.maximum(table, 0).reshape(-1)].add(
        (jout * gates[..., None].astype(jnp.bfloat16)).reshape(-1, D),
        mode="drop")
    tids = torch.from_numpy(ids).long()
    slot, kept = tmoe.slot_assignments(tids, E, C)
    ttable = torch.full((E * C,), -1, dtype=torch.int64)
    cell = tids.reshape(-1) * C + torch.clamp(slot, max=C - 1)
    ttable[cell[kept]] = torch.arange(N).repeat_interleave(K)[kept]
    np.testing.assert_array_equal(ttable.reshape(E, C).numpy(),
                                  np.asarray(table))
    if C < N * K // E:
        assert int((~kept).sum()) > 0
    tout = torch.from_numpy(np.asarray(jout.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tmoe.combine(tout, torch.from_numpy(gv), tids, slot, kept)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.to(torch.float32).numpy(),
        np.asarray(want.astype(jnp.float32)))


def test_top_k_ties_go_to_the_lower_expert():
    """`route` breaks exact ties toward the lower expert id, as
    `lax.top_k` does."""
    router = torch.zeros((4, 6))
    router[:, 1] = router[:, 4] = 1.0             # experts 1 and 4 tie
    x = torch.ones((2, 4))
    _, probs, _, ids = tmoe.route(x, router, 3)
    _, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids[0].tolist() == [1, 4, 0]


# ----------------------------------------------------------------------
# dbrx-132b reduced, end to end
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def dbrx():
    """The reduced dbrx in f32 in both packages, the JAX weights and their
    interop copy, and one set of calibrated spans for both: the port's own
    (the calibration code is the dense family's, held against JAX's in
    tests/test_torch_dense_family.py; here it sees only the attention
    sites, as `Model.quant_sites` says the reference's does)."""
    jc = jcfg_reduced(ARCH).replace(dtype=jnp.float32, remat=False)
    tc = tcfg_reduced(ARCH).replace(dtype=torch.float32, remat=False)
    jm, tm = JModel(jc), TModel(tc, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    tscales = tm.calibrate(tp, [{"tokens": np.random.default_rng(11)
                                 .integers(0, jc.vocab_size, (2, 16))}])
    assert [set(g) for g in tscales] == [{"attn_q", "attn_k", "attn_v",
                                          "attn_out"}]
    jscales = [{k: jnp.asarray(v.numpy()) for k, v in g.items()}
               for g in tscales]
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, jscales=jscales,
                tscales=tscales)


def _ctxs(mode):
    if mode == "off":
        return None, None
    codec = dict(bits=4, opts=5, signed=True)
    return (JCtx(mode="quantized", cfg=JCfg(**codec), impl="reference"),
            TCtx(mode="quantized", cfg=TCfg(**codec)))


def _jax_logits(jm, jp, toks, jctx, jscales):
    """The JAX logits, the layers applied one by one in eager mode (see
    tests/test_torch_dense_family.py::_jax_logits)."""
    cfg = jm.cfg
    x, _ = jm._embed_in(jp, {"tokens": jnp.asarray(toks)}, cfg.dtype)
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1])[None], toks.shape)
    for li in range(cfg.n_layers):
        ctx = jctx if jctx is None else dataclasses.replace(
            jctx, scales={s: v[li] for s, v in jscales[0].items()})
        x, _, _ = jtr.block_apply(
            jax.tree.map(lambda a: a[li], jp["blocks"][0]), x, cfg, "moe",
            positions=pos, mode="train", ctx=ctx)
    x = jcommon.norm(jp["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return np.asarray(jm._head(jp, x))


def test_dbrx_logits_and_loss_match_jax(dbrx):
    """Float logits against the scanned JAX forward, 5opt logits against
    the JAX layers applied eagerly, and `Model.loss` with its
    load-balance and z terms."""
    jm, jp, tm, tp = dbrx["jm"], dbrx["jp"], dbrx["tm"], dbrx["tp"]
    assert tm.kinds == ["moe"] * 2 and jm.kinds == tm.kinds
    toks = np.random.default_rng(1).integers(0, 512, (2, 20))
    jx, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(tm.logits(tp, {"tokens": toks}).numpy(),
                               np.asarray(jm._head(jp, jx)), rtol=0,
                               atol=LOGIT_ATOL, err_msg="scanned, off")
    jctx, tctx = _ctxs("5opt")
    want = _jax_logits(jm, jp, toks, jctx, dbrx["jscales"])
    got = tm.logits(tp, {"tokens": toks}, tctx,
                    scales_groups=dbrx["tscales"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL,
                               err_msg="5opt")
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jtot, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    ttot, tmet = tm.loss(tp, batch)
    assert float(tmet["lb_loss"]) > 0 and float(tmet["z_loss"]) > 0
    for k in ("lm_loss", "lb_loss", "z_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=MOE_ATOL, err_msg=k)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=MOE_ATOL)


def test_quantize_params_quantizes_the_same_leaves(dbrx):
    """Only the attention projections become codes: the 4-D expert banks
    and the router stay float in both packages; the codes are equal."""
    jq = jax.tree.map(np.asarray, jquantize(dbrx["jp"]))
    tq = tquantize(dbrx["tp"])
    jl = jax.tree_util.tree_leaves_with_path(jq)
    tl = jax.tree_util.tree_leaves_with_path(tq)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, j), (_, t) in zip(jl, tl):
        assert str(t.dtype) == f"torch.{j.dtype.name}", path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
    moe = tq["blocks"][0]["moe"]
    assert all(torch.is_tensor(moe[k]) and moe[k].is_floating_point()
               for k in ("router", "w_up", "w_gate", "w_down"))
    assert set(tq["blocks"][0]["attn"]["wq"]) == {"q", "s"}


def test_bf16_init_layout_equals_jax():
    """`init_params(dtype=bf16)` has the JAX tree's keys, shapes and
    dtypes (router and norms f32), with and without shared experts."""
    for shared in (0, 1):
        jc = jcfg_reduced(ARCH).replace(n_shared_experts=shared)
        tc = tcfg_reduced(ARCH).replace(n_shared_experts=shared)
        jp = JModel(jc).init_params(jax.random.PRNGKey(0), jnp.bfloat16)
        tp = TModel(tc, device="cpu").init_params(0, dtype=torch.bfloat16)
        jl = jax.tree_util.tree_leaves_with_path(jp)
        tl = jax.tree_util.tree_leaves_with_path(tp)
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(t.shape) == j.shape, path
            assert str(t.dtype) == f"torch.{j.dtype.name}", path


def _trace(prefill, vocab=512, seed=7):
    """Ragged staggered requests; sequential admission compiles a JAX
    prefill per prompt length, so its trace has two lengths."""
    rng = np.random.default_rng(seed)
    lens = [5, 11, 3, 9, 14] if prefill == "chunked" else [6, 7, 6, 7, 6]
    return [(rng.integers(0, vocab, (L,)), g, a)
            for L, g, a in zip(lens, [7, 5, 9, 6, 4], [0, 0, 2, 3, 5])]


@pytest.mark.parametrize("prefill", ["chunked", "sequential"])
def test_paged_engine_tokens_equal_jax(dbrx, prefill):
    """The paged engine (5opt, int8 attention weights, calibrated spans)
    against the JAX engine in the same admission mode: chunked prefill
    runs the experts at exact capacity, sequential prefill at the
    capacity of the one prompt, as in JAX."""
    jm, tm = dbrx["jm"], dbrx["tm"]
    jp = jquantize(dbrx["jp"])
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    codec = dict(bits=4, opts=5, signed=True)
    kw = dict(page_size=4, n_pages=24, max_active=3, max_seq_len=24,
              prefill=prefill)
    if prefill == "chunked":
        kw.update(chunk_size=16, chunk_align=4, chunk_seg=8)
    trace = _trace(prefill)
    jres, jstats = jserve.ContinuousBatchingEngine(
        jm, JCC.sparq_cache(JCfg(**codec), impl="reference"),
        JCtx(mode="quantized", cfg=JCfg(**codec), impl="reference"),
        dbrx["jscales"], **kw).run(
            jp, [jserve.Request(t, g, arrive_at=a) for t, g, a in trace])
    tres, tstats = tserve.ContinuousBatchingEngine(
        tm, tserve.make_cache_config("sparq", TCfg(**codec)),
        TCtx(mode="quantized", cfg=TCfg(**codec)), dbrx["tscales"],
        device="cpu", **kw).run(
            tp, [tserve.Request(t, g, arrive_at=a) for t, g, a in trace])
    assert set(tres) == set(jres) == set(range(len(trace)))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"{prefill} request {rid}")
    for k in ("decode_steps", "prefill_chunks", "peak_pages_used"):
        assert tstats[k] == jstats[k], k
    assert tstats["free_pages_after"] == kw["n_pages"]


def test_scan_engine_tokens_equal_jax(dbrx):
    """The scan engine over the contiguous sparq cache, batch 2: its
    prefill runs the experts at the batch's capacity, as JAX's does."""
    jm, tm = dbrx["jm"], dbrx["tm"]
    codec = dict(bits=4, opts=5, signed=True)
    toks = np.random.default_rng(3).integers(0, 512, (2, 10))
    jtoks, _ = jserve.DecodeEngine(
        jm, JCC.sparq_cache(JCfg(**codec), impl="reference"),
        JCtx(mode="quantized", cfg=JCfg(**codec), impl="reference"),
        dbrx["jscales"]).generate(dbrx["jp"], {"tokens": jnp.asarray(toks)},
                                  6, warmup=False)
    ttoks, _ = tserve.DecodeEngine(
        tm, TCC.sparq_cache(TCfg(**codec)),
        TCtx(mode="quantized", cfg=TCfg(**codec)), dbrx["tscales"]).generate(
            dbrx["tp"], {"tokens": toks}, 6, warmup=False)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))


def test_cli_serves_dbrx_on_cpu():
    """`--arch dbrx-132b --reduced` through the paged chunked engine and
    the scan engine, on the CPU."""
    common = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
              "12", "--gen", "3", "--calibrate", "1", "--prequantize",
              "--kv-cache", "sparq", "--sparq", "5opt", "--device", "cpu"]
    stats = tserve.main(common + ["--engine", "paged", "--prefill",
                                  "chunked", "--page-size", "4",
                                  "--chunk-size", "16", "--chunk-align",
                                  "4"])
    assert stats["decode_tokens"] == 2 * (3 - 1)
    assert stats["free_pages_after"] == stats["pool_pages"]
    stats = tserve.main(common)
    assert stats["tokens"].shape == (2, 3)
