"""Block assembly and the layer stack (port of `repro.models.transformer`,
kinds "dense", "moe", MLA's "mla_dense" and "mla_moe", RWKV6's "rwkv",
the RG-LRU hybrid's "rg_rec" and "rg_attn", whose local attention
keeps a sliding-window ring cache: `ring_init`, `ring_insert`,
`ring_decode_attention`, and the enc-dec family's encoder "enc" and
decoder "dec" layers, the latter with cross attention over the
encoder's output). Layers are
grouped into homogeneous runs with stacked [L, ...] params as in the JAX
package; the stack runs as a Python loop over layers, each with its own
calibrated scales and its own cache store, and sums the MoE layers' aux
terms. In training (mode "train" with
gradients on and `cfg.remat`) each layer is recomputed in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` of the scan
body)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.cache import (CacheConfig, CacheStore, DecCache,
                                      RingKVCache)
from repro_torch.models.common import (ModelConfig, QuantCtx, norm,
                                       norm_init, row_sum)
from repro_torch.models.quantize import as_weight

MLA_KINDS = ("mla_dense", "mla_moe")
RG_KINDS = ("rg_rec", "rg_attn")
ENCDEC_KINDS = ("enc", "dec")


def _check_kind(kind: str) -> None:
    if kind not in ("dense", "moe", "rwkv") + MLA_KINDS + RG_KINDS \
            + ENCDEC_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")


# ----------------------------------------------------------------------
# the sliding-window ring (rg_attn's decode-time cache)
# ----------------------------------------------------------------------

def ring_init(cfg: ModelConfig, batch: int, device,
              cache_cfg: Optional[CacheConfig] = None) -> RingKVCache:
    cc = cache_cfg or CacheConfig(layout="fp", dtype=torch.bfloat16)
    return RingKVCache.init(
        (batch, cfg.local_window, cfg.n_kv_heads, cfg.head_dim), cc, device)


def ring_insert(cache: RingKVCache, k_new, v_new) -> RingKVCache:
    """Insert T_new <= W tokens at the rolling slots (in place)."""
    return cache.insert(k_new, v_new)


def ring_decode_attention(q: torch.Tensor, cache: RingKVCache,
                          window: int) -> torch.Tensor:
    """q [B, 1, H, hd] against the ring, masked by each slot's absolute
    position. Sparq layout: the raw packed planes go to the fused decode
    (K5 on the card) with kpos = slot_pos and cur = pos - 1, so the ring's
    rotation is never undone; fp layout: the full plane, masked to
    0 <= slot_pos <= cur and slot_pos > cur - window."""
    if cache.k.is_sparq:
        from repro_torch.kernels.ops import sparq_decode_attention
        out = sparq_decode_attention(
            q, cache.k.data, cache.k.meta, cache.k.scale,
            cache.v.data, cache.v.meta, cache.v.scale,
            cache.slot_pos, cache.pos - 1, window=window, bk=cache.k.bk)
        return out.to(q.dtype)
    B, _, H, hd = q.shape
    k, v = cache.k.read(), cache.v.read()
    KV = k.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) \
        * hd ** -0.5
    cur = cache.pos - 1
    sp = cache.slot_pos
    ok = (sp >= 0) & (sp <= cur) & (sp > cur - window)
    s = torch.where(ok[:, None, None, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ----------------------------------------------------------------------
# block init / apply, dispatched on kind
# ----------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               device, dtype=torch.float32) -> Dict:
    """One layer's params: weights drawn in f32 and cast to `dtype`, norms
    (and the MoE router, the RG-LRU's lam, RWKV's mus and vectors) in f32,
    as the reference's. The RG-LRU kinds take a GeGLU FFN whatever
    `mlp_type` says; a "dec" layer has a second attention, "xattn" (the
    cross attention) after its own norm "ln_x"."""
    _check_kind(kind)
    d, nt = cfg.d_model, cfg.norm_type
    if kind == "rwkv":
        return {"ln1": norm_init(d, nt, device),
                "ln2": norm_init(d, nt, device),
                **rwkv_mod.rwkv_block_init(gen, cfg, device, dtype)}
    p = {"ln1": norm_init(d, nt, device)}
    if kind == "rg_rec":
        p["rec"] = rg_mod.rglru_init(gen, cfg, device, dtype)
    else:
        attn_init = mla_mod.mla_init if kind in MLA_KINDS \
            else attn_mod.attention_init
        p["attn"] = attn_init(gen, cfg, device, dtype)
    if kind == "dec":
        p["ln_x"] = norm_init(d, nt, device)
        p["xattn"] = attn_mod.attention_init(gen, cfg, device, dtype)
    p["ln2"] = norm_init(d, nt, device)
    if kind in ("moe", "mla_moe"):
        p["moe"] = moe_mod.moe_init(gen, cfg, device, dtype)
    else:
        p["ffn"] = ffn_mod.ffn_init(gen, d, cfg.d_ff, _mlp(cfg, kind),
                                    cfg.n_layers, device, dtype)
    return p


def _mlp(cfg: ModelConfig, kind: str) -> str:
    return "geglu" if kind in RG_KINDS else cfg.mlp_type


def _rg_attention(params: Dict, h: torch.Tensor, cfg: ModelConfig, *,
                  positions, cache: RingKVCache, mode: str, ctx):
    """rg_attn in prefill and decode. Prefill: local attention over the
    whole prompt, then the ring is primed with its last min(W, T) tokens
    at their absolute slots (pos set to T - min(W, T) first, so the sparq
    scale is that slab's); decode: the token goes into the ring, then
    `ring_decode_attention`. The output projection is a float product of
    the dequantized weight, not `dense`, as in the reference."""
    window = cfg.local_window
    q, k, v = attn_mod.qkv_proj(params, h, cfg, positions, ctx)
    if mode == "decode":
        ring_insert(cache, k, v)
        o = ring_decode_attention(q, cache, window)
    else:
        o = attn_mod.local_attention(q, k, v, window=window)
        T = k.shape[1]
        W = min(window, T)
        cache.pos = torch.full((), T - W, dtype=torch.int32,
                               device=cache.pos.device)
        # the slab K4 reads row by row: a copy when the prompt is longer
        ring_insert(cache, k[:, -W:].contiguous(), v[:, -W:].contiguous())
    return _float_out(params, o, h.dtype), cache


def _float_out(params: Dict, o: torch.Tensor, dtype,
               mp=None) -> torch.Tensor:
    """An attention output [B, T, H, hd] through `wo` as a float product
    of the dequantized weight, not `dense` (no K1, no calibrated site);
    with `mp` (heads split over the model axis) the row product's sum."""
    o = o.reshape(*o.shape[:2], -1)
    if mp is not None:
        return row_sum(params["wo"], o.to(dtype), "attn_out", mp)
    return torch.matmul(o, as_weight(params["wo"], dtype))


def _cross_attention(params: Dict, h: torch.Tensor, cfg: ModelConfig, *,
                     cache: Optional[DecCache], mode: str, enc_out,
                     mp=None):
    """A "dec" layer's cross attention, every product in float (the
    reference's cross attention never reaches `dense`). K/V come from
    `enc_out` in mode train or whenever it is given (and are kept in the
    cache), else from the cache; at decode the query attends through
    `decode_attention` over fp planes holding the encoder's T_enc rows
    (`CacheStore.from_kv`, plain torch), otherwise through the
    bidirectional flash attention. With `mp` (training, heads split over
    the model axis) a rank attends with its heads, `enc_out` entering
    through `copy_to` (`attention.split_proj`)."""
    mp = attn_mod.heads_on(params, cfg, mp)
    if mp is not None:
        q, ck, cv = attn_mod.split_proj(params, h, enc_out, cfg, mp)
        o = attn_mod.flash_attention(q, ck, cv, causal=False,
                                     q_chunk=cfg.attn_chunk,
                                     kv_chunk=cfg.attn_chunk)
        return _float_out(params, o, h.dtype, mp)
    if mode == "train" or enc_out is not None:
        ck = attn_mod._split_heads(torch.matmul(
            enc_out, as_weight(params["wk"], h.dtype)), cfg.n_kv_heads)
        cv = attn_mod._split_heads(torch.matmul(
            enc_out, as_weight(params["wv"], h.dtype)), cfg.n_kv_heads)
    else:
        ck, cv = cache.cross_k, cache.cross_v
    q = attn_mod._split_heads(torch.matmul(
        h, as_weight(params["wq"], h.dtype)), cfg.n_heads)
    if mode == "decode":
        o = attn_mod.decode_attention(
            q, CacheStore.from_kv(ck, cv, ck.shape[1]))
    else:
        o = attn_mod.flash_attention(q, ck, cv, causal=False,
                                     q_chunk=cfg.attn_chunk,
                                     kv_chunk=cfg.attn_chunk)
    if cache is not None:
        cache.cross_k, cache.cross_v = ck, cv
    return _float_out(params, o, h.dtype)


def block_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor, cache=None, mode: str = "train",
                ctx: Optional[QuantCtx] = None, prefix_len: int = 0,
                enc_out: Optional[torch.Tensor] = None, chunk=None,
                groups=None, mp=None):
    """Pre-norm residual block. Returns (x, cache, aux): aux holds an MoE
    layer's {"lb_loss", "z_loss"} and is empty for a dense layer. A GQA
    MoE layer's capacity is exact in decode and chunked prefill (a chunk
    mixes tokens of several sequences, so capacity dropping would couple
    one prompt's routing to another's) and not exact otherwise; an MLA MoE
    layer's is exact in decode only (MLA has no chunked prefill), as in
    the reference. `prefix_len` (a VLM's image prefix) widens the causal
    mask of a dense layer's attention in train and prefill; `enc_out` is
    the encoder's output a "dec" layer attends to. An "enc" layer
    attends both ways and projects its output in float, as the
    reference's. `groups` (sharded training's `distributed.expert.
    ExpertGroups`) reaches an MoE layer's `moe_apply`; `mp` (its
    `distributed.tensor.ModelAxis`, mode train only) makes each sub-
    block whose leaves arrive as model blocks compute on them: the
    normed input enters through `copy_to`, the row product's f32
    partials leave through `reduce_from`. Under sequence parallelism
    (`mp.sp`) x is this rank's block of T: each normed input is made whole
    over T before its sub-block (`mp.enter`), and the sub-block's output
    comes back as this rank's block (its row product reduce-scattered, a
    sub-block that ran whole cut by `mp.shard`)."""
    _check_kind(kind)
    nt, eps = cfg.norm_type, cfg.norm_eps

    def enter(h):
        return h if mp is None else mp.enter(h)

    def out(o):
        return o if mp is None or o.shape[1] == x.shape[1] else mp.shard(o)
    h = enter(norm(params["ln1"], x, nt, eps))
    if kind == "rwkv":
        cm_last = cache.cm_last if cache is not None else None
        o, cache = rwkv_mod.time_mix(params, h, cfg, cache=cache, mode=mode,
                                     ctx=ctx, mp=mp)
        x = x + out(o).to(x.dtype)
        h = enter(norm(params["ln2"], x, nt, eps))
        o = rwkv_mod.channel_mix(params, h, cfg, last=cm_last, ctx=ctx,
                                 mp=mp)
        if cache is not None:
            cache.cm_last = h[:, -1].to(cache.cm_last.dtype)
        return x + out(o).to(x.dtype), cache, {}
    if kind == "rg_rec":
        o, cache = rg_mod.rglru_block(params["rec"], h, cfg, cache=cache,
                                      mode=mode, ctx=ctx, mp=mp)
    elif kind == "rg_attn" and mode in ("prefill", "decode"):
        o, cache = _rg_attention(params["attn"], h, cfg,
                                 positions=positions, cache=cache, mode=mode,
                                 ctx=ctx)
    elif kind in MLA_KINDS:
        o, cache = mla_mod.mla_block(params["attn"], h, cfg,
                                     positions=positions, cache=cache,
                                     mode=mode, ctx=ctx, mp=mp)
    elif kind == "enc" and mode != "decode":
        o = _float_out(params["attn"], attn_mod.flash_attention(
            *attn_mod.qkv_proj(params["attn"], h, cfg, positions, ctx, mp),
            causal=False, q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk),
            x.dtype, attn_mod.heads_on(params["attn"], cfg, mp))
    elif kind == "dec":
        o, _ = attn_mod.attention_block(
            params["attn"], h, cfg, positions=positions,
            cache=cache.self_kv if cache is not None else None, mode=mode,
            ctx=ctx, mp=mp)
        x = x + out(o).to(x.dtype)
        h = enter(norm(params["ln_x"], x, nt, eps))
        o = _cross_attention(params["xattn"], h, cfg, cache=cache,
                             mode=mode, enc_out=enc_out, mp=mp)
    else:
        o, cache = attn_mod.attention_block(
            params["attn"], h, cfg, positions=positions, cache=cache,
            mode=mode, ctx=ctx, chunk=chunk, prefix_len=prefix_len,
            window=cfg.local_window if kind == "rg_attn" else 0, mp=mp)
    x = x + out(o).to(x.dtype)
    h = enter(norm(params["ln2"], x, nt, eps))
    aux = {}
    if kind in ("moe", "mla_moe"):
        exact = mode in (("decode",) if kind == "mla_moe"
                         else ("decode", "chunk_prefill"))
        o, aux = moe_mod.moe_apply(params["moe"], h, cfg, ctx,
                                   exact_capacity=exact, groups=groups,
                                   mp=mp)
    else:
        o = ffn_mod.ffn_apply(params["ffn"], h, _mlp(cfg, kind), ctx,
                              mp if mp is not None and params["ffn"][
                                  "w_down"].shape[0] != cfg.d_ff else None)
    return x + out(o).to(x.dtype), cache, aux


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family in ("dense", "vlm"):
        return ["dense"] * cfg.n_layers
    if cfg.family == "moe":
        if cfg.kv_lora_rank:
            dense_n = cfg.first_dense_layers
            return ["mla_dense"] * dense_n + \
                ["mla_moe"] * (cfg.n_layers - dense_n)
        return ["moe"] * cfg.n_layers
    if cfg.family == "rwkv6":
        return ["rwkv"] * cfg.n_layers
    if cfg.family == "rglru":
        pattern = cfg.block_pattern or ("rg_rec", "rg_rec", "rg_attn")
        return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    if cfg.family == "encdec":
        return ["dec"] * cfg.n_layers
    raise NotImplementedError(f"family {cfg.family!r} is not ported")


def _group_runs(kinds: list[str]) -> list[tuple[str, int]]:
    groups = []
    for k in kinds:
        if groups and groups[-1][0] == k:
            groups[-1] = (k, groups[-1][1] + 1)
        else:
            groups.append((k, 1))
    return groups


def layer_params(stacked, li: int):
    """Layer `li` of a stacked group (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, li) for k, v in stacked.items()}
    return stacked[li]


def unstack_layers(stacked, count: int) -> list:
    """Every layer of a stacked group, as views made by one `unbind` a
    leaf: its backward stacks the layers' gradients once, where indexing
    layer by layer would add a zero-filled [L, ...] gradient a layer."""
    if isinstance(stacked, dict):
        per = {k: unstack_layers(v, count) for k, v in stacked.items()}
        return [{k: per[k][li] for k in stacked} for li in range(count)]
    return list(torch.unbind(stacked, 0))


def stack_init(gen: torch.Generator, cfg: ModelConfig, kinds: list[str],
               device, dtype=torch.float32, blocks=None,
               path: tuple = ()) -> list:
    """Per group of same-kind layers, its [L, ...] leaves, filled in place
    one layer at a time: only one layer's f32 draws are alive at once.
    `blocks(path, shape)` -> slices keeps only those slices of each
    stacked leaf (`path` + (group, keys...), its whole [L, ...] shape):
    each layer's draw writes its part of the block."""
    out = []
    for gi, (kind, count) in enumerate(_group_runs(kinds)):
        first = block_init(gen, cfg, kind, device, dtype)
        cuts = {}

        def alloc(x, sub=()):
            if isinstance(x, dict):
                return {k: alloc(v, sub + (k,)) for k, v in x.items()}
            shape = (count,) + tuple(x.shape)
            if blocks is not None:
                cuts[sub] = blocks(path + (gi,) + sub, shape)
                shape = tuple(len(range(*s.indices(n)))
                              for s, n in zip(cuts[sub], shape))
            return torch.empty(shape, dtype=x.dtype, device=x.device)

        def fill(dst, src, li, sub=()):
            if isinstance(src, dict):
                for k in src:
                    fill(dst[k], src[k], li, sub + (k,))
            elif blocks is None:
                dst[li].copy_(src)
            else:
                lead, rest = cuts[sub][0], cuts[sub][1:]
                if lead.start <= li < lead.stop:
                    dst[li - lead.start].copy_(src[rest])
        stacked = alloc(first)
        fill(stacked, first, 0)
        del first
        for li in range(1, count):
            fill(stacked, block_init(gen, cfg, kind, device, dtype), li)
        out.append(stacked)
    return out


def stack_cache_init(cfg: ModelConfig, kinds: list[str], batch: int,
                     max_len: int, device, cache_cfg=None,
                     dtype=torch.bfloat16, mesh=None) -> list:
    """One cache per layer, in layer order (the flat list `stack_apply`
    indexes): a (k, v, pos) `CacheStore` (sharded over `mesh`'s KV heads
    when given, as the reference's, for dense and MoE layers only), an
    MLA layer's (c_kv, k_pe, pos)
    `MLACache`, an rg_attn layer's `RingKVCache` of `local_window` slots,
    a "dec" layer's `DecCache` (its `CacheStore` and zero cross K/V of
    [batch, max_len, KV, hd]), or a recurrent layer's state (`RGLRUCache`,
    `RWKVCache`); the states and cross K/V stored in the fp layout's
    dtype, else in `dtype`, as the reference's."""
    cc = cache_cfg or CacheConfig(layout="fp", dtype=dtype)
    state_dtype = cc.dtype if cc.layout == "fp" else dtype
    out = []
    for kind in kinds:
        _check_kind(kind)              # an MoE layer's cache is a dense one
        if kind == "rwkv":
            out.append(rwkv_mod.rwkv_cache_init(cfg, batch, device,
                                                state_dtype))
        elif kind == "rg_rec":
            out.append(rg_mod.rglru_cache_init(cfg, batch, device,
                                               state_dtype))
        elif kind == "rg_attn":
            out.append(ring_init(cfg, batch, device, cc))
        elif kind in MLA_KINDS:
            out.append(mla_mod.mla_cache_init(cfg, batch, max_len, device,
                                              cache_cfg))
        elif kind == "dec":
            shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            out.append(DecCache(
                self_kv=attn_mod.cache_init(cfg, batch, max_len, device, cc),
                cross_k=torch.zeros(shape, dtype=state_dtype, device=device),
                cross_v=torch.zeros(shape, dtype=state_dtype,
                                    device=device)))
        else:
            out.append(attn_mod.cache_init(cfg, batch, max_len, device,
                                           cache_cfg, mesh=mesh))
    return out


def stack_apply(groups_meta: list, blocks: list, x: torch.Tensor,
                cfg: ModelConfig, *, positions: torch.Tensor,
                caches: Optional[list] = None, mode: str = "train",
                ctx: Optional[QuantCtx] = None,
                scales_groups: Optional[list] = None, prefix_len: int = 0,
                enc_out: Optional[torch.Tensor] = None, chunk=None,
                gather: Optional[Callable] = None, groups=None, mp=None):
    """Apply every layer in order. `caches` is the flat per-layer list of
    cache stores (written in place); `scales_groups[g][site]` holds the
    group's per-layer calibrated spans; `prefix_len` and `enc_out` reach
    every layer (`block_apply`). `gather(g, layer)` turns a layer's blocks
    (group g) into whole weights inside the remat body, so the backward's
    recompute gathers again instead of keeping every layer's weights;
    `groups` places a rank's rows and experts for the MoE layers, and
    `mp` its place on the model axis for the split products.
    Returns (x, aux): the layers' "lb_loss" and "z_loss" summed in layer
    order (f32 zeros for a dense stack)."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros((), dtype=torch.float32, device=x.device)
    li_global = 0
    for gi, ((kind, count), stacked) in enumerate(zip(groups_meta, blocks)):
        scales_g = scales_groups[gi] if scales_groups is not None else None
        for li, p_l in enumerate(unstack_layers(stacked, count)):
            bctx = ctx
            if ctx is not None and scales_g is not None:
                bctx = dataclasses.replace(
                    ctx, scales={s: v[li] for s, v in scales_g.items()})
            cache = caches[li_global] if caches is not None else None

            def body(p_l, x, kind=kind, cache=cache, bctx=bctx, gi=gi):
                if gather is not None:
                    p_l = gather(gi, p_l)
                x, _, aux = block_apply(p_l, x, cfg, kind,
                                        positions=positions, cache=cache,
                                        mode=mode, ctx=bctx,
                                        prefix_len=prefix_len,
                                        enc_out=enc_out, chunk=chunk,
                                        groups=groups, mp=mp)
                return x, aux.get("lb_loss"), aux.get("z_loss")
            if remat:
                x, lb_l, zl_l = torch.utils.checkpoint.checkpoint(
                    body, p_l, x, use_reentrant=False)
            else:
                x, lb_l, zl_l = body(p_l, x)
            if lb_l is not None:
                lb, zl = lb + lb_l, zl + zl_l
            li_global += 1
    return x, {"lb_loss": lb, "z_loss": zl}
