"""Block assembly and the layer stack (port of `repro.models.transformer`,
kinds "dense", "moe", and MLA's "mla_dense" and "mla_moe"). Layers are
grouped into homogeneous runs with stacked [L, ...] params as in the JAX
package; the stack runs as a Python loop over layers, each with its own
calibrated scales and its own cache store, and sums the MoE layers' aux
terms. In training (mode "train" with
gradients on and `cfg.remat`) each layer is recomputed in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` of the scan
body)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ModelConfig, QuantCtx, norm, norm_init


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               device, dtype=torch.float32) -> Dict:
    """One layer's params: weights drawn in f32 and cast to `dtype`, norms
    (and the MoE router) in f32, as the reference's."""
    _check_kind(kind)
    d, nt = cfg.d_model, cfg.norm_type
    attn_init = mla_mod.mla_init if kind in MLA_KINDS \
        else attn_mod.attention_init
    p = {"ln1": norm_init(d, nt, device),
         "attn": attn_init(gen, cfg, device, dtype),
         "ln2": norm_init(d, nt, device)}
    if kind in ("moe", "mla_moe"):
        p["moe"] = moe_mod.moe_init(gen, cfg, device, dtype)
    else:
        p["ffn"] = ffn_mod.ffn_init(gen, d, cfg.d_ff, cfg.mlp_type,
                                    cfg.n_layers, device, dtype)
    return p


MLA_KINDS = ("mla_dense", "mla_moe")


def _check_kind(kind: str) -> None:
    if kind not in ("dense", "moe") + MLA_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")


def block_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor, cache=None, mode: str = "train",
                ctx: Optional[QuantCtx] = None, chunk=None):
    """Pre-norm residual block. Returns (x, cache, aux): aux holds an MoE
    layer's {"lb_loss", "z_loss"} and is empty for a dense layer. A GQA
    MoE layer's capacity is exact in decode and chunked prefill (a chunk
    mixes tokens of several sequences, so capacity dropping would couple
    one prompt's routing to another's) and not exact otherwise; an MLA MoE
    layer's is exact in decode only (MLA has no chunked prefill), as in
    the reference."""
    _check_kind(kind)
    nt, eps = cfg.norm_type, cfg.norm_eps
    h = norm(params["ln1"], x, nt, eps)
    if kind in MLA_KINDS:
        o, cache = mla_mod.mla_block(params["attn"], h, cfg,
                                     positions=positions, cache=cache,
                                     mode=mode, ctx=ctx)
    else:
        o, cache = attn_mod.attention_block(
            params["attn"], h, cfg, positions=positions, cache=cache,
            mode=mode, ctx=ctx, chunk=chunk)
    x = x + o.to(x.dtype)
    h = norm(params["ln2"], x, nt, eps)
    aux = {}
    if kind in ("moe", "mla_moe"):
        exact = mode in (("decode",) if kind == "mla_moe"
                         else ("decode", "chunk_prefill"))
        o, aux = moe_mod.moe_apply(params["moe"], h, cfg, ctx,
                                   exact_capacity=exact)
    else:
        o = ffn_mod.ffn_apply(params["ffn"], h, cfg.mlp_type, ctx)
    return x + o.to(x.dtype), cache, aux


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family == "dense":
        return ["dense"] * cfg.n_layers
    if cfg.family == "moe":
        if cfg.kv_lora_rank:
            dense_n = cfg.first_dense_layers
            return ["mla_dense"] * dense_n + \
                ["mla_moe"] * (cfg.n_layers - dense_n)
        return ["moe"] * cfg.n_layers
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
               device, dtype=torch.float32) -> list:
    """Per group of same-kind layers, its [L, ...] leaves, filled in place
    one layer at a time: only one layer's f32 draws are alive at once."""
    out = []
    for kind, count in _group_runs(kinds):
        first = block_init(gen, cfg, kind, device, dtype)

        def alloc(x):
            if isinstance(x, dict):
                return {k: alloc(v) for k, v in x.items()}
            return torch.empty((count,) + tuple(x.shape), dtype=x.dtype,
                               device=x.device)

        def fill(dst, src, li):
            if isinstance(src, dict):
                for k in src:
                    fill(dst[k], src[k], li)
            else:
                dst[li].copy_(src)
        stacked = alloc(first)
        fill(stacked, first, 0)
        del first
        for li in range(1, count):
            fill(stacked, block_init(gen, cfg, kind, device, dtype), li)
        out.append(stacked)
    return out


def stack_cache_init(cfg: ModelConfig, kinds: list[str], batch: int,
                     max_len: int, device, cache_cfg=None) -> list:
    """One contiguous cache per layer, in layer order (the flat list
    `stack_apply` indexes): a (k, v, pos) `CacheStore`, or an MLA layer's
    (c_kv, k_pe, pos) `MLACache`."""
    out = []
    for kind in kinds:
        _check_kind(kind)              # an MoE layer's cache is a dense one
        if kind in MLA_KINDS:
            out.append(mla_mod.mla_cache_init(cfg, batch, max_len, device,
                                              cache_cfg))
        else:
            out.append(attn_mod.cache_init(cfg, batch, max_len, device,
                                           cache_cfg))
    return out


def stack_apply(groups_meta: list, blocks: list, x: torch.Tensor,
                cfg: ModelConfig, *, positions: torch.Tensor,
                caches: Optional[list] = None, mode: str = "train",
                ctx: Optional[QuantCtx] = None,
                scales_groups: Optional[list] = None, chunk=None):
    """Apply every layer in order. `caches` is the flat per-layer list of
    cache stores (written in place); `scales_groups[g][site]` holds the
    group's per-layer calibrated spans. Returns (x, aux): the layers'
    "lb_loss" and "z_loss" summed in layer order (f32 zeros for a dense
    stack)."""
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

            def body(p_l, x, kind=kind, cache=cache, bctx=bctx):
                x, _, aux = block_apply(p_l, x, cfg, kind,
                                        positions=positions, cache=cache,
                                        mode=mode, ctx=bctx, chunk=chunk)
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
