"""Block assembly and the layer stack (port of `repro.models.transformer`,
dense kind only). Layers are grouped into homogeneous runs with stacked
[L, ...] params as in the JAX package; the stack runs as a Python loop over
layers, each with its own calibrated scales and its own cache store. In
training (mode "train" with gradients on and `cfg.remat`) each layer is
recomputed in the backward (`torch.utils.checkpoint`, the reference's
`jax.checkpoint` of the scan body)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import ModelConfig, QuantCtx, norm, norm_init


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               device) -> Dict:
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    d, nt = cfg.d_model, cfg.norm_type
    return {"ln1": norm_init(d, nt, device),
            "attn": attn_mod.attention_init(gen, cfg, device),
            "ln2": norm_init(d, nt, device),
            "ffn": ffn_mod.ffn_init(gen, d, cfg.d_ff, cfg.n_layers, device)}


def block_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor, cache=None, mode: str = "train",
                ctx: Optional[QuantCtx] = None, chunk=None):
    """Pre-norm residual block. Returns (x, cache)."""
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    nt, eps = cfg.norm_type, cfg.norm_eps
    h = norm(params["ln1"], x, nt, eps)
    o, cache = attn_mod.attention_block(
        params["attn"], h, cfg, positions=positions, cache=cache, mode=mode,
        ctx=ctx, chunk=chunk)
    x = x + o.to(x.dtype)
    h = norm(params["ln2"], x, nt, eps)
    x = x + ffn_mod.ffn_apply(params["ffn"], h, cfg.mlp_type, ctx).to(x.dtype)
    return x, cache


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family == "dense":
        return ["dense"] * cfg.n_layers
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
               device) -> list:
    out = []
    for kind, count in _group_runs(kinds):
        layers = [block_init(gen, cfg, kind, device) for _ in range(count)]

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*[x[k] for x in xs]) for k in xs[0]}
            return torch.stack(xs)
        out.append(stack(*layers))
    return out


def stack_cache_init(cfg: ModelConfig, kinds: list[str], batch: int,
                     max_len: int, device, cache_cfg=None) -> list:
    """One contiguous (k, v, pos) cache per layer, in layer order (the
    flat list `stack_apply` indexes)."""
    out = []
    for kind in kinds:
        if kind != "dense":
            raise NotImplementedError(f"layer kind {kind!r} is not ported")
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
    group's per-layer calibrated spans. Returns x."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
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
                return block_apply(p_l, x, cfg, kind, positions=positions,
                                   cache=cache, mode=mode, ctx=bctx,
                                   chunk=chunk)[0]
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    body, p_l, x, use_reentrant=False)
            else:
                x = body(p_l, x)
            li_global += 1
    return x
