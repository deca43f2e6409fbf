"""Move the JAX package's parameters, calibrated scales and decode-time
caches into the port.

The functions take numpy arrays — the caller converts a JAX tree with
`jax.tree.map(np.asarray, tree)` — so this module imports no jax. The
trees keep their layout: `params["blocks"][g]` holds layer-stacked
[L, ...] leaves (an MoE layer's "moe" subtree: the f32 router, the
[L, E, ...] expert banks `w_up` / `w_gate` / `w_down`, and `sh_*` with
shared experts; an MLA layer's "attn" subtree: `wq`, `w_dkv`, `w_uk`,
`w_uv`, `wo` and the f32 `c_norm`; an RG-LRU layer's "rec" subtree with
the f32 `lam` and the float `conv_k`; an RWKV layer's flat leaves, the
`mu_*`, `u`, `w0`, `ln_x_*` vectors and the LoRA `w_A` / `w_B` among
them; an enc-dec model's "enc_blocks" and "enc_norm" beside them, each
of its decoder layers with the cross attention "xattn" and its norm
"ln_x"), and prequantized weights are {"q": int8, "s": f32} dicts, as
`quantize_params` makes them in either package; the CNN's tree (nested
lists under "stages", a bare array under "head", BN statistics in its
dicts) carries across as it is.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(tree: Any, device="cpu") -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    tensors on `device`, dtypes kept (f32 stays f32, int8 codes int8)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":    # ml_dtypes' bf16: numpy has none
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(np_params: Any, device="cpu") -> Any:
    """JAX model params (as numpy) -> port params."""
    return to_torch(np_params, device)


def scales_from_jax(np_scales_groups, device="cpu") -> list:
    """JAX `Model.calibrate` output (as numpy: per group {site: (count,)})
    -> the port's scales_groups (f32 tensors)."""
    return [{site: torch.from_numpy(np.array(v, np.float32)).to(device)
             for site, v in group.items()} for group in np_scales_groups]


def cache_from_jax(np_caches, cache_cfg, device="cpu") -> list:
    """JAX decode-time caches (as numpy: `Model.init_cache`'s list of
    layer-stacked caches, leaves [L, ...]) -> the port's flat per-layer
    list with the same bytes, scales, positions and states: `CacheStore`
    (k, v, pos), `MLACache` (c_kv, k_pe, pos), `RingKVCache` (k, v,
    slot_pos, pos), `RGLRUCache` (h, conv) and `RWKVCache` (state,
    tm_last, cm_last), recognised by their fields, and `DecCache` from an
    enc-dec decoder layer's {"self", "cross_k", "cross_v"} dict.
    `cache_cfg` is the port's `CacheConfig` of the same layout (it
    supplies the codec and attention tile; the JAX tree is read by
    attribute only)."""
    from repro_torch.models.cache import (CachedTensor, CacheStore,
                                          DecCache, MLACache, RingKVCache)
    from repro_torch.models.rglru import RGLRUCache
    from repro_torch.models.rwkv6 import RWKVCache

    def plane(ct, li):
        meta = None if ct.meta is None else to_torch(ct.meta[li], device)
        return CachedTensor(
            data=to_torch(ct.data[li], device), meta=meta,
            scale=to_torch(np.asarray(ct.scale[li], np.float32), device),
            layout=cache_cfg.layout,
            codec=cache_cfg.sparq if cache_cfg.layout == "sparq" else None,
            bk=cache_cfg.attn_bk if cache_cfg.layout == "sparq" else None)

    def arr(a, li, dtype=None):
        a = np.asarray(a[li])
        return to_torch(a if dtype is None else a.astype(dtype), device)

    out = []
    for group in np_caches:
        if isinstance(group, dict):          # enc-dec decoder layers
            selfs = cache_from_jax([group["self"]], cache_cfg, device)
            out += [DecCache(self_kv=st, cross_k=arr(group["cross_k"], li),
                             cross_v=arr(group["cross_v"], li))
                    for li, st in enumerate(selfs)]
            continue
        fields = set(group._fields)
        count = np.asarray(getattr(group, group._fields[-1])).shape[0]
        for li in range(count):
            if fields == {"h", "conv"}:
                out.append(RGLRUCache(h=arr(group.h, li),
                                      conv=arr(group.conv, li)))
            elif fields == {"state", "tm_last", "cm_last"}:
                out.append(RWKVCache(state=arr(group.state, li),
                                     tm_last=arr(group.tm_last, li),
                                     cm_last=arr(group.cm_last, li)))
            elif "slot_pos" in fields:
                out.append(RingKVCache(
                    k=plane(group.k, li), v=plane(group.v, li),
                    slot_pos=arr(group.slot_pos, li, np.int32),
                    pos=arr(group.pos, li, np.int32)))
            elif "c_kv" in fields:
                out.append(MLACache(c_kv=plane(group.c_kv, li),
                                    k_pe=plane(group.k_pe, li),
                                    pos=arr(group.pos, li, np.int32)))
            else:
                out.append(CacheStore(k=plane(group.k, li),
                                      v=plane(group.v, li),
                                      pos=arr(group.pos, li, np.int32)))
    return out
