"""Move the JAX package's parameters, calibrated scales and contiguous
KV caches into the port.

The functions take numpy arrays — the caller converts a JAX tree with
`jax.tree.map(np.asarray, tree)` — so this module imports no jax. The
trees keep their layout: `params["blocks"][g]` holds layer-stacked
[L, ...] leaves, and prequantized weights are {"q": int8, "s": f32}
dicts, as `quantize_params` makes them in either package; the CNN's tree
(nested lists under "stages", a bare array under "head", BN statistics
in its dicts) carries across as it is.
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
    """JAX contiguous caches (as numpy: `Model.init_cache`'s list of
    layer-stacked `CacheStore`s, leaves [L, ...]) -> the port's flat
    per-layer list of `CacheStore`s with the same bytes, scales and
    positions. `cache_cfg` is the port's `CacheConfig` of the same layout
    (it supplies the codec and attention tile; the JAX tree is read by
    attribute only)."""
    from repro_torch.models.cache import CachedTensor, CacheStore

    def plane(ct, li):
        meta = None if ct.meta is None else to_torch(ct.meta[li], device)
        return CachedTensor(
            data=to_torch(ct.data[li], device), meta=meta,
            scale=to_torch(np.asarray(ct.scale[li], np.float32), device),
            layout=cache_cfg.layout,
            codec=cache_cfg.sparq if cache_cfg.layout == "sparq" else None,
            bk=cache_cfg.attn_bk if cache_cfg.layout == "sparq" else None)

    out = []
    for group in np_caches:
        for li in range(np.asarray(group.pos).shape[0]):
            out.append(CacheStore(
                k=plane(group.k, li), v=plane(group.v, li),
                pos=to_torch(np.asarray(group.pos[li], np.int32), device)))
    return out
