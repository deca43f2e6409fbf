"""Where the tensor-parallel paged cache lives (port of the serving part
of `repro.distributed.sharding`: `pool_plane_pspec`, `paged_pool_pspecs`).

GQA heads are KV-major (query head h serves KV head h // G), so sharding
the pools' KV axis `tp` ways cuts the query heads at head-group boundaries
whenever tp divides n_kv_heads: a shard holds whole head groups and reads
none of another shard's bytes. The per-slot scales, block table and
positions are global (the host scheduler is one), and every shard device
keeps a copy (docs/sharding.md, "What shards where").

The training rules (`param_pspecs`, `fit_spec`, `dp_axes`, the
`constrain*` functions, the activation specs) wait for sharded training.
"""
from __future__ import annotations

from typing import Dict, Tuple


def shard_heads(kv_heads: int, tp: int, r: int) -> Tuple[int, int]:
    """Shard r's KV heads [h0, h1) of `kv_heads` split `tp` ways."""
    if kv_heads % tp:
        raise ValueError(f"{kv_heads} KV heads do not split over tp={tp}: "
                         f"a head group (one KV head + its G query heads) "
                         f"never splits")
    n = kv_heads // tp
    return r * n, (r + 1) * n


def paged_pool_specs() -> Dict[str, bool]:
    """`PagedCacheStore`'s fields, each True where it shards on the KV
    axis (the packed data and meta planes) and False where every shard
    device holds it whole (the per-slot scales, the block table and the
    positions)."""
    return {"k_data": True, "k_meta": True, "v_data": True, "v_meta": True,
            "k_scale": False, "v_scale": False, "block_table": False,
            "seq_pos": False}
