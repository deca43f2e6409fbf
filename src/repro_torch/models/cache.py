"""KV-cache storage policy (port of `repro.models.cache.CacheConfig`).

Only the configuration is ported: the paged engine stores the §5.1
packed planes in `models.paging.PagedCacheStore`. The contiguous
`CachedTensor`/`CacheStore` of the scan engine are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.sparq import SparqConfig


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """layout "fp" (float planes in `dtype`) or "sparq" (§5.1 packed int8);
    `sparq` is the codec of the sparq layout (None -> plain int8)."""
    layout: str = "fp"
    dtype: Any = torch.bfloat16
    sparq: Optional[SparqConfig] = None

    def __post_init__(self):
        if self.layout not in ("fp", "sparq"):
            raise ValueError(f"unknown cache layout {self.layout!r}")
        if self.layout == "sparq" and self.sparq is None:
            object.__setattr__(
                self, "sparq", SparqConfig(enabled=False, signed=True))

    @staticmethod
    def sparq_cache(cfg: Optional[SparqConfig] = None) -> "CacheConfig":
        cfg = cfg or SparqConfig.opt5(signed=True)
        if not cfg.signed:
            cfg = dataclasses.replace(cfg, signed=True)  # K/V are signed
        return CacheConfig(layout="sparq", sparq=cfg)


def bytes_per_value(cc: CacheConfig) -> float:
    """Modeled residency of the cache data plane, bytes per value."""
    if cc.layout == "fp":
        return float(torch.empty((), dtype=cc.dtype).element_size())
    from repro_torch.kernels.ops import data_bytes_per_value
    return data_bytes_per_value(cc.sparq)
