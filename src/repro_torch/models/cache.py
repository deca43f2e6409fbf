"""Contiguous KV cache of the scan engine (port of `repro.models.cache`).

`CacheConfig` picks the storage layout of decode-time state:

  fp     float planes in `dtype` (fp32 / bf16);
  sparq  the paper's §5.1 packed format: int8 window codes plus one meta
         byte per lane pair [mux(1)|shift_hi(3)|shift_lo(3)], written by
         K4's fused write (`kernels.ops.kv_write_contiguous`) under a
         per-site f32 scale, and read by the fused decode kernel K5 tile
         by tile.

`CachedTensor` is one [B, Tmax, ...] plane, `CacheStore` the (k, v, pos)
cache of one attention layer. Unlike the JAX pytrees, both are written in
place at the device-side position (`CacheStore.update`: K4 quantizes and
writes both sparq planes in one pass; fp planes take `index_copy_`), so
the decode loop never reads a position back to the host.
`CachedTensor.read()` (K6's full-plane meta-decode with the scale) is the
read-back path only: decode attention consumes the packed planes
directly.

The paged engine stores the same packed format in `models.paging`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.core.sparq import SparqConfig


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """layout "fp" (float planes in `dtype`) or "sparq" (§5.1 packed int8);
    `sparq` is the codec of the sparq layout (None -> plain int8);
    `attn_bk` the Tk-tile size of the contiguous decode kernel (None ->
    `kernels.ops.DEFAULT_BK`, clamped to the cache length). The tile split
    fixes the f32 summation order: set it to the paged engine's page size
    to compare contiguous and paged decodes bit for bit."""
    layout: str = "fp"
    dtype: Any = torch.bfloat16
    sparq: Optional[SparqConfig] = None
    attn_bk: Optional[int] = None

    def __post_init__(self):
        if self.layout not in ("fp", "sparq"):
            raise ValueError(f"unknown cache layout {self.layout!r}")
        if self.layout == "sparq" and self.sparq is None:
            object.__setattr__(
                self, "sparq", SparqConfig(enabled=False, signed=True))

    @staticmethod
    def fp32() -> "CacheConfig":
        return CacheConfig(layout="fp", dtype=torch.float32)

    @staticmethod
    def bf16() -> "CacheConfig":
        return CacheConfig(layout="fp", dtype=torch.bfloat16)

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


def ctrl_bytes_per_value(cc: CacheConfig) -> float:
    """Modeled ShiftCtrl side-band residency, bytes per value."""
    if cc.layout == "fp":
        return 0.0
    from repro_torch.kernels.ops import ctrl_bytes_per_value as _ops_ctrl
    return _ops_ctrl(cc.sparq)


@dataclasses.dataclass
class CachedTensor:
    """One cache plane with time axis 1: [B, Tmax, ...rest].

    fp layout:    data float; meta None; scale 1.0.
    sparq layout: data int8 window codes; meta int8 packed ShiftCtrl/
                  MuxCtrl bytes; scale f32 0-d (0 = uncalibrated, set
                  from the first write's range and frozen after it)."""
    data: torch.Tensor
    meta: Optional[torch.Tensor]
    scale: torch.Tensor
    layout: str = "fp"
    codec: Optional[SparqConfig] = None
    bk: Optional[int] = None

    @staticmethod
    def init(shape, cc: CacheConfig, device) -> "CachedTensor":
        if cc.layout == "fp":
            return CachedTensor(
                data=torch.zeros(shape, dtype=cc.dtype, device=device),
                meta=None,
                scale=torch.ones((), dtype=torch.float32, device=device))
        if shape[-1] % 2:
            raise ValueError(f"sparq cache pairs adjacent lanes; the last "
                             f"dim must be even: {shape}")
        return CachedTensor(
            data=torch.zeros(shape, dtype=torch.int8, device=device),
            meta=torch.zeros(shape, dtype=torch.int8, device=device),
            scale=torch.zeros((), dtype=torch.float32, device=device),
            layout="sparq", codec=cc.sparq, bk=cc.attn_bk)

    @property
    def is_sparq(self) -> bool:
        return self.layout == "sparq"

    @property
    def n_values(self) -> int:
        return self.data.numel()

    def append(self, x_new: torch.Tensor,
               pos: torch.Tensor) -> "CachedTensor":
        """Write a float [B, T_new, ...] slab at time offset `pos` (an int32
        0-d device tensor) into an fp plane, in place. The start is clamped
        so the slab fits, as the reference's dynamic_update_slice does;
        callers check the capacity host-side (DecodeEngine.generate).
        Sparq planes are written in pairs by `CacheStore.update`."""
        assert self.layout == "fp", "sparq planes: use CacheStore.update"
        T_new = x_new.shape[1]
        start = torch.clamp(pos.to(torch.int64),
                            max=self.data.shape[1] - T_new)
        idx = start + torch.arange(T_new, device=self.data.device)
        self.data.index_copy_(1, idx, x_new.to(self.data.dtype))
        return self

    def read(self, dtype=None) -> torch.Tensor:
        """The dequantized full plane, codes * scale (one K6 launch on the
        card): the read-back path only. Decode attention must not call
        this for the sparq layout."""
        if self.layout == "fp":
            return self.data if dtype is None else self.data.to(dtype)
        from repro_torch.kernels.ops import sparq_dequantize
        return sparq_dequantize(self.data, self.meta, self.scale, dtype)


@dataclasses.dataclass
class CacheStore:
    """Full-attention KV cache of one layer: two planes + write position
    (int32 0-d device tensor: tokens already in the cache)."""
    k: CachedTensor
    v: CachedTensor
    pos: torch.Tensor

    @staticmethod
    def init(shape, cc: CacheConfig, device) -> "CacheStore":
        return CacheStore(k=CachedTensor.init(shape, cc, device),
                          v=CachedTensor.init(shape, cc, device),
                          pos=torch.zeros((), dtype=torch.int32,
                                          device=device))

    def update(self, k_new: torch.Tensor,
               v_new: torch.Tensor) -> "CacheStore":
        """Append float [B, T_new, KV, hd] K/V at `pos`; advances pos. The
        sparq layout quantizes both planes on write (`ops.
        kv_write_contiguous`: one K4 launch at T_new = 1, two otherwise),
        each plane's scale frozen at its first write."""
        if not self.k.is_sparq:
            self.k.append(k_new, self.pos)
            self.v.append(v_new, self.pos)
            self.pos = self.pos + k_new.shape[1]
            return self
        from repro_torch.kernels.ops import kv_write_contiguous
        k, v = self.k, self.v
        k.scale, v.scale, self.pos = kv_write_contiguous(
            k_new, v_new, k.data, k.meta, v.data, v.meta, k.scale, v.scale,
            self.pos, k.codec)
        return self

    def kv(self, dtype=None):
        """Full dequantized (k, v) planes: the read-back path only."""
        return self.k.read(dtype), self.v.read(dtype)


def modeled_cache_bytes(caches: Sequence[CacheStore]) -> dict:
    """Modeled §5.1 residency of a list of layer caches: planes charged
    `bytes_per_value` (+ the ShiftCtrl plane), positions their size."""
    tally = {"data_bytes": 0.0, "ctrl_bytes": 0.0, "values": 0,
             "other_bytes": 0.0}
    for store in caches:
        for plane in (store.k, store.v):
            cc = CacheConfig(layout="sparq", sparq=plane.codec) \
                if plane.is_sparq else \
                CacheConfig(layout="fp", dtype=plane.data.dtype)
            tally["data_bytes"] += plane.n_values * bytes_per_value(cc)
            tally["ctrl_bytes"] += plane.n_values * ctrl_bytes_per_value(cc)
            tally["values"] += plane.n_values
        tally["other_bytes"] += store.pos.numel() * store.pos.element_size()
    tally["total_bytes"] = (tally["data_bytes"] + tally["ctrl_bytes"] +
                            tally["other_bytes"])
    return tally
