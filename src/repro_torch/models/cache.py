"""Contiguous KV cache of the scan engine (port of `repro.models.cache`).

`CacheConfig` picks the storage layout of decode-time state:

  fp     float planes in `dtype` (fp32 / bf16);
  sparq  the paper's §5.1 packed format: int8 window codes plus one meta
         byte per lane pair [mux(1)|shift_hi(3)|shift_lo(3)], written by
         K4's fused write (`kernels.ops.kv_write_contiguous`) under a
         per-site f32 scale, and read by the fused decode kernel K5 tile
         by tile.

`CachedTensor` is one [B, Tmax, ...] plane, `CacheStore` the (k, v, pos)
cache of one attention layer (`ShardedCacheStore` the same over a
tensor-parallel mesh: one CacheStore a shard, holding its KV heads),
`DecCache` an enc-dec decoder layer's
self-attention store beside its float cross-attention K/V, `MLACache`
the (c_kv, k_pe, pos) latent cache of one MLA layer (two planes of
different widths, each under its own scale), `RingKVCache` the (k, v, slot_pos, pos) sliding-window ring of a
local-attention layer (W slots, each token at slot pos % W). Unlike the
JAX pytrees, they are written in place at the device-side position
(`CacheStore.update`, `MLACache.update`, `RingKVCache.insert`: K4
quantizes and writes both sparq planes in one pass; fp planes take
`index_copy_`), so the decode loop never reads a position back to the
host.
`CachedTensor.read()` (K6's full-plane meta-decode with the scale) is the
read-back path only: decode attention consumes the packed planes
directly.

The paged engine stores the same packed format in `models.paging`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

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
        Sparq planes are written in pairs by `CacheStore.update` and
        `MLACache.update`."""
        assert self.layout == "fp", \
            "sparq planes: use CacheStore.update or MLACache.update"
        T_new = x_new.shape[1]
        start = torch.clamp(pos.to(torch.int64),
                            max=self.data.shape[1] - T_new)
        idx = start + torch.arange(T_new, device=self.data.device)
        self.data.index_copy_(1, idx, x_new.to(self.data.dtype))
        return self

    def write_slots(self, x_new: torch.Tensor,
                    slots: torch.Tensor) -> "CachedTensor":
        """Write a float [B, T_new, ...] slab at time indices `slots`
        (int64 [T_new] device tensor) of an fp plane, in place: the ring's
        rolling write. Sparq planes are written in pairs by
        `RingKVCache.insert` (K4's ring mode)."""
        assert self.layout == "fp", "sparq planes: use RingKVCache.insert"
        self.data.index_copy_(1, slots, x_new.to(self.data.dtype))
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
    (int32 0-d device tensor: tokens already in the cache). `head0` is the
    first KV head the planes hold: 0, or a tensor-parallel shard's."""
    k: CachedTensor
    v: CachedTensor
    pos: torch.Tensor
    head0: int = 0

    @staticmethod
    def init(shape, cc: CacheConfig, device, mesh=None):
        """An empty cache of `shape` [B, Tmax, KV, hd] on `device`; with
        `mesh` (a TPMesh of tp > 1, sparq layout) a `ShardedCacheStore`."""
        if mesh is not None and mesh.tp > 1:
            return ShardedCacheStore.init(shape, cc, mesh)
        return CacheStore(k=CachedTensor.init(shape, cc, device),
                          v=CachedTensor.init(shape, cc, device),
                          pos=torch.zeros((), dtype=torch.int32,
                                          device=device))

    # the unsharded cache as a mesh of one: its own only shard
    mesh = None

    @property
    def shards(self) -> List["CacheStore"]:
        return [self]

    @staticmethod
    def from_kv(k: torch.Tensor, v: torch.Tensor, pos) -> "CacheStore":
        """Plain float K/V [B, T, KV, hd] as fp planes holding `pos` tokens
        (the encoder's cross-attention K/V at decode)."""
        one = torch.ones((), dtype=torch.float32, device=k.device)
        return CacheStore(k=CachedTensor(k, None, one),
                          v=CachedTensor(v, None, one),
                          pos=torch.full((), int(pos), dtype=torch.int32,
                                         device=k.device))

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
            self.pos, k.codec, head0=self.head0)
        return self

    def kv(self, dtype=None):
        """Full dequantized (k, v) planes: the read-back path only."""
        return self.k.read(dtype), self.v.read(dtype)

    @property
    def planes(self) -> tuple:
        return (self.k, self.v)


@dataclasses.dataclass
class ShardedCacheStore:
    """A contiguous sparq (k, v, pos) cache over a `TPMesh` of tp > 1 (the
    reference's `CacheStore.init(..., mesh=)`): shard r a `CacheStore` on
    mesh.devices[r] whose planes [B, Tmax, KV/tp, hd] hold KV heads
    [head0, head0 + KV/tp). Every shard keeps the plane scales and the
    position, equal on all of them: each write resolves the scale over
    every head (K4 with the shard's head offset)."""
    shards: list
    mesh: Any

    @staticmethod
    def init(shape, cc: CacheConfig, mesh) -> "ShardedCacheStore":
        from repro_torch.distributed.sharding import shard_heads
        if cc.layout != "sparq":
            raise ValueError("a mesh shards the sparq layout's packed "
                             "planes; use --kv-cache sparq")
        B, T, KV, hd = shape
        shards = []
        for r, dev in enumerate(mesh.devices):
            h0, h1 = shard_heads(KV, mesh.tp, r)
            shards.append(dataclasses.replace(
                CacheStore.init((B, T, h1 - h0, hd), cc, dev), head0=h0))
        return ShardedCacheStore(shards, mesh)

    @property
    def pos(self) -> torch.Tensor:
        return self.shards[0].pos

    def update(self, k_new: torch.Tensor,
               v_new: torch.Tensor) -> "ShardedCacheStore":
        """`CacheStore.update` on every shard with the full float [B, T,
        KV, hd] K/V (lead device): one K4 launch a shard at T = 1, else
        two."""
        on = {}
        for sh in self.shards:
            dev = sh.pos.device
            if dev not in on:
                on[dev] = (k_new.to(dev), v_new.to(dev))
            sh.update(*on[dev])
        return self


@dataclasses.dataclass
class DecCache:
    """The cache of one enc-dec decoder layer (the reference's {"self",
    "cross_k", "cross_v"} dict): the self-attention `CacheStore` and the
    encoder's cross-attention K/V, float [B, T, KV, hd] tensors. They are
    zeros of [B, max_len, KV, hd] until the prefill replaces them with the
    encoder's [B, T_enc, KV, hd] in the activation dtype, as the
    reference's prefill does."""
    self_kv: CacheStore
    cross_k: torch.Tensor
    cross_v: torch.Tensor


@dataclasses.dataclass
class MLACache:
    """The latent cache of one MLA layer (port of `repro.models.mla.
    MLACache`): the rank-r latent c_kv [B, Tmax, r] and the RoPE key k_pe
    [B, Tmax, dr] shared by all heads (576 values a token at deepseek-v2-
    lite's widths, against 4096 for GQA-16), each a `CachedTensor` with its
    own per-site scale, and the write position (int32 0-d device tensor)."""
    c_kv: CachedTensor
    k_pe: CachedTensor
    pos: torch.Tensor

    @staticmethod
    def init(batch: int, max_len: int, rank: int, rope_dim: int,
             cc: CacheConfig, device) -> "MLACache":
        return MLACache(
            c_kv=CachedTensor.init((batch, max_len, rank), cc, device),
            k_pe=CachedTensor.init((batch, max_len, rope_dim), cc, device),
            pos=torch.zeros((), dtype=torch.int32, device=device))

    def update(self, c_kv: torch.Tensor, k_pe: torch.Tensor) -> "MLACache":
        """Append float c_kv [B, T_new, r] and k_pe [B, T_new, dr] at
        `pos`; advances pos. The sparq layout quantizes both planes on
        write through K4 (`ops.kv_write_contiguous` with planes of two
        widths: one launch at T_new = 1, two otherwise), each plane's scale
        resolved and frozen at its first write, as the reference's
        `CachedTensor.append` does plane by plane."""
        c, p = self.c_kv, self.k_pe
        if not c.is_sparq:
            c.append(c_kv, self.pos)
            p.append(k_pe, self.pos)
            self.pos = self.pos + c_kv.shape[1]
            return self
        from repro_torch.kernels.ops import kv_write_contiguous
        c.scale, p.scale, self.pos = kv_write_contiguous(
            c_kv, k_pe, c.data, c.meta, p.data, p.meta, c.scale, p.scale,
            self.pos, c.codec)
        return self

    @property
    def planes(self) -> tuple:
        return (self.c_kv, self.k_pe)


@dataclasses.dataclass
class RingKVCache:
    """The sliding-window KV ring of one local-attention layer (port of
    `repro.models.transformer.RingKVCache`): planes k, v [B, W, KV, hd]
    (fp or sparq), slot_pos [B, W] int32 the absolute position each slot
    holds (-1 empty), pos the next absolute position (int32 0-d device
    tensor). The token at position p lives at slot p % W."""
    k: CachedTensor
    v: CachedTensor
    slot_pos: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(shape, cc: CacheConfig, device) -> "RingKVCache":
        return RingKVCache(
            k=CachedTensor.init(shape, cc, device),
            v=CachedTensor.init(shape, cc, device),
            slot_pos=torch.full(shape[:2], -1, dtype=torch.int32,
                                device=device),
            pos=torch.zeros((), dtype=torch.int32, device=device))

    def insert(self, k_new: torch.Tensor,
               v_new: torch.Tensor) -> "RingKVCache":
        """Write float [B, T_new, KV, hd] K/V (T_new <= W) at slots (pos +
        t) % W, stamp slot_pos there and advance pos, in place (the
        reference's `ring_insert`). The sparq layout quantizes both planes
        on write (`ops.kv_write_ring`: one K4 launch at T_new = 1, two
        otherwise), each plane's scale frozen at its first write."""
        if self.k.is_sparq:
            from repro_torch.kernels.ops import kv_write_ring
            k, v = self.k, self.v
            k.scale, v.scale, self.pos = kv_write_ring(
                k_new, v_new, k.data, k.meta, v.data, v.meta, k.scale,
                v.scale, self.slot_pos, self.pos, k.codec)
            return self
        T_new = k_new.shape[1]
        ab = self.pos.to(torch.int64) + torch.arange(
            T_new, device=self.pos.device)
        slots = ab % self.k.data.shape[1]
        self.k.write_slots(k_new, slots)
        self.v.write_slots(v_new, slots)
        self.slot_pos[:, slots] = ab.to(torch.int32)[None]
        self.pos = self.pos + T_new
        return self


def modeled_cache_bytes(caches: Sequence) -> dict:
    """Modeled §5.1 residency of a list of layer caches (any of the
    port's cache dataclasses: `CacheStore`, `DecCache`, `MLACache`,
    `RingKVCache`, `RGLRUCache`, `RWKVCache`), as the reference's walk:
    `CachedTensor` planes charged `bytes_per_value` (+ the ShiftCtrl
    plane), every other tensor (positions, slot positions, recurrent
    states, cross-attention K/V) its dtype size."""
    tally = {"data_bytes": 0.0, "ctrl_bytes": 0.0, "values": 0,
             "other_bytes": 0.0}

    def visit(node):
        if isinstance(node, CachedTensor):
            cc = CacheConfig(layout="sparq", sparq=node.codec) \
                if node.is_sparq else \
                CacheConfig(layout="fp", dtype=node.data.dtype)
            tally["data_bytes"] += node.n_values * bytes_per_value(cc)
            tally["ctrl_bytes"] += node.n_values * ctrl_bytes_per_value(cc)
            tally["values"] += node.n_values
        elif torch.is_tensor(node):
            tally["other_bytes"] += node.numel() * node.element_size()
        elif isinstance(node, ShardedCacheStore):
            for sh in node.shards:
                visit(sh)
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                visit(getattr(node, f.name))

    for store in caches:
        visit(store)
    tally["total_bytes"] = (tally["data_bytes"] + tally["ctrl_bytes"] +
                            tally["other_bytes"])
    return tally
