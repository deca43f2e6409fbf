"""Paged SPARQ KV cache (port of `repro.models.paging`, the parts the
paged engine runs without preemption or the prefix cache): one pool of
fixed-size §5.1 packed pages per layer, per-slot block tables, the
host-side page allocator, and `adopt_prefill` for sequential admission.

  PagedCacheStore   device state of one attention layer: packed pools
                    (int8 window codes + meta bytes), per-slot scales, the
                    block table and per-slot positions. Unlike the JAX
                    store (an immutable pytree), `update` and `write_chunk`
                    write the pools in place and return the store: the
                    pools are the dominant state, and an in-place scatter
                    moves only the bytes written.
  PageAllocator     host-side refcounted free list (pure Python).

Pool geometry: `n_pages` usable pages plus one trash page at index
`n_pages`, the write target of inactive slots, padding tokens and
unallocated blocks, so writes need no host-side masking.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.sparq import SparqConfig
from repro_torch.models.cache import CacheConfig


class PoolExhausted(RuntimeError):
    """Raised host-side when the page pool runs dry."""


class ChunkMeta(NamedTuple):
    """Per-chunk stream metadata (device int32 tensors).

      seq_id        [C]    sequence slot per token (-1 = padding)
      pos           [C]    absolute prompt position per token
      hist          [C]    per-token history boundary (segment start):
                           packed pages for kpos < hist, the chunk's float
                           K/V for kpos in [hist, pos]
      tile_seq      [C/bq] slot owning each query tile (-1 = padding)
      seq_pos_after [S]    positions to install after the chunk's writes
    """
    seq_id: torch.Tensor
    pos: torch.Tensor
    hist: torch.Tensor
    tile_seq: torch.Tensor
    seq_pos_after: torch.Tensor


class PageAllocator:
    """Host-side refcounted free-list allocator for the shared page pool.

    Page ids are shared across layers. `alloc` is atomic (a failing call
    takes nothing) and raises `PoolExhausted`; `release` drops one
    reference per page and returns the pages that reached zero.
    `peak_used` is the pool's high watermark (distinct pages)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages))
        self._ref: Dict[int, int] = {}
        self.peak_used = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def free_pages(self) -> Tuple[int, ...]:
        return tuple(self._free)

    @property
    def refcounts(self) -> Dict[int, int]:
        return dict(self._ref)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"page pool exhausted: need {n} page(s), {len(self._free)} "
                f"of {self.n_pages} free — grow --n-pages, shrink the "
                f"admitted batch, or wait for evictions")
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._ref[p] = 1
        self.peak_used = max(self.peak_used, len(self._ref))
        self.assert_consistent()
        return pages

    def release(self, pages: Sequence[int]) -> List[int]:
        freed: List[int] = []
        for p in pages:
            assert 0 <= p < self.n_pages, f"page {p} outside the pool"
            assert p in self._ref, \
                f"page {p} released while not allocated (double free)"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)
                freed.append(p)
        self.assert_consistent()
        return freed

    def assert_consistent(self) -> None:
        assert len(self._free) == len(set(self._free)), \
            "duplicate pages on the free list"
        assert not set(self._ref).intersection(self._free), \
            "page simultaneously free and allocated"
        assert all(c > 0 for c in self._ref.values()), \
            "allocated page with non-positive refcount"
        assert len(self._free) + len(self._ref) == self.n_pages, \
            "pages leaked: free + used != pool size"


@dataclasses.dataclass
class PagedCacheStore:
    """Paged KV cache of one attention layer (sparq layout only).

      k/v_data, k/v_meta  int8  [P, ps, KV, hd]  packed §5.1 page pools
      k/v_scale           f32   [S]              per-slot site scales
                                                 (0 = uncalibrated)
      block_table         int32 [S, NB]          page per logical block
                                                 (-1 = unallocated; the
                                                 engine shares one table
                                                 across layers)
      seq_pos             int32 [S]              tokens written per slot
                                                 (-1 = inactive slot)
    """
    k_data: torch.Tensor
    k_meta: torch.Tensor
    v_data: torch.Tensor
    v_meta: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    block_table: torch.Tensor
    seq_pos: torch.Tensor
    codec: Optional[SparqConfig] = None

    @staticmethod
    def init(n_seqs: int, n_pages: int, page_size: int, n_blocks: int,
             kv_heads: int, head_dim: int, cc: CacheConfig, device,
             block_table: Optional[torch.Tensor] = None
             ) -> "PagedCacheStore":
        if cc.layout != "sparq":
            raise ValueError("PagedCacheStore stores the packed §5.1 "
                             "planes; use --kv-cache sparq")
        assert head_dim % 2 == 0, \
            f"sparq pairs adjacent lanes; head_dim must be even: {head_dim}"
        shp = (n_pages + 1, page_size, kv_heads, head_dim)  # +1: trash page
        z8 = lambda: torch.zeros(shp, dtype=torch.int8, device=device)
        if block_table is None:
            block_table = torch.full((n_seqs, n_blocks), -1,
                                     dtype=torch.int32, device=device)
        return PagedCacheStore(
            k_data=z8(), k_meta=z8(), v_data=z8(), v_meta=z8(),
            k_scale=torch.zeros((n_seqs,), dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros((n_seqs,), dtype=torch.float32,
                                device=device),
            block_table=block_table,
            seq_pos=torch.full((n_seqs,), -1, dtype=torch.int32,
                               device=device),
            codec=cc.sparq)

    @property
    def page_size(self) -> int:
        return self.k_data.shape[-3]

    @property
    def n_blocks(self) -> int:
        return self.block_table.shape[-1]

    # ------------------------------------------------------------- write
    def _pools(self):
        return self.k_data, self.k_meta, self.v_data, self.v_meta

    def update(self, k_new: torch.Tensor,
               v_new: torch.Tensor) -> "PagedCacheStore":
        """Write one decode token per slot at seq_pos[s] and advance the
        positions. k_new/v_new float [S, 1, KV, hd]. Inactive slots and
        unallocated blocks write to the trash page. A slot's scale is
        frozen once calibrated (> 0), else set from this write's range.
        One K4 launch on the card (`ops.kv_write_paged`)."""
        from repro_torch.kernels.ops import kv_write_paged
        assert k_new.shape[1] == 1, \
            f"paged decode writes one token per step, got {k_new.shape[1]}"
        self.k_scale, self.v_scale, self.seq_pos = kv_write_paged(
            k_new, v_new, *self._pools(), self.k_scale, self.v_scale,
            self.block_table, self.seq_pos, self.codec)
        return self

    def write_chunk(self, k_new: torch.Tensor, v_new: torch.Tensor,
                    meta: ChunkMeta) -> "PagedCacheStore":
        """Scatter one prefill chunk's K/V [C, KV, hd] straight into the
        pool: token i lands at page block_table[seq_id[i], pos[i] // ps],
        row pos[i] % ps, quantized with its slot's scale (frozen once
        calibrated, else the range of the slot's first-segment tokens).
        Padding and unallocated blocks write to the trash page; seq_pos
        becomes meta.seq_pos_after. Two K4 launches on the card
        (`ops.kv_write_chunk`)."""
        from repro_torch.kernels.ops import kv_write_chunk
        self.k_scale, self.v_scale, self.seq_pos = kv_write_chunk(
            k_new, v_new, *self._pools(), self.k_scale, self.v_scale,
            self.block_table, meta.seq_id, meta.pos, meta.hist,
            meta.seq_pos_after, self.codec)
        return self


# ----------------------------------------------------------------------
# attention read path
# ----------------------------------------------------------------------

def paged_decode_attention(q: torch.Tensor, store: PagedCacheStore, *,
                           window: int = 0) -> torch.Tensor:
    """Fused flash-decode over the page pool. q [S, 1, H, hd]; the decoded
    position of each slot is seq_pos - 1 (the token `update` just wrote);
    inactive slots return zeros."""
    from repro_torch.kernels.ops import sparq_paged_decode_attention
    out = sparq_paged_decode_attention(
        q, store.k_data, store.k_meta, store.k_scale,
        store.v_data, store.v_meta, store.v_scale,
        store.block_table, store.seq_pos - 1, window=window)
    return out.to(q.dtype)


def chunked_prefill_attention(q: torch.Tensor, k_chunk: torch.Tensor,
                              v_chunk: torch.Tensor, store: PagedCacheStore,
                              meta: ChunkMeta, *,
                              window: int = 0) -> torch.Tensor:
    """Ragged chunked-prefill attention for one layer, on the store after
    its `write_chunk`. q [1, C, H, hd]; k/v_chunk [C, KV, hd] float."""
    from repro_torch.kernels.ops import sparq_chunked_prefill_attention
    C = q.shape[1]
    out = sparq_chunked_prefill_attention(
        q[0], k_chunk, v_chunk,
        store.k_data, store.k_meta, store.k_scale,
        store.v_data, store.v_meta, store.v_scale,
        store.block_table, meta.seq_id, meta.pos, meta.hist,
        meta.tile_seq, window=window, bq=C // meta.tile_seq.shape[0])
    return out[None].to(q.dtype)


# ----------------------------------------------------------------------
# engine-level transitions and accounting (over the list of layer stores)
# ----------------------------------------------------------------------

def adopt_prefill(store: PagedCacheStore, cs, slot: int,
                  pages: torch.Tensor) -> PagedCacheStore:
    """Move one layer of a prefilled sequence into the pool at `slot`,
    backed by `pages` (int [nbp], on the store's device), in place.

    `cs` is that layer's batch-1 contiguous sparq `CacheStore` of capacity
    nbp * page_size, filled by `Model.prefill`. Its packed planes are
    copied page by page and its calibrated scales and position become the
    slot's: no re-quantization, so the pool bytes are the contiguous
    cache's. Rows past the prompt are the contiguous cache's zeros, masked
    until decode overwrites them, so a reused page is rewritten whole."""
    nbp = pages.shape[0]
    ps = store.page_size
    if cs.k.data.shape[:2] != (1, nbp * ps) or not cs.k.is_sparq:
        raise ValueError(f"adopt_prefill takes a batch-1 sparq cache of "
                         f"{nbp * ps} slots, got {tuple(cs.k.data.shape)}")
    idx = pages.to(device=store.k_data.device, dtype=torch.int64)
    for pool, plane in ((store.k_data, cs.k.data), (store.k_meta, cs.k.meta),
                        (store.v_data, cs.v.data), (store.v_meta, cs.v.meta)):
        pool[idx] = plane.reshape(nbp, ps, *plane.shape[2:])
    store.k_scale[slot] = cs.k.scale
    store.v_scale[slot] = cs.v.scale
    store.block_table[slot] = -1
    store.block_table[slot, :nbp] = idx.to(torch.int32)
    store.seq_pos[slot] = cs.pos
    return store


def evict_slot(stores: Sequence[PagedCacheStore], slot: int) -> None:
    """Clear a finished slot in every layer: deactivate the position and
    zero the scales so the next occupant recalibrates. The shared block
    table row is cleared by the engine; the pages go back to the free list
    host-side, and their stale bytes are overwritten by the next writer."""
    for st in stores:
        st.seq_pos[slot] = -1
        st.k_scale[slot] = 0.0
        st.v_scale[slot] = 0.0


def modeled_pool_bytes(stores: Sequence[PagedCacheStore]) -> dict:
    """Modeled §5.1 residency of the page pools: packed pools charged the
    `kernels.ops` data/ctrl figures, bookkeeping at its actual size (the
    shared block table is charged once per layer, as in the reference,
    which keeps one copy per layer)."""
    from repro_torch.kernels.ops import (ctrl_bytes_per_value,
                                         data_bytes_per_value)
    tally = {"data_bytes": 0.0, "ctrl_bytes": 0.0, "values": 0,
             "other_bytes": 0.0}
    for st in stores:
        n = st.k_data.numel() + st.v_data.numel()
        tally["data_bytes"] += n * data_bytes_per_value(st.codec)
        tally["ctrl_bytes"] += n * ctrl_bytes_per_value(st.codec)
        tally["values"] += n
        for extra in (st.k_scale, st.v_scale, st.block_table, st.seq_pos):
            tally["other_bytes"] += extra.numel() * extra.element_size()
    tally["total_bytes"] = (tally["data_bytes"] + tally["ctrl_bytes"] +
                            tally["other_bytes"])
    return tally
