"""Paged SPARQ KV cache (port of `repro.models.paging`): one pool of
fixed-size §5.1 packed pages per layer, per-slot block tables, the
host-side page allocator, `adopt_prefill` for sequential admission, the
swap path of preemption and the shared-prefix index.

  PagedCacheStore   device state of one attention layer: packed pools
                    (int8 window codes + meta bytes), per-slot scales, the
                    block table and per-slot positions. Unlike the JAX
                    store (an immutable pytree), `update` and `write_chunk`
                    write the pools in place and return the store: the
                    pools are the dominant state, and an in-place scatter
                    moves only the bytes written.
  PageAllocator     host-side refcounted free list (pure Python): pages
                    are shared by reference between sequences holding
                    the same prompt prefix.
  SwapStore         host copies of preempted sequences' packed pages.
  PrefixIndex       host-side radix tree of prompt prefixes -> full pages.

Pool geometry: `n_pages` usable pages plus one trash page at index
`n_pages`, the write target of inactive slots, padding tokens and
unallocated blocks, so writes need no host-side masking.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
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

    Page ids are shared across layers. `alloc` hands out pages at refcount
    1 and is atomic (a failing call takes nothing) and raises
    `PoolExhausted`; `share` adds a reference to allocated pages (shared-
    prefix adoption); `release` drops one reference per page and returns
    the pages that reached zero, so the caller can invalidate prefix-index
    entries naming them; `free` is a release of pages that must each have
    been exclusively owned. `peak_used` is the pool's high watermark
    (distinct pages)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages))
        self._ref: Dict[int, int] = {}
        self.peak_used = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Distinct allocated pages (each counted once however shared)."""
        return len(self._ref)

    @property
    def shared_count(self) -> int:
        """Allocated pages with more than one reference."""
        return sum(1 for c in self._ref.values() if c > 1)

    @property
    def total_refs(self) -> int:
        """Sum of all refcounts (the block-table references held)."""
        return sum(self._ref.values())

    @property
    def free_pages(self) -> Tuple[int, ...]:
        return tuple(self._free)

    @property
    def refcounts(self) -> Dict[int, int]:
        return dict(self._ref)

    def refcount(self, page: int) -> int:
        """Current reference count (0 = free)."""
        return self._ref.get(page, 0)

    def reset_peak(self) -> None:
        """Restart the high watermark at the current residency."""
        self.peak_used = len(self._ref)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"page pool exhausted: need {n} page(s), {len(self._free)} "
                f"of {self.n_pages} free ({self.used_count} resident, of "
                f"which {self.shared_count} shared across "
                f"{self.total_refs} references) — grow --n-pages, shrink "
                f"the admitted batch, enable --preempt, or wait for "
                f"evictions")
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._ref[p] = 1
        self.peak_used = max(self.peak_used, len(self._ref))
        self.assert_consistent()
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference to each (already allocated) page."""
        for p in pages:
            assert self._ref.get(p, 0) > 0, \
                f"page {p} shared while not allocated"
            self._ref[p] += 1
        self.assert_consistent()

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages freed."""
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

    def free(self, pages: Sequence[int]) -> None:
        """Strict release: every page must have had refcount exactly 1."""
        pages = list(pages)
        for p in pages:
            assert self._ref.get(p, 0) <= 1, \
                f"page {p} freed while shared (refcount " \
                f"{self._ref.get(p, 0)}) — use release()"
        assert len(self.release(pages)) == len(pages)

    def assert_consistent(self) -> None:
        assert len(self._free) == len(set(self._free)), \
            "duplicate pages on the free list"
        assert not set(self._ref).intersection(self._free), \
            "page simultaneously free and allocated"
        assert all(c > 0 for c in self._ref.values()), \
            "allocated page with non-positive refcount"
        assert len(self._free) + len(self._ref) == self.n_pages, \
            "pages leaked: free + used != pool size"


# ----------------------------------------------------------------------
# shared-prefix index (host-side, non-owning)
# ----------------------------------------------------------------------

_HASH_MOD = (1 << 61) - 1       # Mersenne prime
_HASH_BASE = 1_000_003          # above any token id


def _segment_hash(tokens) -> int:
    """Rolling polynomial hash of one token segment (the child-bucket key;
    lookups compare tokens exactly, so a collision costs a compare)."""
    h = 0
    for t in tokens:
        h = (h * _HASH_BASE + int(t) + 1) % _HASH_MOD
    return h


class _PrefixNode:
    """One radix-tree node: a `quantum`-token prompt segment, the full
    pages holding its packed K/V, and its donor's frozen scales."""
    __slots__ = ("tokens", "pages", "scales", "children", "parent", "key")

    def __init__(self, tokens, pages, scales, parent, key):
        self.tokens = tokens        # np.ndarray [quantum]
        self.pages = pages          # tuple of pages, block order
        self.scales = scales        # per layer: (k_scale, v_scale)
        self.children: Dict[int, List["_PrefixNode"]] = {}
        self.parent = parent        # None once dropped from the tree
        self.key = key              # _segment_hash(tokens)


class PrefixIndex:
    """Radix tree over prompt prefixes -> runs of full pages.

    Nodes are `quantum`-token segments, quantum = lcm(page_size, chunk
    segment): whole pages (only full pages that are never written again
    may be shared) and whole prefill segments (a tail job resumes at a
    segment boundary). The index holds no page references: the engine
    calls `invalidate(freed)` with every page whose refcount reached zero,
    and the node naming it drops out with its subtree. A node's scales
    are its donor's, frozen from the prompt's first segment, which every
    node's prefix contains."""

    def __init__(self, quantum: int, page_size: int):
        assert quantum > 0 and quantum % page_size == 0, \
            f"quantum {quantum} must cover whole pages of {page_size}"
        self.quantum = quantum
        self.page_size = page_size
        self._root = _PrefixNode(None, (), None, None, None)
        self._by_page: Dict[int, List[_PrefixNode]] = {}

    @staticmethod
    def _find(node: _PrefixNode, seg: np.ndarray) -> Optional[_PrefixNode]:
        for child in node.children.get(_segment_hash(seg), ()):
            if np.array_equal(child.tokens, seg):
                return child
        return None

    def match(self, tokens) -> Tuple[int, List[int], Optional[list]]:
        """Longest indexed prefix of `tokens` in whole quanta: (tokens
        matched, the pages backing them in block order, the deepest
        node's scales or None on a miss)."""
        tokens = np.asarray(tokens)
        q = self.quantum
        node, pages, scales, n = self._root, [], None, 0
        for d in range(len(tokens) // q):
            child = self._find(node, tokens[d * q:(d + 1) * q])
            if child is None:
                break
            node = child
            pages.extend(child.pages)
            scales = child.scales
            n += q
        return n, pages, scales

    def insert(self, tokens, pages: Sequence[int], scales) -> int:
        """Index the whole-quantum prefix of a prefilled prompt (`pages`
        its pages in block order). Segments already present keep their
        pages (first donor wins). Returns the tokens indexed."""
        tokens = np.asarray(tokens)
        q, ps = self.quantum, self.page_size
        ppn = q // ps
        depth = len(tokens) // q
        assert len(pages) >= depth * ppn, "pages do not cover the prefix"
        node = self._root
        for d in range(depth):
            seg = tokens[d * q:(d + 1) * q]
            child = self._find(node, seg)
            if child is None:
                child = _PrefixNode(
                    np.array(seg), tuple(int(p) for p in
                                         pages[d * ppn:(d + 1) * ppn]),
                    scales, node, _segment_hash(seg))
                node.children.setdefault(child.key, []).append(child)
                for p in child.pages:
                    self._by_page.setdefault(p, []).append(child)
            node = child
        return depth * q

    def invalidate(self, pages: Sequence[int]) -> int:
        """Drop every entry naming any of `pages`, with its subtree.
        Returns the number of nodes dropped."""
        dropped = 0
        for p in pages:
            for node in list(self._by_page.get(p, ())):
                dropped += self._drop(node)
        return dropped

    def _drop(self, node: _PrefixNode) -> int:
        if node.parent is None:             # root, or already dropped
            return 0
        bucket = node.parent.children.get(node.key)
        if bucket is not None and node in bucket:
            bucket.remove(node)
            if not bucket:
                del node.parent.children[node.key]
        node.parent = None
        for p in node.pages:
            b = self._by_page.get(p)
            if b is not None and node in b:
                b.remove(node)
                if not b:
                    del self._by_page[p]
        dropped = 1
        for bucket in list(node.children.values()):
            for child in list(bucket):
                dropped += self._drop(child)
        node.children = {}
        return dropped

    @property
    def n_nodes(self) -> int:
        count, stack = 0, [self._root]
        while stack:
            n = stack.pop()
            for bucket in n.children.values():
                count += len(bucket)
                stack.extend(bucket)
        return count

    @property
    def indexed_pages(self) -> Tuple[int, ...]:
        """Distinct pages named by some entry (sorted)."""
        return tuple(sorted(self._by_page))


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
    """Clear a finished slot in every layer: drop its block-table row,
    deactivate the position and zero the scales so the next occupant
    recalibrates. The pages go back to the free list host-side, and their
    stale bytes are overwritten by the next writer."""
    for st in stores:
        st.block_table[slot] = -1
        st.seq_pos[slot] = -1
        st.k_scale[slot] = 0.0
        st.v_scale[slot] = 0.0


def copy_page(store: PagedCacheStore, src: int, dst: int) -> None:
    """Copy one page's four packed planes to another, in place: the
    copy-on-write step of shared-prefix admission when a tail starts
    mid-page (rows below the boundary stay the shared page's bytes; the
    tail chunk overwrites the rest)."""
    for pool in store._pools():
        pool[dst] = pool[src]


def adopt_prefix_scales(store: PagedCacheStore, slot: int,
                        k_scale: torch.Tensor, v_scale: torch.Tensor
                        ) -> None:
    """Install a donor's frozen scales on `slot`, in place, before the
    tail chunk runs: the tail holds no first-segment token to freeze them
    from, and the shared pages decode only with the scales they were
    encoded with (the donor froze them from the same first segment)."""
    store.k_scale[slot] = k_scale
    store.v_scale[slot] = v_scale


# ----------------------------------------------------------------------
# swap-out / swap-in (preemption)
# ----------------------------------------------------------------------

_SWAP_PLANES = ("k_data", "k_meta", "v_data", "v_meta")


def gather_slot_pages(store: PagedCacheStore, slot: int,
                      pages: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The packed planes of `pages` (int64 [nbp], block order) and the
    slot's scales, as device tensors: a raw gather of the §5.1 bytes, so a
    swap round trip is byte-verbatim."""
    out = {name: getattr(store, name)[pages] for name in _SWAP_PLANES}
    out["k_scale"] = store.k_scale[slot].reshape(1)
    out["v_scale"] = store.v_scale[slot].reshape(1)
    return out


def restore_slot_pages(store: PagedCacheStore,
                       planes: Dict[str, torch.Tensor], slot: int,
                       pages: torch.Tensor, pos: int) -> None:
    """Inverse of `gather_slot_pages`, in place: scatter the planes into
    `pages` (any free pages), and rebind the slot's block-table row,
    scales and position."""
    for name in _SWAP_PLANES:
        getattr(store, name)[pages] = planes[name]
    store.k_scale[slot] = planes["k_scale"][0]
    store.v_scale[slot] = planes["v_scale"][0]
    store.block_table[slot] = -1
    store.block_table[slot, :pages.shape[0]] = pages.to(torch.int32)
    store.seq_pos[slot] = pos


class SwapStore:
    """Host space for preempted sequences' packed pages: one entry per
    request, the `gather_slot_pages` dicts of every layer in one flat
    numpy byte buffer (scales first, then the four int8 planes of each
    layer), and the sequence's position. `put` moves a swap-out in one
    device-to-host copy and `pop(key, device)` a swap-in in one
    host-to-device copy. `bytes_out`, `bytes_in` and `peak` (the largest
    host residency) count the traffic."""

    _ORDER = ("k_scale", "v_scale") + _SWAP_PLANES

    def __init__(self):
        self._entries: Dict[int, dict] = {}
        self.bytes_out = 0
        self.bytes_in = 0
        self.peak = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def resident_bytes(self) -> int:
        return sum(e["flat"].nbytes for e in self._entries.values())

    def put(self, key: int, groups: Sequence[Dict[str, torch.Tensor]],
            pos: int) -> int:
        """Swap a sequence out: `groups` one gathered dict per layer.
        Returns the bytes moved to the host."""
        assert key not in self._entries, f"request {key} already swapped"
        order = [(g, name) for name in self._ORDER[:2]
                 for g in range(len(groups))] + \
                [(g, name) for g in range(len(groups))
                 for name in _SWAP_PLANES]
        parts = [groups[g][name].reshape(-1).view(torch.uint8)
                 for g, name in order]
        layout = [(g, name, groups[g][name].dtype,
                   tuple(groups[g][name].shape), int(t.numel()))
                  for (g, name), t in zip(order, parts)]
        flat = torch.cat(parts).cpu().numpy()        # one D2H copy
        self._entries[key] = {"flat": flat, "layout": layout,
                              "n_groups": len(groups), "pos": int(pos)}
        self.bytes_out += flat.nbytes
        self.peak = max(self.peak, self.resident_bytes)
        return flat.nbytes

    def pos(self, key: int) -> int:
        return self._entries[key]["pos"]

    def n_pages(self, key: int) -> int:
        e = self._entries[key]
        return next(shape[0] for g, name, _, shape, _ in e["layout"]
                    if name == "k_data")

    @staticmethod
    def _unpack(flat, layout, n_groups):
        groups = [dict() for _ in range(n_groups)]
        off = 0
        for g, name, dtype, shape, n in layout:
            groups[g][name] = flat[off:off + n].view(dtype).reshape(shape)
            off += n
        return groups

    def pop(self, key: int, device=None) -> Tuple[List[dict], int]:
        """Swap a sequence back in: (one plane dict per layer, pos), as
        numpy views of the host bytes, or with `device` as tensors there
        after one host-to-device copy. Drops the entry."""
        e = self._entries.pop(key)
        self.bytes_in += e["flat"].nbytes
        if device is None:
            layout = [(g, name, _NP_DTYPE[dt], shape, n)
                      for g, name, dt, shape, n in e["layout"]]
            return self._unpack(e["flat"], layout, e["n_groups"]), e["pos"]
        flat = torch.from_numpy(e["flat"]).to(device)   # one H2D copy
        return self._unpack(flat, e["layout"], e["n_groups"]), e["pos"]

    def discard(self, key: int) -> int:
        """Forget a parked entry without a swap-in (no traffic charged).
        Returns the bytes released."""
        return int(self._entries.pop(key)["flat"].nbytes)


_NP_DTYPE = {torch.int8: np.int8, torch.float32: np.float32}


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
