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
  ShardedPagedCacheStore
                    the same layer over a tensor-parallel mesh (`init(...,
                    mesh=)` at tp > 1): one PagedCacheStore a shard, on its
                    device, holding its KV heads of every page.
  PageAllocator     host-side refcounted free list (pure Python): pages
                    are shared by reference between sequences holding
                    the same prompt prefix.
  SwapStore         host copies of preempted sequences' packed pages.
  PrefixIndex       host-side radix tree of prompt prefixes -> full pages.

Pool geometry: `n_pages` usable pages plus one trash page at index
`n_pages`, the write target of inactive slots, padding tokens and
unallocated blocks, so writes need no host-side masking.

Under tensor parallelism the host side stays global (docs/sharding.md,
"Host-global allocator contract"): one allocator, block table and prefix
index, and every transition below (adoption, eviction, copy-on-write,
swap) is decided once and applied shard by shard, each shard moving only
its own planes and each shard device its copy of the bookkeeping.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sparq import SparqConfig
from repro_torch.distributed.sharding import paged_pool_specs, shard_heads
from repro_torch.models.cache import CacheConfig

__analysis__ = {
    # device steps: the stores' writes and reads, the page moves
    "traced": (
        "PagedCacheStore.update",
        "PagedCacheStore.write_chunk",
        "ShardedPagedCacheStore.update",
        "ShardedPagedCacheStore.write_chunk",
        "paged_decode_attention",
        "chunked_prefill_attention",
        "adopt_prefill",
        "copy_page",
        "adopt_prefix_scales",
        "evict_slot",
        "gather_slot_pages",
        "restore_slot_pages",
    ),
    "host_loop": ("SwapStore.put", "SwapStore.pop"),
    "device_returning": (),
    "device_params": ("SwapStore.put.groups",),
    # repro_torch.obs metric handles: host-side floats only
    "host_objects": ("registry",),
}


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


def meta_for(meta, device) -> ChunkMeta:
    """The chunk metadata as read on `device`: `meta` itself, or under
    tensor parallelism, where `launch.prefill` copies it to every shard
    device once a chunk, the copy there (`meta` then {device:
    ChunkMeta})."""
    return meta[device] if isinstance(meta, dict) else meta


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

    `head0` is the first KV head the pools hold: 0, or a tensor-parallel
    shard's (its writes take the full [.., KV, hd] K/V and keep those
    heads, under the scale of all of them).
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
    head0: int = 0

    @staticmethod
    def init(n_seqs: int, n_pages: int, page_size: int, n_blocks: int,
             kv_heads: int, head_dim: int, cc: CacheConfig, device,
             block_table=None, mesh=None):
        """The empty store of one layer on `device`. With `mesh` (a
        `launch.mesh.TPMesh` of tp > 1, its lead `device`) a
        `ShardedPagedCacheStore`, `block_table` then {device: the table
        there} for the mesh's devices."""
        if mesh is not None and mesh.tp > 1:
            return ShardedPagedCacheStore.init(
                n_seqs, n_pages, page_size, n_blocks, kv_heads, head_dim,
                cc, mesh, block_table)
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

    # the unsharded store as a mesh of one: its own shard and bookkeeping
    mesh = None

    @property
    def shards(self) -> List["PagedCacheStore"]:
        return [self]

    @property
    def replicas(self) -> List["PagedCacheStore"]:
        return [self]

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
            self.block_table, self.seq_pos, self.codec, head0=self.head0)
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
            meta.seq_pos_after, self.codec, head0=self.head0)
        return self


@dataclasses.dataclass
class ShardedPagedCacheStore:
    """The paged cache of one attention layer over a `TPMesh` of tp > 1.

    Shard r is a `PagedCacheStore` on mesh.devices[r] whose four planes
    [P + 1, ps, KV/tp, hd] hold KV heads [head0, head0 + KV/tp) of every
    page (`distributed.sharding.shard_heads`). The scales, block table and
    positions are replicated (`sharding.paged_pool_specs`): one copy a
    device, which the shards there share, so a host write moves them once
    a device. Each write launches K4 once a shard (twice a chunk), each
    with the full K/V and its head offset, so every shard freezes the same
    scale; the shards on one device then take one result. The bookkeeping
    read by the model (`seq_pos`, ...) is the lead device's copy."""
    shards: List[PagedCacheStore]
    mesh: object

    @staticmethod
    def init(n_seqs, n_pages, page_size, n_blocks, kv_heads, head_dim, cc,
             mesh, block_table=None) -> "ShardedPagedCacheStore":
        shards = []
        for r, dev in enumerate(mesh.devices):
            h0, h1 = shard_heads(kv_heads, mesh.tp, r)
            shards.append(dataclasses.replace(PagedCacheStore.init(
                n_seqs, n_pages, page_size, n_blocks, h1 - h0, head_dim, cc,
                dev, None if block_table is None else block_table[dev]),
                head0=h0))
        store = ShardedPagedCacheStore(shards, mesh)
        store._share()
        return store

    def _share(self) -> None:
        """Point every shard's replicated fields at its device's copy (the
        first shard's there)."""
        reps = {rep.k_data.device: rep for rep in self.replicas}
        for sh in self.shards:
            for name, sharded in paged_pool_specs().items():
                if not sharded:
                    setattr(sh, name, getattr(reps[sh.k_data.device], name))

    @property
    def replicas(self) -> List[PagedCacheStore]:
        """One shard a device: the holders of the bookkeeping copies."""
        first: Dict[torch.device, PagedCacheStore] = {}
        for sh in self.shards:
            first.setdefault(sh.k_data.device, sh)
        return list(first.values())

    @property
    def k_scale(self) -> torch.Tensor:
        return self.shards[0].k_scale

    @property
    def v_scale(self) -> torch.Tensor:
        return self.shards[0].v_scale

    @property
    def block_table(self) -> torch.Tensor:
        return self.shards[0].block_table

    @property
    def seq_pos(self) -> torch.Tensor:
        return self.shards[0].seq_pos

    @property
    def codec(self) -> Optional[SparqConfig]:
        return self.shards[0].codec

    @property
    def page_size(self) -> int:
        return self.shards[0].page_size

    @property
    def n_blocks(self) -> int:
        return self.shards[0].n_blocks

    def _each(self, fn, *xs) -> "ShardedPagedCacheStore":
        """fn(shard, *xs on the shard's device) for every shard, then the
        shared bookkeeping rebound to one result a device."""
        on: Dict[torch.device, tuple] = {}
        for sh in self.shards:
            dev = sh.k_data.device
            if dev not in on:
                on[dev] = tuple(x.to(dev) for x in xs)
            fn(sh, *on[dev])
        self._share()
        return self

    def update(self, k_new: torch.Tensor,
               v_new: torch.Tensor) -> "ShardedPagedCacheStore":
        """`PagedCacheStore.update` on every shard: float [S, 1, KV, hd]
        K/V (all heads, lead device). One K4 launch a shard."""
        return self._each(lambda sh, k, v: sh.update(k, v), k_new, v_new)

    def write_chunk(self, k_new: torch.Tensor, v_new: torch.Tensor,
                    meta) -> "ShardedPagedCacheStore":
        """`PagedCacheStore.write_chunk` on every shard, each reading the
        chunk metadata on its device (`meta_for`). Two K4 launches a
        shard."""
        return self._each(
            lambda sh, k, v: sh.write_chunk(k, v, meta_for(meta, k.device)),
            k_new, v_new)


def _shard_columns(store, columns):
    """Each of `columns` (one value a shard) as a dispatcher in
    `kernels.ops` takes it: the list over the shards under tensor
    parallelism, else the one store's value."""
    return columns if store.mesh is not None else [c[0] for c in columns]


# ----------------------------------------------------------------------
# attention read path
# ----------------------------------------------------------------------

def paged_decode_attention(q: torch.Tensor, store: PagedCacheStore, *,
                           window: int = 0) -> torch.Tensor:
    """Fused flash-decode over the page pool. q [S, 1, H, hd]; the decoded
    position of each slot is seq_pos - 1 (the token `update` just wrote);
    inactive slots return zeros."""
    from repro_torch.kernels.ops import sparq_paged_decode_attention
    sh = store.shards
    out = sparq_paged_decode_attention(
        q, *_shard_columns(store, [[getattr(s, f) for s in sh] for f in (
            "k_data", "k_meta", "k_scale", "v_data", "v_meta", "v_scale",
            "block_table")] + [[s.seq_pos - 1 for s in sh]]),
        window=window, mesh=store.mesh)
    return out.to(q.dtype)


def chunked_prefill_attention(q: torch.Tensor, k_chunk: torch.Tensor,
                              v_chunk: torch.Tensor, store: PagedCacheStore,
                              meta: ChunkMeta, *,
                              window: int = 0) -> torch.Tensor:
    """Ragged chunked-prefill attention for one layer, on the store after
    its `write_chunk`. q [1, C, H, hd]; k/v_chunk [C, KV, hd] float."""
    from repro_torch.kernels.ops import sparq_chunked_prefill_attention
    sh = store.shards
    ms = [meta_for(meta, s.k_data.device) for s in sh]
    out = sparq_chunked_prefill_attention(
        q[0], k_chunk, v_chunk, *_shard_columns(store, [
            [getattr(s, f) for s in sh] for f in (
                "k_data", "k_meta", "k_scale", "v_data", "v_meta",
                "v_scale", "block_table")] + [
            [getattr(m, f) for m in ms] for f in (
                "seq_id", "pos", "hist", "tile_seq")]),
        window=window, bq=q.shape[1] // ms[0].tile_seq.shape[0],
        mesh=store.mesh)
    return out[None].to(q.dtype)


# ----------------------------------------------------------------------
# engine-level transitions and accounting (over the list of layer stores)
# ----------------------------------------------------------------------

def adopt_prefill(store, cs, slot: int, pages: torch.Tensor):
    """Move one layer of a prefilled sequence into the pool at `slot`,
    backed by `pages` (int [nbp]), in place.

    `cs` is that layer's batch-1 contiguous sparq `CacheStore` of capacity
    nbp * page_size, filled by `Model.prefill` (on the lead device under
    TP: each shard copies its heads). Its packed planes are copied page by
    page and its calibrated scales and position become the slot's: no
    re-quantization, so the pool bytes are the contiguous cache's. Rows
    past the prompt are the contiguous cache's zeros, masked until decode
    overwrites them, so a reused page is rewritten whole."""
    nbp = pages.shape[0]
    ps = store.page_size
    if cs.k.data.shape[:2] != (1, nbp * ps) or not cs.k.is_sparq:
        raise ValueError(f"adopt_prefill takes a batch-1 sparq cache of "
                         f"{nbp * ps} slots, got {tuple(cs.k.data.shape)}")
    for sh in store.shards:
        dev, kvl = sh.k_data.device, sh.k_data.shape[2]
        idx = pages.to(device=dev, dtype=torch.int64)
        for pool, plane in ((sh.k_data, cs.k.data), (sh.k_meta, cs.k.meta),
                            (sh.v_data, cs.v.data), (sh.v_meta, cs.v.meta)):
            heads = plane[:, :, sh.head0:sh.head0 + kvl]
            pool[idx] = heads.reshape(nbp, ps, kvl, -1).to(dev)
    for rep in store.replicas:
        dev = rep.k_data.device
        rep.k_scale[slot] = cs.k.scale.to(dev)
        rep.v_scale[slot] = cs.v.scale.to(dev)
        rep.block_table[slot] = -1
        rep.block_table[slot, :nbp] = pages.to(device=dev,
                                               dtype=torch.int32)
        rep.seq_pos[slot] = cs.pos.to(dev)
    return store


def evict_slot(stores: Sequence, slot: int) -> None:
    """Clear a finished slot in every layer: drop its block-table row,
    deactivate the position and zero the scales so the next occupant
    recalibrates. The pages go back to the free list host-side, and their
    stale bytes are overwritten by the next writer."""
    for st in stores:
        for rep in st.replicas:
            rep.block_table[slot] = -1
            rep.seq_pos[slot] = -1
            rep.k_scale[slot] = 0.0
            rep.v_scale[slot] = 0.0


def copy_page(store, src: int, dst: int) -> None:
    """Copy one page's four packed planes to another, in place (every
    shard its own heads): the copy-on-write step of shared-prefix
    admission when a tail starts mid-page (rows below the boundary stay
    the shared page's bytes; the tail chunk overwrites the rest)."""
    for sh in store.shards:
        for pool in sh._pools():
            pool[dst] = pool[src]


def adopt_prefix_scales(store, slot: int, k_scale: torch.Tensor,
                        v_scale: torch.Tensor) -> None:
    """Install a donor's frozen scales on `slot`, in place, before the
    tail chunk runs: the tail holds no first-segment token to freeze them
    from, and the shared pages decode only with the scales they were
    encoded with (the donor froze them from the same first segment)."""
    for rep in store.replicas:
        rep.k_scale[slot] = k_scale.to(rep.k_scale.device)
        rep.v_scale[slot] = v_scale.to(rep.v_scale.device)


# ----------------------------------------------------------------------
# swap-out / swap-in (preemption)
# ----------------------------------------------------------------------

_SWAP_PLANES = ("k_data", "k_meta", "v_data", "v_meta")


def gather_slot_pages(store, slot: int,
                      pages: torch.Tensor) -> Dict[str, object]:
    """The packed planes of `pages` (int64 [nbp], block order) and the
    slot's scales, as device tensors: a raw gather of the §5.1 bytes, so a
    swap round trip is byte-verbatim. Under TP each plane is the list of
    the shards' gathers, each on its shard's device."""
    out = dict(zip(_SWAP_PLANES, _shard_columns(store, [
        [getattr(sh, name)[pages.to(sh.k_data.device)]
         for sh in store.shards] for name in _SWAP_PLANES])))
    out["k_scale"] = store.k_scale[slot].reshape(1)
    out["v_scale"] = store.v_scale[slot].reshape(1)
    return out


def restore_slot_pages(store, planes: Dict[str, object], slot: int,
                       pages: torch.Tensor, pos: int) -> None:
    """Inverse of `gather_slot_pages`, in place: scatter the planes into
    `pages` (any free pages), and rebind the slot's block-table row,
    scales and position."""
    sharded = store.mesh is not None
    for r, sh in enumerate(store.shards):
        dev = sh.k_data.device
        for name in _SWAP_PLANES:
            got = planes[name][r] if sharded else planes[name]
            getattr(sh, name)[pages.to(dev)] = got.to(dev)
    for rep in store.replicas:
        dev = rep.k_data.device
        rep.k_scale[slot] = planes["k_scale"][0].to(dev)
        rep.v_scale[slot] = planes["v_scale"][0].to(dev)
        rep.block_table[slot] = -1
        rep.block_table[slot, :pages.shape[0]] = pages.to(
            device=dev, dtype=torch.int32)
        rep.seq_pos[slot] = pos


class SwapStore:
    """Host space for preempted sequences' packed pages: one entry per
    request, the `gather_slot_pages` dicts of every layer in one flat
    numpy byte buffer a device they were gathered on (scales first, then
    the four int8 planes of each layer, a sharded layer's shard by shard),
    and the sequence's position. `put` moves a swap-out in one
    device-to-host copy a device and `pop(key, device)` a swap-in in one
    host-to-device copy a device. `bytes_out`, `bytes_in` and `peak` (the
    largest host residency) count the traffic. `registry`, when given, is a
    `repro_torch.obs` MetricsRegistry the counters are mirrored into
    (`swap_bytes_total{dir=out|in}`, `swap_resident_bytes`,
    `swap_peak_bytes`); the attributes stay authoritative, and
    `reset_counters` pairs with `registry.reset()`."""

    _ORDER = ("k_scale", "v_scale") + _SWAP_PLANES

    def __init__(self, registry=None):
        self._entries: Dict[int, dict] = {}
        self.bytes_out = 0
        self.bytes_in = 0
        self.peak = 0
        self._c_out = self._c_in = self._g_res = self._g_peak = None
        if registry is not None:
            c = registry.counter("swap_bytes_total",
                                 "packed swap traffic by direction",
                                 unit="bytes", labelnames=("dir",))
            self._c_out = c.series(dir="out")
            self._c_in = c.series(dir="in")
            self._g_res = registry.gauge(
                "swap_resident_bytes",
                "packed bytes parked host-side", unit="bytes").series()
            self._g_peak = registry.gauge(
                "swap_peak_bytes",
                "peak host-side swap residency", unit="bytes").series()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @staticmethod
    def _nbytes(e) -> int:
        return sum(flat.nbytes for _, flat, _ in e["bufs"])

    @property
    def resident_bytes(self) -> int:
        return sum(self._nbytes(e) for e in self._entries.values())

    def put(self, key: int, groups: Sequence[Dict[str, object]],
            pos: int) -> int:
        """Swap a sequence out: `groups` one gathered dict per layer.
        Returns the bytes moved to the host."""
        assert key not in self._entries, f"request {key} already swapped"
        order = [(g, name) for name in self._ORDER[:2]
                 for g in range(len(groups))] + \
                [(g, name) for g in range(len(groups))
                 for name in _SWAP_PLANES]
        # (layer, field, shard or None, tensor), grouped by device
        by_dev: Dict[torch.device, list] = {}
        for g, name in order:
            v = groups[g][name]
            for r, t in ([(None, v)] if torch.is_tensor(v)
                         else enumerate(v)):
                by_dev.setdefault(t.device, []).append((g, name, r, t))
        bufs = []
        for dev, items in by_dev.items():
            parts = [t.reshape(-1).view(torch.uint8) for *_, t in items]
            flat = torch.cat(parts).cpu().numpy()   # one D2H copy a device
            bufs.append((dev, flat, [
                (g, name, r, t.dtype, tuple(t.shape), int(b.numel()))
                for (g, name, r, t), b in zip(items, parts)]))
        e = {"bufs": bufs, "n_groups": len(groups), "pos": int(pos)}
        self._entries[key] = e
        nbytes = self._nbytes(e)
        self.bytes_out += nbytes
        self.peak = max(self.peak, self.resident_bytes)
        if self._c_out is not None:
            self._c_out.inc(nbytes)
            self._g_res.set(self.resident_bytes)
            self._g_peak.set_max(self.peak)
        return nbytes

    def pos(self, key: int) -> int:
        return self._entries[key]["pos"]

    def n_pages(self, key: int) -> int:
        return next(shape[0] for _, _, layout in self._entries[key]["bufs"]
                    for _, name, _, _, shape, _ in layout
                    if name == "k_data")

    @staticmethod
    def _unpack(flat, layout, groups, np_dtypes: bool) -> None:
        off = 0
        for g, name, r, dtype, shape, n in layout:
            t = flat[off:off + n].view(_NP_DTYPE[dtype] if np_dtypes
                                       else dtype).reshape(shape)
            if r is None:
                groups[g][name] = t
            else:
                groups[g].setdefault(name, {})[r] = t
            off += n

    def pop(self, key: int, device=None) -> Tuple[List[dict], int]:
        """Swap a sequence back in: (one plane dict per layer, pos), as
        numpy views of the host bytes, or with `device` (the engine's, the
        lead under TP) as tensors after one host-to-device copy a device,
        each on the device it was gathered on. Drops the entry."""
        e = self._entries.pop(key)
        nbytes = self._nbytes(e)
        self.bytes_in += nbytes
        if self._c_in is not None:
            self._c_in.inc(nbytes)
            self._g_res.set(self.resident_bytes)
        groups = [dict() for _ in range(e["n_groups"])]
        for dev, flat, layout in e["bufs"]:
            if device is not None:
                flat = torch.from_numpy(flat).to(
                    device if len(e["bufs"]) == 1 else dev)   # one H2D
            self._unpack(flat, layout, groups, device is None)
        for grp in groups:                  # a sharded plane: shard order
            for name, v in grp.items():
                if isinstance(v, dict):
                    grp[name] = [v[r] for r in sorted(v)]
        return groups, e["pos"]

    def discard(self, key: int) -> int:
        """Forget a parked entry without a swap-in (no traffic charged).
        Returns the bytes released."""
        nbytes = self._nbytes(self._entries.pop(key))
        if self._g_res is not None:
            self._g_res.set(self.resident_bytes)
        return nbytes

    def reset_counters(self) -> None:
        """Zero the traffic counters and restart the residency peak at the
        current footprint (the counterpart of `registry.reset()`)."""
        self.bytes_out = 0
        self.bytes_in = 0
        self.peak = self.resident_bytes
        if self._g_res is not None:
            self._g_res.set(self.resident_bytes)
            self._g_peak.set(self.peak)


_NP_DTYPE = {torch.int8: np.int8, torch.float32: np.float32}


def modeled_pool_bytes(stores: Sequence) -> dict:
    """Modeled §5.1 residency of the page pools: packed pools charged the
    `kernels.ops` data/ctrl figures (a sharded layer's over all its
    shards), bookkeeping at its actual size, once (the shared block table
    is charged once per layer, as in the reference, which keeps one copy
    per layer)."""
    from repro_torch.kernels.ops import (ctrl_bytes_per_value,
                                         data_bytes_per_value)
    tally = {"data_bytes": 0.0, "ctrl_bytes": 0.0, "values": 0,
             "other_bytes": 0.0}
    for st in stores:
        for sh in st.shards:
            n = sh.k_data.numel() + sh.v_data.numel()
            tally["data_bytes"] += n * data_bytes_per_value(sh.codec)
            tally["ctrl_bytes"] += n * ctrl_bytes_per_value(sh.codec)
            tally["values"] += n
        for extra in (st.k_scale, st.v_scale, st.block_table, st.seq_pos):
            tally["other_bytes"] += extra.numel() * extra.element_size()
    tally["total_bytes"] = (tally["data_bytes"] + tally["ctrl_bytes"] +
                            tally["other_bytes"])
    return tally


def modeled_pool_bytes_per_device(stores: Sequence) -> dict:
    """One device's share of `modeled_pool_bytes` under tensor
    parallelism: the packed planes (and their ShiftCtrl side-band) shard
    on the KV axis, so a device of one shard holds 1/tp of the data and
    ctrl bytes; the bookkeeping is replicated and charged in full. At
    tp = 1 this is `modeled_pool_bytes`, with "tp": 1."""
    tps = {1 if st.mesh is None else st.mesh.tp for st in stores}
    assert len(tps) == 1, f"stores disagree on tp: {tps}"
    tp = tps.pop()
    out = modeled_pool_bytes(stores)
    out["tp"] = tp
    for k in ("data_bytes", "ctrl_bytes"):
        out[k] /= tp
    out["total_bytes"] = (out["data_bytes"] + out["ctrl_bytes"] +
                          out["other_bytes"])
    return out
