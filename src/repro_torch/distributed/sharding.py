"""Where parameters, batches and the paged cache live on a mesh (port of
`repro.distributed.sharding`).

**Training (FSDP / ZeRO).** `param_pspecs` matches each parameter's name
to a spec and then fits the spec to the leaf's shape, dropping a mesh axis
that does not divide its dimension (whisper's 51865-row vocabulary over a
16-way model axis). A spec is a plain tuple with one entry a dimension:
None, an axis name, or a tuple of names (a merged group, indexed major to
minor in the order it lists them, as `NamedSharding` indexes it); it
compares entry by entry with the reference's `PartitionSpec`. The rules
are the reference's: column-parallel weights `(dp, "model")`, row-parallel
`("model", dp)`, stacked MoE experts `(None, "model", dp, None)`, a
leading stacked-layer axis left whole, and with `tensor_parallel=False`
the ZeRO layout (first dimension over every axis). `shard_tree` gives a
rank its block of each leaf; `unshard_leaf` rebuilds a whole leaf from
the blocks of its group. `model_split` says which leaves a train step
computes on their block over the model axis (Megatron's column and row
products, heads, the vocabulary) and which it makes whole: the rule of
the reference's `constrain_heads`, which never splits inside a head, in
place of that GSPMD hint. `cache_pspecs` places the decode caches (the
dry run's serving cells): the reference's rule on the port's per-layer
caches, whose leaves lack the reference's stacked layer axis.

**Serving (tensor-parallel paged cache).** GQA heads are KV-major (query
head h serves KV head h // G), so sharding the pools' KV axis `tp` ways
cuts the query heads at head-group boundaries whenever tp divides
n_kv_heads: a shard holds whole head groups and reads none of another
shard's bytes. The per-slot scales, block table and positions are global
(the host scheduler is one), and every shard device keeps a copy
(docs/sharding.md, "What shards where").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T

TP = "model"

Spec = Tuple  # one entry a dimension: None, an axis name or a tuple of names


def dp_axes(mesh, tensor_parallel: bool = True) -> Tuple[str, ...]:
    """Data-parallel axes: ("pod", "data") on the multi-pod mesh; with
    tensor parallelism off, the model axis joins the DP/FSDP group (the
    ZeRO layout of models too small to shard over 16)."""
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return dp if tensor_parallel else dp + (TP,)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def entry_axes(axis) -> Tuple[str, ...]:
    """The axis names of one spec entry, major to minor."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def fit_spec(shape: tuple, spec: Spec, mesh) -> Spec:
    """Drop mesh axes that do not evenly divide their dimension. A tuple
    entry (a merged DP group) tries its suffixes first: a batch of 256 on
    the 512-rank ("pod", "data", "model") group falls back to ("data",
    "model") instead of replicating."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries):
        if isinstance(axis, (tuple, list)):
            fitted = None
            for i in range(len(axis)):
                cand = tuple(axis[i:])
                if dim > 0 and dim % _axis_size(mesh, cand) == 0:
                    fitted = cand if len(cand) > 1 else cand[0]
                    break
            out.append(fitted)
        elif axis is not None and dim > 0 and \
                dim % _axis_size(mesh, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


def _rules(dp) -> Dict[str, Spec]:
    """Parameter name -> base spec (dp: the FSDP axes tuple)."""
    col = (dp, TP)         # column-parallel: [d_in, d_out-sharded]
    row = (TP, dp)         # row-parallel:    [d_in-sharded, d_out]
    return {
        "embed": (TP, dp),           # [vocab, d]
        "lm_head": col,              # [d, vocab]
        # attention
        "wq": col, "wk": col, "wv": col, "wo": row,
        # ffn
        "w_up": col, "w_gate": col, "w_down": row,
        # moe experts get 4-D handling below; router:
        "router": (dp, None),
        "sh_up": (None, dp, TP), "sh_gate": (None, dp, TP),
        "sh_down": (None, TP, dp),
        # mla
        "w_dkv": (dp, None), "w_uk": (None, TP), "w_uv": (None, TP),
        # rwkv
        "w_r": col, "w_k": col, "w_v": col, "w_g": col, "w_o": row,
        "w_ck": col, "w_cr": col, "w_cv": row,
        "w_A": (dp, None), "w_B": (None, dp),
        # rg-lru
        "w_y": col, "w_x": col, "w_a": (TP, None), "w_i": (TP, None),
        "w_out": row, "conv_k": (None, TP),
    }


EXPERT_KEYS = ("w_up", "w_gate", "w_down")


def _param_rules(dp, tensor_parallel: bool) -> Dict[str, Spec]:
    rules = _rules(dp)
    if not tensor_parallel:  # ZeRO: shard the first dim over everything
        rules = {k: (dp,) if len(v) and v[0] is not None else
                 ((None, dp) if len(v) > 1 else (dp,))
                 for k, v in rules.items()}
        rules["embed"] = (dp,)
        rules["lm_head"] = (dp,)
    return rules


def leaf_spec(path: tuple, shape: tuple, mesh,
              tensor_parallel: bool = True) -> Spec:
    """The fitted spec of one leaf, from the names on its tree path."""
    dp = dp_axes(mesh, tensor_parallel)
    rules = _param_rules(dp, tensor_parallel)
    names = [k for k in path if isinstance(k, str)]
    name = names[-1] if names else None
    is_scale = False
    if name in ("q", "s") and len(names) >= 2:   # pre-quantized weight
        is_scale = name == "s"
        name = names[-2]
    base = rules.get(name)
    if is_scale and base is not None:
        # per-output-channel scales [*, d_out]: keep only d_out's axis
        base = (base[-1],) if len(base) else ()
    nd = len(shape)
    if base is None:
        base = ()               # norms, scalars, vectors: replicate
    elif name in EXPERT_KEYS and nd == 4:
        # stacked MoE experts [L, E, din, dout]: EP over model + FSDP over
        # din (3-D w_up/w_gate/w_down are stacked dense FFNs [L, din,
        # dout] and take the layer rule below)
        base = (None, TP, dp, None)
    elif nd == len(base) + 1:
        base = (None, *base)    # stacked layers: leading L dim
    return fit_spec(tuple(shape), base, mesh)


def model_split(path: tuple, spec: Spec, cfg, m: int) -> bool:
    """Whether a train step computes the leaf at `path` (its fitted
    `spec`, a config `cfg`, a model axis of m ranks) on its block over
    "model", or makes it whole. A pure function of names and shapes, never
    of data, so every rank runs the same collectives. The spec must keep
    "model" (a bare entry; `fit_spec` drops it where it does not divide),
    and attention splits on whole heads only, as the reference's
    `constrain_heads` pins them: q, `wo` and MLA's `w_uk` / `w_uv` where
    m divides the heads, k and v where it also divides the KV heads (else
    computed whole, each rank reading the KV heads its q heads need: MQA,
    or tinyllama's 4 at m 16; `fit_spec` alone would split granite's
    `wk` [6144, 128] inside its one head), RWKV's time mix where m divides
    its d_model / head_size heads. Every other leaf with "model" in its
    spec splits on that dimension: the vocabulary (`embed`, `lm_head`),
    the FFN's and the shared experts' F, the routed banks' E, RWKV's
    channel mix, the RG-LRU's width. A column leaf and the row leaf that
    consumes its output split the same dimension, so they split together
    or not at all."""
    if m <= 1 or TP not in spec:
        return False
    names = [k for k in path if isinstance(k, str)]
    name = names[-1] if names else None
    if "moe" in names:
        return True
    heads = cfg.n_heads % m == 0
    if name in ("wq", "wo", "w_uk", "w_uv"):
        return heads
    if name in ("wk", "wv"):
        return heads and cfg.n_kv_heads % m == 0
    if name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        return (cfg.d_model // cfg.head_size) % m == 0
    return True


def param_pspecs(params: Any, mesh, tensor_parallel: bool = True
                 ) -> Dict[str, Spec]:
    """{leaf key: spec} of a parameter tree (tensors, on the meta device
    for a shape tree), in the JAX package's leaf order; a leaf's key is
    `tree.path_key` of its path, as in checkpoints."""
    return {T.path_key(path): leaf_spec(path, tuple(leaf.shape), mesh,
                                        tensor_parallel)
            for path, leaf in T.flatten_with_path(params)}


def batch_pspecs(batch: Dict[str, Any], mesh, tensor_parallel: bool = True
                 ) -> Dict[str, Spec]:
    """Batch dim over all data axes; sequence unsharded at input."""
    dp = dp_axes(mesh, tensor_parallel)
    return {k: fit_spec(tuple(v.shape), (dp,), mesh)
            for k, v in batch.items()}


def cache_leaves(caches: Any) -> List[Tuple[tuple, torch.Tensor]]:
    """[(path, tensor)] of a list of layer caches (`Model.init_cache`): the
    layer's index, then the dataclass field names down to each tensor, in
    field order; None and fields that are not tensors (a plane's layout,
    codec, tile) hold no leaf, as in the reference's pytree."""
    out: List[Tuple[tuple, torch.Tensor]] = []

    def walk(node, path):
        if torch.is_tensor(node):
            out.append((path, node))
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), path + (f.name,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
    walk(list(caches), ())
    return out


def cache_pspecs(caches: Any, model, mesh, tensor_parallel: bool = True
                 ) -> Dict[str, Spec]:
    """{leaf key: spec} of the decode caches (`cache_leaves`, keys joined
    as `tree.path_key`): the reference's rule, whose leaves carry a
    leading stacked layer axis left whole, so a port leaf's spec is the
    reference's without its first entry. Batch (dim 0) over dp; with
    tensor parallelism a KV time axis (dim 1 of [B, T, KV, hd] or MLA's
    [B, T, r]) over the model axis, flash-decoding style, falling back to
    the last dim (a recurrent state's width), then batch only, where the
    axis does not divide; 0-d positions replicated. `model` is unused,
    as in the reference."""
    dp = dp_axes(mesh, tensor_parallel)

    def spec_for(shape: tuple) -> Spec:
        nd = len(shape)
        if nd == 0:               # per-layer scalars (pos counters)
            return ()
        entries: list = [None] * nd
        entries[0] = dp
        if tensor_parallel and nd >= 3:
            entries[1] = TP                       # sequence axis
            spec = fit_spec(shape, tuple(entries), mesh)
            if spec[1] is not None:
                return spec
            entries[1] = None
        if tensor_parallel and nd >= 2:
            entries[-1] = TP                      # state width fallback
        return fit_spec(shape, tuple(entries), mesh)

    return {T.path_key(path): spec_for(tuple(leaf.shape))
            for path, leaf in cache_leaves(caches)}


def block_bytes(leaf: torch.Tensor, spec: Spec, mesh) -> int:
    """The bytes of one rank's block of `leaf` (any device, meta too)
    under `spec` (every rank's block is the same size: `fit_spec` keeps
    only axes that divide)."""
    n = math.prod(_axis_size(mesh, entry_axes(e)) for e in spec)
    return leaf.numel() // n * leaf.element_size()


def activation_spec(mesh, sp: bool = False,
                    tensor_parallel: bool = True) -> Spec:
    """Residual-stream spec [B, T, D]: batch over dp (+ sequence over
    model when sequence parallelism is on); a one-name group is the name,
    as `PartitionSpec` keeps it."""
    dp = dp_axes(mesh, tensor_parallel)
    return (dp if len(dp) > 1 else dp[0],
            TP if (sp and tensor_parallel) else None, None)


# ---------------------------------------------------------------------
# blocks: one rank's part of a leaf
# ---------------------------------------------------------------------

def block_slices(shape: tuple, spec: Spec, mesh,
                 coord: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
    """The slices of `shape` that the rank at `coord` ({axis: index},
    default the mesh's own) holds under `spec`: a dimension over axes
    (a, b) splits into size(a) x size(b) parts, part i_a x size(b) + i_b
    at coordinates (i_a, i_b)."""
    coord = mesh.coord if coord is None else coord
    out = []
    for d, dim in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coord[a]
        step = dim // _axis_size(mesh, axes)
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_leaf(leaf: torch.Tensor, spec: Spec, mesh,
               coord: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The rank's block of `leaf`, a copy of its own (the whole leaf may
    then be freed)."""
    return leaf[block_slices(tuple(leaf.shape), spec, mesh, coord)].clone()


def shard_tree(tree: Any, specs: Dict[str, Spec], mesh,
               coord: Optional[Dict[str, int]] = None) -> Any:
    """The rank's block of every leaf of `tree` (keys as `param_pspecs`
    gives them; the reference's `launch/train.py::shard_tree`)."""
    return T.unflatten(tree, [shard_leaf(leaf, specs[T.path_key(path)],
                                         mesh, coord)
                              for path, leaf in T.flatten_with_path(tree)])


def whole_shape(block_shape: tuple, spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(n * (_axis_size(mesh, entry_axes(spec[d])) if d < len(spec)
                      else 1) for d, n in enumerate(block_shape))


def unshard_leaf(block: torch.Tensor, spec: Spec, mesh,
                 site: str = "weights") -> torch.Tensor:
    """The whole leaf from the blocks of the ranks that differ from this
    one on `spec`'s axes; every rank of the mesh calls it, in the same
    order. Each axis, minor to major, widens the block by its size: the
    parts of the axis's group are gathered in coordinate order and laid
    side by side along the dimension (a copy: the whole equals the blocks
    bit for bit)."""
    from repro_torch.distributed import comm
    x = block
    for d in range(len(spec)):
        for a in reversed(entry_axes(spec[d])):
            if mesh.shape[a] == 1:
                continue
            parts = comm.all_gather(x.contiguous(), mesh.group(a), site=site)
            x = torch.cat(parts, d)
    return x


def owns_block(spec: Spec, mesh) -> bool:
    """True on exactly one rank of each set that holds the same block:
    the one at coordinate 0 on every axis the spec does not use (a sum
    over the mesh counts each block once)."""
    used = {a for e in spec for a in entry_axes(e)}
    return all(mesh.coord[a] == 0 for a in mesh.axis_names if a not in used)


# ---------------------------------------------------------------------
# serving: the tensor-parallel paged cache
# ---------------------------------------------------------------------

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
