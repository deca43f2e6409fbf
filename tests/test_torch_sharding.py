"""Port parity, the training sharding rules (`repro_torch.distributed.
sharding`) against the reference's (`repro.distributed.sharding`).

- `param_pspecs` and `batch_pspecs` for every arch of the reference's
  ARCHS at full width, leaf by leaf in JAX leaf order, on five meshes,
  with tensor parallelism on and off. JAX's shapes come from
  `jax.eval_shape`, the port's from the meta device: nothing of full
  width is allocated. The meshes are duck-typed (`fit_spec` reads only
  `mesh.shape`, `dp_axes` only `mesh.axis_names`).
- `fit_spec` on the grid of `tests/test_sharding.py::TestFitSpec`.
- Block layout: `block_slices` against `NamedSharding.devices_indices_map`
  on a forced 8-device host (a subprocess), merged axis tuples among the
  specs; `shard_tree` covers every element once over the mesh.
Tolerance: exact everywhere (specs and slices are integers and names).
The collectives and `unshard_leaf` run over gloo ranks in
`tests/test_torch_train_sharded.py`.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from typing import Dict, Optional, Tuple

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ARCHS
from repro.configs.base import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.models.model import Model as JModel
from repro_torch import tree as T
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed import sharding as tshd
from repro_torch.models.model import Model as TModel


@dataclasses.dataclass
class FakeMesh:
    """The fields the spec functions read (`coord`: a rank's coordinate,
    read by `owns_block`)."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    coord: Optional[Dict[str, int]] = None


def _mesh(**shape):
    return FakeMesh(dict(shape), tuple(shape))


MESHES = {
    "16x16": _mesh(data=16, model=16),
    "2x16x16": _mesh(pod=2, data=16, model=16),
    "2x2": _mesh(data=2, model=2),
    "4x1": _mesh(data=4, model=1),
    "1x4": _mesh(data=1, model=4),
}


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_specs(tree_of_specs):
    flat = jax.tree_util.tree_flatten_with_path(
        tree_of_specs, is_leaf=lambda x: isinstance(x, P))[0]
    return [(_key(path), tuple(s)) for path, s in flat]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch):
    """Every leaf's spec, on five meshes, tensor parallelism on and off."""
    jm = JModel(jget_config(arch))
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    meta = TModel(tget_config(arch), device="meta").init_params(
        dtype=torch.float32)
    jshapes = [tuple(x.shape) for x in jax.tree.leaves(shapes)]
    assert jshapes == [tuple(x.shape) for x in T.leaves(meta)]
    for name, mesh in MESHES.items():
        for tp in (True, False):
            want = _jax_specs(jshd.param_pspecs(shapes, mesh, tp))
            got = list(tshd.param_pspecs(meta, mesh, tp).items())
            assert got == want, (name, tp)


@pytest.mark.parametrize("batch", [8, 6, 256, 512, 32])
def test_batch_pspecs_match_reference(batch):
    """Token, label and front-end leaves of a batch; the merged dp tuple
    falls back suffix by suffix where the batch does not divide."""
    leaves = {"tokens": np.zeros((batch, 128), np.int32),
              "labels": np.zeros((batch, 128), np.int32),
              "frames": np.zeros((batch, 16, 8), np.float32)}
    for name, mesh in MESHES.items():
        for tp in (True, False):
            want = {k: tuple(v) for k, v in
                    jshd.batch_pspecs(leaves, mesh, tp).items()}
            assert tshd.batch_pspecs(leaves, mesh, tp) == want, (name, tp)
            assert tshd.activation_spec(mesh, True, tp) == \
                tuple(jshd.activation_spec(mesh, True, tp))


FIT_MESH = _mesh(pod=2, data=8, model=16)


@pytest.mark.parametrize("shape,spec,want", [
    ((256, 1024), ("data", "model"), ("data", "model")),
    ((51865, 768), ("model", "data"), (None, "data")),
    ((7, 9), ("data", "model"), (None, None)),
    ((64, 100, 32), ("data", None, "model"), ("data", None, "model")),
    ((64, 32, 16, 8), ("data",), ("data", None, None, None)),
    ((3, 4, 5), (), (None, None, None)),
    ((0, 64), ("data", "model"), (None, "model")),
])
def test_fit_spec_grid(shape, spec, want):
    """`TestFitSpec`'s axis-dropping grid and its edges."""
    assert tshd.fit_spec(shape, spec, FIT_MESH) == want
    assert tshd.fit_spec(shape, spec, FIT_MESH) == \
        tuple(jshd.fit_spec(shape, P(*spec), FIT_MESH))


@pytest.mark.parametrize("dim,want", [
    (512, ("pod", "data", "model")), (256, ("pod", "data", "model")),
    (128, ("data", "model")), (16, "model"), (8, None)])
def test_fit_spec_tuple_suffix_fallback(dim, want):
    """Merged dp groups degrade suffix by suffix; a one-name suffix is
    unwrapped."""
    got = tshd.fit_spec((dim, 64), (("pod", "data", "model"), None),
                        FIT_MESH)
    assert got == (want, None)


LAYOUT_CASES = [
    ((8, 4), (("pod", "data"), "model")),
    ((8, 6), (("data", "model"), None)),
    ((4, 8), ("model", ("pod", "data"))),
    ((16, 3), (("pod", "data", "model"), None)),
    ((8, 4), (("model", "pod"), "data")),
    ((2, 8, 4), (None, "pod", ("model", "data"))),
    ((8,), ("data",)),
]


def test_block_order_matches_named_sharding():
    """On a (pod 2, data 2, model 2) mesh of 8 forced host devices, every
    device's index map under each spec equals `block_slices` at its
    coordinate: a merged tuple indexes major to minor in its order."""
    code = textwrap.dedent(f"""
        import json
        import jax
        import numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
        mesh = Mesh(devs, ("pod", "data", "model"))
        out = []
        for shape, spec in {LAYOUT_CASES!r}:
            m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
            rows = []
            for dev, idx in m.items():
                coord = [int(c) for c in np.argwhere(devs == dev)[0]]
                rows.append([coord, [[s.indices(n)[0], s.indices(n)[1]]
                                     for s, n in zip(idx, shape)]])
            out.append(rows)
        print(json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    maps = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = _mesh(pod=2, data=2, model=2)
    for (shape, spec), rows in zip(LAYOUT_CASES, maps):
        assert len(rows) == 8
        for coord, want in rows:
            got = tshd.block_slices(shape, spec, mesh,
                                    dict(zip(mesh.axis_names, coord)))
            assert [[s.start, s.stop] for s in got] == want, (spec, coord)


def test_shard_tree_covers_every_element_once():
    """The blocks of every rank of a (data 2, model 2) mesh, put back at
    their slices, rebuild each leaf; a block replicated over an axis its
    spec does not use is owned (`owns_block`) by exactly one rank."""
    mesh = _mesh(data=2, model=2)
    tree = {"embed": torch.arange(32.).reshape(8, 4),
            "blocks": [{"attn": {"wq": torch.arange(64.).reshape(2, 4, 8)}}],
            "final_norm": {"scale": torch.arange(4.)}}
    specs = {"embed": ("model", "data"), "blocks/0/attn/wq":
             (None, ("data", "model"), None), "final_norm/scale": (None,)}
    whole = {T.path_key(p): torch.zeros_like(v)
             for p, v in T.flatten_with_path(tree)}
    hits = {k: torch.zeros_like(v) for k, v in whole.items()}
    owners = {k: 0 for k in specs}
    for d in range(2):
        for m in range(2):
            coord = {"data": d, "model": m}
            blocks = tshd.shard_tree(tree, specs, mesh, coord)
            for path, b in T.flatten_with_path(blocks):
                k = T.path_key(path)
                sl = tshd.block_slices(tuple(whole[k].shape), specs[k], mesh,
                                       coord)
                whole[k][sl] = b
                hits[k][sl] += 1
                owners[k] += tshd.owns_block(specs[k], FakeMesh(
                    mesh.shape, mesh.axis_names, coord))
    for path, leaf in T.flatten_with_path(tree):
        k = T.path_key(path)
        assert torch.equal(whole[k], leaf)
    # wq and embed split four ways: each element once; the norm whole on
    # every rank
    assert int(hits["blocks/0/attn/wq"].max()) == 1
    assert int(hits["embed"].max()) == 1
    assert int(hits["final_norm/scale"].min()) == 4
    assert owners == {"embed": 4, "blocks/0/attn/wq": 4,
                      "final_norm/scale": 1}



# the leaves whose products split together over the model axis (a column
# leaf and the row leaf that consumes its output), by the last name on
# their path
SPLIT_TOGETHER = ({"wq", "wo", "w_uk", "w_uv"}, {"wk", "wv"},
                  {"w_up", "w_gate", "w_down"}, {"sh_up", "sh_gate",
                                                 "sh_down"},
                  {"w_r", "w_k", "w_v", "w_g", "w_o"}, {"w_ck", "w_cv"},
                  {"w_x", "w_y", "w_a", "w_i", "conv_k", "w_out"})


def _head_width(cfg, name):
    """The width of one head along a head-split leaf's model dimension."""
    if cfg.kv_lora_rank:
        return {"wq": cfg.qk_nope_dim + cfg.qk_rope_dim,
                "w_uk": cfg.qk_nope_dim, "w_uv": cfg.v_head_dim,
                "wo": cfg.v_head_dim}.get(name)
    if cfg.family == "rwkv6":
        return cfg.head_size if name in ("w_r", "w_k", "w_v", "w_g",
                                         "w_o") else None
    return cfg.head_dim if name in ("wq", "wk", "wv", "wo") else None


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_split_rule(arch, m):
    """`model_split` on every published config's leaves (shapes from the
    meta device) at a model axis of 2 and 16: a split leaf keeps "model"
    in its fitted spec and its block ends on a head boundary (no split
    inside a head, the reference's `constrain_heads` rule), k / v split
    only with the KV heads; a column leaf and its row leaf split together
    within a layer. MQA's k / v (granite-20b, paligemma-3b,
    recurrentgemma-9b) and whisper's 51865-row vocabulary stay whole;
    tinyllama at 16 splits q (32 heads) but not k / v (4 KV heads); the
    routed expert banks split on E."""
    cfg = tget_config(arch)
    mesh = _mesh(data=2, model=m)
    meta = TModel(cfg, device="meta").init_params(dtype=torch.float32)
    specs = tshd.param_pspecs(meta, mesh)
    split = {}
    for path, leaf in T.flatten_with_path(meta):
        key = T.path_key(path)
        spec = specs[key]
        split[key] = tshd.model_split(path, spec, cfg, m)
        if not split[key]:
            continue
        d = spec.index(tshd.TP)
        part = leaf.shape[d] // m
        assert part * m == leaf.shape[d], key
        width = _head_width(cfg, path[-1])
        if width is not None:
            assert part % width == 0, (key, part, width)
        if path[-1] in ("wk", "wv"):
            assert cfg.n_kv_heads % m == 0, key
    layers = {}
    for key, s in split.items():
        *prefix, name = key.split("/")
        for group in SPLIT_TOGETHER:
            if name in group:
                layers.setdefault(("/".join(prefix), min(group)),
                                  set()).add(s)
    assert all(len(v) == 1 for v in layers.values()), layers

    def keys(name):
        return [k for k in split if k.split("/")[-1] == name]
    if cfg.n_kv_heads == 1:
        assert keys("wk") and not any(split[k] for k in keys("wk") +
                                      keys("wv")), arch
    if arch == "whisper-base":
        assert not split["embed"]
    if arch == "tinyllama-1.1b" and m == 16:
        assert all(split[k] for k in keys("wq"))
        assert not any(split[k] for k in keys("wk") + keys("wv"))
    if arch == "granite-20b":
        # fit_spec alone keeps "model" on wk [6144, 128]: inside its head
        assert all(tshd.TP in specs[k] for k in keys("wk"))
    if cfg.n_experts and cfg.n_experts % m == 0:
        banks = [k for k in split if "/moe/w_" in k]
        assert banks and all(split[k] for k in banks), arch
