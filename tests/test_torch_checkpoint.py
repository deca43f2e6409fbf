"""The port's checkpoint manager against the JAX package's: the same
on-disk layout (step_%08d/, manifest.json, one .npy per leaf, keys the
tree path joined with "/"), so a checkpoint written by either package
restores in the other, bit for bit. Also the manager's own contract:
atomic writes, pruning to the newest `keep`, leaves missing on disk keep
the template's value, restore onto the device the caller names. The tree
is the reduced tinyllama's params with AdamW's m and v, as the trainers
save them. Tolerance: exact everywhere (files of f32 arrays).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import manager as jckpt
from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.models.model import Model as JModel
from repro_torch import tree as T
from repro_torch.checkpoint import manager as tckpt
from repro_torch.interop import to_torch


def _state():
    params = jax.tree.map(np.asarray, JModel(
        jcfg_reduced("tinyllama-1.1b")).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    noise = lambda t: jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), t)
    return {"params": params, "m": noise(params), "v": noise(params)}


def _zeros_like(tree):
    return T.tree_map(torch.zeros_like, to_torch(tree))


def _same(np_tree, torch_tree):
    want = jax.tree.leaves(np_tree)
    got = T.leaves(torch_tree)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a))


def test_layout_matches_reference(tmp_path):
    state = _state()
    jdir = jckpt.save(str(tmp_path / "j"), 7, jax.tree.map(jnp.asarray, state))
    tdir = tckpt.save(str(tmp_path / "t"), 7, to_torch(state))
    assert os.path.basename(jdir) == os.path.basename(tdir) == "step_00000007"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    with open(os.path.join(jdir, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tm = json.load(f)
    assert jm == tm
    assert list(jm["leaves"]) == list(tm["leaves"])       # leaf order too
    assert "params/blocks/0/attn/wq" in tm["leaves"]
    for meta in tm["leaves"].values():
        np.testing.assert_array_equal(np.load(os.path.join(jdir,
                                                           meta["file"])),
                                      np.load(os.path.join(tdir,
                                                           meta["file"])))


def test_jax_checkpoint_restores_in_port(tmp_path):
    state = _state()
    jckpt.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, state))
    assert tckpt.latest_step(str(tmp_path)) == 3
    got = tckpt.restore(str(tmp_path), 3, _zeros_like(state),
                        device=torch.device("cpu"))
    _same(state, got)


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _state()
    tckpt.save(str(tmp_path), 5, to_torch(state))
    assert jckpt.latest_step(str(tmp_path)) == 5
    template = jax.tree.map(jnp.zeros_like, state)
    got = jckpt.restore(str(tmp_path), 5, template)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a)


def test_prune_atomic_and_missing_leaves(tmp_path):
    d = str(tmp_path)
    small = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    for step in (1, 2, 3, 4):
        tckpt.save(d, step, {"w": small["w"] + step}, keep=2)
    assert tckpt.all_steps(d) == [3, 4]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    tmpl = {"w": torch.zeros(2, 3), "new": [torch.full((4,), 7.0)]}
    got = tckpt.restore(d, 4, tmpl)
    assert torch.equal(got["w"], small["w"] + 4)
    assert got["new"][0] is tmpl["new"][0]          # missing: template kept
    assert tckpt.latest_step(str(tmp_path / "none")) is None
