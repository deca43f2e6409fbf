"""Port parity, the paper's CNN float trainer:
`repro_torch.launch.cnn_train.train_cnn` against a replica of the
reference's `benchmarks/common.py::train_cnn` loop built from `repro`
primitives (`cnn.loss_fn`, `AdamW`, `cosine_schedule`, `prune_2_4`,
`recalibrate_bn`) on the same numpy batches (drawn by the JAX package)
and the same initial parameters (the port's seeded init, as numpy). The
reference function itself trains 420 steps and caches into
`benchmarks/.cache`, so it is not called. The network is the trainer's
default (width 24, stages (1, 1, 1), 8 classes, 24 x 24), batches of 16.

Tolerances, with their reasons:
- losses: 1e-4 relative (XLA's and PyTorch's convolutions sum in other
  orders; measured 4e-6 over 4 steps).
- trained parameters: `chip_smoke.train_params_close` (Adam's
  sign-like first steps let an element whose gradient sits near 0 part by
  up to 2 lr a step; BatchNorm makes such elements common: measured 0.19
  of the summed learning rates and 0.4% of the elements beyond 1e-5).
- BatchNorm running statistics, set after training from the last
  batches: 1e-3 of each statistic's largest magnitude (they inherit the
  parameters' differences; measured 2e-4).
- 2:4 masks: equal (a near-tie in magnitude could flip one; none do on
  these inputs).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pruning import prune_2_4 as jprune
from repro.models import cnn as jcnn
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine
from repro_torch import tree as T
from repro_torch.core.pruning import sparsity
from repro_torch.launch import cnn_train as ct
from repro_torch.models import cnn as tcnn

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small tensors: with several
    test workers on the machine, idle OpenMP threads spinning between
    small ops would take the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_train(params, batches, steps, prune, cfg):
    """The reference's train_cnn loop, from its primitives."""
    opt = JAdamW(lr=jcosine(3e-3, 20, steps), weight_decay=1e-4)
    state = opt.init(params)

    def apply_prune(p):
        def prune_leaf(path, leaf):
            if leaf.ndim == 4 and "stem" not in str(path):
                w2 = leaf.reshape(-1, leaf.shape[-1])
                return jprune(w2, axis=0).reshape(leaf.shape)
            return leaf
        return jax.tree_util.tree_map_with_path(prune_leaf, p)

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jcnn.loss_fn(p, batch, cfg))(params)
        params, state, _ = opt.update(grads, state, params)
        return params, state, loss

    losses = []
    for i in range(steps):
        params, state, loss = step(params, state,
                                   jax.tree.map(jnp.asarray, batches[i]))
        losses.append(float(loss))
        if prune and i >= steps // 4:
            params = apply_prune(params)
    params = jcnn.recalibrate_bn(
        params, [jax.tree.map(jnp.asarray, b) for b in batches[steps:]], cfg)
    if prune:
        params = apply_prune(params)
    lr_sum = sum(float(opt.lr(jnp.int32(c))) for c in range(1, steps + 1))
    return params, losses, lr_sum


@pytest.mark.parametrize("steps,prune", [(4, True), (3, False)])
def test_train_cnn_matches_reference(steps, prune):
    cfg = ct.default_config()
    data = jax.jit(jcnn.synthetic_dataset, static_argnums=(1, 2))
    batches = [jax.tree.map(np.asarray, data(jax.random.PRNGKey(100 + i),
                                             cfg, B))
               for i in range(steps + 2)]
    port = ct.train_cnn(cfg, steps=steps, prune_2_4=prune, batches=batches,
                        device="cpu")
    init = tcnn.init_params(torch.Generator().manual_seed(ct.SEED), cfg,
                            "cpu")
    ref, losses, lr_sum = _reference_train(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), init), batches,
        steps, prune, cfg)
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-4)

    trained = ([], [])
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            T.leaves(port["params"])):
        key = jax.tree_util.keystr(path)
        a, b = np.asarray(a), b.numpy()
        if key.endswith("['mean']") or key.endswith("['var']"):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-3 * np.abs(a).max(),
                                       err_msg=key)
            continue
        trained[0].append(a)
        trained[1].append(b)
        if a.ndim == 4:
            np.testing.assert_array_equal(b == 0, a == 0, err_msg=key)
            pruned = prune and "stem" not in key
            assert (sparsity(torch.from_numpy(b).reshape(-1, b.shape[-1]))
                    == 0.5) == pruned, key
    _chip_smoke().train_params_close(*trained, lr_sum, "cnn trainer")


def test_train_cnn_draws_seeded_data_and_writes_nothing(tmp_path,
                                                        monkeypatch):
    """Without `batches`, the data come from seeded generators: two runs
    are equal, another seed differs; nothing is written to disk."""
    monkeypatch.chdir(tmp_path)
    cfg = tcnn.CNNConfig(width=8, stages=(1, 1), num_classes=4, img_size=8)
    a = ct.train_cnn(cfg, steps=2, device="cpu")
    b = ct.train_cnn(cfg, steps=2, device="cpu")
    c = ct.train_cnn(cfg, steps=2, seed=7, device="cpu")
    assert a["losses"] == b["losses"] != c["losses"]
    for x, y in zip(T.leaves(a["params"]), T.leaves(b["params"])):
        assert torch.equal(x, y)
    assert len(a["losses"]) == 2 and a["cfg"] == cfg
    assert list(tmp_path.iterdir()) == []
    assert ct.default_config() == tcnn.CNNConfig(
        width=24, stages=(1, 1, 1), num_classes=8, img_size=24)


def test_train_cnn_needs_a_device_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct.train_cnn(steps=1)
