"""Port parity, the training step: `Model.loss` and its gradients (remat,
chunked loss, tiled attention) and `build_train_step` (accumulation,
compression, AdamW), against the JAX package on the same numpy tokens.
The models are the reduced tinyllama (2 layers, d_model 128) in f32,
with the JAX parameters carried across by `interop.params_from_jax`.

Tolerances, with their reasons:
- the loss: 1e-6 relative; its gradients: 1e-5 of each leaf's largest
  |g| (XLA and PyTorch sum matmuls and norms in other orders; measured
  ≤ 1.1e-6).
- remat on against off: exact (it only changes what the backward keeps).
- 3 train steps: losses and grad norms 1e-5 relative; parameters to
  `chip_smoke.train_params_close` (Adam's sign-like first steps let an
  element whose gradient sits near 0, or whose compressed code sits at a
  rounding boundary, part by up to 2 lr a step; measured at most 0.68 of
  the summed learning rates, and 1e-4 of the elements beyond 1e-5).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jcfg_reduced
from repro.distributed.collectives import GradCompressor as JComp
from repro.distributed.sharding import set_activation_spec
from repro.launch.train import build_train_step as jbuild
from repro.models.model import Model as JModel
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine
from repro_torch import tree as T
from repro_torch.configs import get_reduced_config as tcfg_reduced
from repro_torch.distributed.collectives import GradCompressor as TComp
from repro_torch.interop import params_from_jax
from repro_torch.launch.train import build_train_step as tbuild
from repro_torch.launch.train import value_and_grad
from repro_torch.models.model import Model as TModel
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.adamw import cosine_schedule as tcosine

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


@pytest.fixture(scope="module", autouse=True)
def _no_activation_spec():
    """A training test of the JAX package earlier in the same worker may
    leave its module-global activation spec set; these runs are
    unsharded."""
    set_activation_spec(None)
    yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(**kw):
    jc = jcfg_reduced("tinyllama-1.1b").replace(dtype=jnp.float32, **kw)
    tc = tcfg_reduced("tinyllama-1.1b").replace(dtype=torch.float32, **kw)
    jm = JModel(jc)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, TModel(tc, device="cpu"), params_from_jax(_np(jp))


def _batch(rng, vocab, B, S):
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("logit_chunk,attn_chunk", [(0, 64), (8, 8)])
def test_loss_and_grads_match_reference(logit_chunk, attn_chunk):
    """`Model.loss` and its gradients against `jax.value_and_grad` of the
    JAX model's loss (remat on in both), unchunked and with the vocab
    projection in chunks of 8 and flash attention in 8 x 8 tiles; one
    label ignored."""
    jm, jp, tm, tp = _pair(logit_chunk=logit_chunk, attn_chunk=attn_chunk)
    batch = _batch(np.random.default_rng(0), jm.cfg.vocab_size, 2, 32)
    batch["labels"][0, 5] = -1
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    tl, tmet, tg = value_and_grad(lambda p: tm.loss(p, batch), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["lm_loss"]), float(jmet["lm_loss"]),
                               rtol=1e-6)
    assert float(tmet["lb_loss"]) == float(tmet["z_loss"]) == 0.0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            T.leaves(tg)):
        a = np.asarray(a)
        err = np.abs(a - b.numpy()).max() / np.abs(a).max()
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)


def test_remat_keeps_values_and_grads():
    """cfg.remat only changes what the backward keeps: the same loss and
    gradients, bit for bit, with and without it."""
    _, _, tm, tp = _pair()
    tm_off = TModel(tm.cfg.replace(remat=False), device="cpu")
    batch = _batch(np.random.default_rng(4), tm.cfg.vocab_size, 2, 16)
    l1, _, g1 = value_and_grad(lambda p: tm.loss(p, batch), tp)
    l2, _, g2 = value_and_grad(lambda p: tm_off.loss(p, batch), tp)
    assert float(l1) == float(l2)
    for a, b in zip(T.leaves(g1), T.leaves(g2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(compress, accum):
    """3 steps of `build_train_step` (accumulation over `accum`
    microbatches, optional error-feedback compression, AdamW with a
    warmup-1 cosine schedule) against the jitted JAX step on the same
    batches of 4 x 16 tokens; attention in 8 x 8 tiles."""
    jm, jp, tm, tp = _pair(attn_chunk=8)
    rng = np.random.default_rng(5)
    batches = [_batch(rng, jm.cfg.vocab_size, 4, 16) for _ in range(3)]
    jo, to = JAdamW(lr=jcosine(1e-3, 1, 3)), TAdamW(lr=tcosine(1e-3, 1, 3))
    jstep = jax.jit(jbuild(jm, jo, JComp() if compress else None, accum))
    tstep = tbuild(tm, to, TComp() if compress else None, accum)
    js, ts = jo.init(jp), to.init(tp)
    jcs = JComp().init(jp) if compress else None
    tcs = TComp().init(tp) if compress else None
    lr_sum = 0.0
    for b in batches:
        jp, js, jcs, jmet = jstep(jp, js, jcs, jax.tree.map(jnp.asarray, b))
        tp, ts, tcs, tmet = tstep(tp, ts, tcs, b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, err_msg=k)
        lr_sum += float(tmet["lr"])
    _chip_smoke().train_params_close(jax.tree.leaves(jp), T.leaves(tp),
                                     lr_sum, f"accum {accum}")
    assert int(ts.count) == 3
