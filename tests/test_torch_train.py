"""Port parity, the training path's pieces: the parameter tree's leaf
order, AdamW and its cosine schedule, and SPARQ gradient compression,
against the JAX package on the same numpy trees (`test_torch_train_step.py`
holds the loss, its gradients and the train step).

Tolerances, with their reasons:
- the compressor's outputs and residuals over 3 steps: exact. Both run
  the same f32 ops in the same order on the same leaves; JAX eagerly
  (under `jax.jit`, XLA turns the division by the constant 127 into a
  multiply by its reciprocal).
- AdamW over 3 updates: the grad norm within 1e-6 relative (the per-leaf
  sums run in XLA's and PyTorch's own reduction orders), params, m and v
  within 1e-6 of each leaf's largest magnitude (PyTorch's CPU sqrt rounds
  0.7% of f32 values an ulp away from the correctly rounded root that
  XLA and numpy give; CUDA's is correctly rounded), the lr exact.
- the cosine schedule: within one f32 ulp of the peak rate (XLA's cos
  and PyTorch's round differently; 16 of the first 431 counts differ, by
  at most that), the warmup exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.collectives import GradCompressor as JComp
from repro.distributed.collectives import sparq_compress as jcompress
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine
from repro_torch import tree as T
from repro_torch.distributed.collectives import GradCompressor as TComp
from repro_torch.distributed.collectives import sparq_compress as tcompress
from repro_torch.interop import to_torch
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.adamw import cosine_schedule as tcosine


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small tensors: with several
    test workers on the machine, idle OpenMP threads spinning between
    small ops would take the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng):
    """A tree whose dict insertion order is not its sorted order, with a
    list, a nested dict and leaves of several shapes."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"z": f(7, 5), "a": [f(3), {"y": f(4, 4), "b": f(2)}],
            "m": {"k": f(6, 3)}}


def test_leaf_order_is_jax_order():
    tree = _tree(np.random.default_rng(0))
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(tree)[0]]
    tpaths = ["".join(f"[{k!r}]" for k in p)
              for p, _ in T.flatten_with_path(tree)]
    assert tpaths == jpaths
    for a, b in zip(jax.tree.leaves(tree), T.leaves(tree)):
        assert a is b
    back = T.unflatten(tree, T.leaves(tree))
    assert list(back) == list(tree) and back["a"][1]["y"] is tree["a"][1]["y"]


@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("sched", [True, False])
def test_adamw_matches_reference(clip, sched):
    """3 updates of a random tree (clipped and not, scheduled and constant
    lr, weight decay on every leaf)."""
    rng = np.random.default_rng(1)
    p = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jo = JAdamW(lr=jcosine(1e-2, 2, 5) if sched else 1e-2, clip_norm=clip)
    to = TAdamW(lr=tcosine(1e-2, 2, 5) if sched else 1e-2, clip_norm=clip)
    jp, tp = jax.tree.map(jnp.asarray, p), to_torch(p)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = to.update(to_torch(g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(jm["grad_norm"]) < clip or clip == 1.0
        assert float(jm["lr"]) == float(tm["lr"])
    for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for a, b in zip(jax.tree.leaves(jt), T.leaves(tt)):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())
    assert int(js.count) == int(ts.count) == 3
    assert ts.count.dtype == torch.int32


def test_cosine_schedule_within_one_ulp():
    jl, tl = jcosine(3e-3, 20, 420), tcosine(3e-3, 20, 420)
    counts = range(0, 431)
    a = np.array([np.float32(jl(jnp.int32(c))) for c in counts])
    b = np.array([np.float32(tl(torch.tensor(c, dtype=torch.int32)))
                  for c in counts])
    np.testing.assert_allclose(b, a, rtol=0,
                               atol=np.spacing(np.float32(3e-3)))
    np.testing.assert_array_equal(a[:20], b[:20])      # warmup: exact
    assert tl(torch.tensor(5)).dtype == torch.float32


def test_sparq_compress_bitwise():
    """One tensor at a time: a wide dynamic range, a tiny one, all zeros
    (the 1e-20 floor of the scale), and every int8 code -127..127 with
    ties at the rounding boundary (each entry of the port's lookup table,
    at 4, 3 and 2 bits)."""
    rng = np.random.default_rng(2)
    cases = [
        (rng.standard_normal((64, 96)) *
         np.exp(2 * rng.standard_normal((64, 96)))).astype(np.float32),
        (rng.standard_normal((300,)) * 1e-6).astype(np.float32),
        np.zeros((5, 7), np.float32),
        (np.arange(-254, 255, dtype=np.float32) / 2),
    ]
    every_code = cases[-1]
    for g, bits in [*zip(cases, (4, 3, 4, 4)), (every_code, 3),
                    (every_code, 2)]:
        want = np.asarray(jcompress(jnp.asarray(g), bits))
        got = tcompress(torch.from_numpy(g), bits).numpy()
        np.testing.assert_array_equal(got, want)


def test_grad_compressor_bitwise():
    """3 steps of error feedback on a tree with a leaf under min_size
    (passed through exactly, its residual zeroed): outputs and residuals
    exact."""
    rng = np.random.default_rng(3)

    def grads():
        return {"w": (rng.standard_normal((128, 64)) * 1e-3
                      ).astype(np.float32),
                "norm": {"scale": rng.standard_normal((100,)
                                                      ).astype(np.float32)},
                "e": [rng.standard_normal((80, 60)).astype(np.float32)]}
    gs = [grads() for _ in range(3)]
    jc, tc = JComp(), TComp()
    js = jc.init(jax.tree.map(jnp.asarray, gs[0]))
    ts = tc.init(to_torch(gs[0]))
    for g in gs:
        jo, js = jc.compress(jax.tree.map(jnp.asarray, g), js)
        to, ts = tc.compress(to_torch(g), ts)
        for a, b in zip(jax.tree.leaves((jo, js)), T.leaves((to, ts))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(to["norm"]["scale"].numpy(),
                                  gs[-1]["norm"]["scale"])
    assert not ts["norm"]["scale"].any() and ts["w"].abs().max() > 0
