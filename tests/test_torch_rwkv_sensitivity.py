"""Reduced rwkv6's training amplifies rounding in the JAX package as in
the port: both trainers run 3 steps (`build_train_step`, AdamW with the
sharded tests' schedule, batch 4 x 16, f32) from JAX's init, and again
from that init with every element scaled by 1 + 1e-7 x a normal draw
(`probes/rwkv_sensitivity.py`'s perturbation). The relative move of the
step-2 and step-3 grad norms is measured in each package.

Measured on the CPU (this file's inputs): JAX 1.55e-5 and 7.3e-4, the
port 1.48e-5 and 6.6e-4; the losses move by at most 2.3e-7. The test
holds the two packages' moves within 10x of each other at steps 2 and 3
and each at least 1e-6 (a hundred times the perturbation's own size, the
amplification), which makes `LATER_NORM_TOL` in
`tests/test_torch_train_sharded.py` a property of the model, not a fault
of the port's backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jcfg
from repro.distributed.sharding import set_activation_spec
from repro.launch.train import build_train_step as jbuild
from repro.models.model import Model as JModel
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine
from repro_torch.configs import get_reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.launch.train import build_train_step
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, cosine_schedule

ARCH = "rwkv6-7b"
EPS = 1e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(vocab):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):
        toks = rng.integers(0, vocab, (4, 16)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.concatenate(
            [toks[:, 1:], np.full((4, 1), -1, np.int32)], 1)})
    return out


def _perturbed(params):
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda x: (x * (1 + EPS * rng.standard_normal(
        x.shape))).astype(x.dtype), params)


def _jax_run(jm, params, batches):
    set_activation_spec(None)
    opt = JAdamW(lr=jcosine(1e-3, 1, 3))
    step = jax.jit(jbuild(jm, opt, None, 1))
    state, out = opt.init(params), []
    for b in batches:
        params, state, _, m = step(params, state, None,
                                   jax.tree.map(jnp.asarray, b))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _port_run(params, batches):
    cfg = get_reduced_config(ARCH).replace(dtype=torch.float32,
                                           attn_chunk=8)
    model = Model(cfg, device="cpu")
    opt = AdamW(lr=cosine_schedule(1e-3, 1, 3))
    step = build_train_step(model, opt, None, 1)
    params = params_from_jax(params)
    state, out = opt.init(params), []
    for b in batches:
        params, state, _, m = step(params, state, None, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _moves(base, moved):
    return ([abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(base, moved)],
            [abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(base, moved)])


def test_jax_rwkv6_is_as_sensitive_as_the_port():
    jm = JModel(jcfg(ARCH).replace(dtype=jnp.float32, attn_chunk=8))
    p0 = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    p1 = _perturbed(p0)
    batches = _batches(jm.cfg.vocab_size)
    j_loss, j_norm = _moves(_jax_run(jm, p0, batches),
                            _jax_run(jm, p1, batches))
    t_loss, t_norm = _moves(_port_run(p0, batches), _port_run(p1, batches))
    for step in (1, 2):                  # steps 2 and 3
        assert j_norm[step] >= 100 * EPS and t_norm[step] >= 100 * EPS, \
            (j_norm, t_norm)
        assert t_norm[step] / 10 <= j_norm[step] <= 10 * t_norm[step], \
            (step + 1, j_norm, t_norm)
    assert max(j_loss + t_loss) <= 1e-6, (j_loss, t_loss)
