"""K1's tile plan and split-K on the CPU: `plan` is the pure function the
CUDA kernel's wrapper passes to the C entry point, so its K slices are
checked here, and the kernel's arithmetic under that plan (int32 partial
sums slice by slice, one f32 epilogue on their total) is emulated and held
bit for bit against the plain version and the JAX reference.

Tolerance: none. The partial sums are integers and the epilogue runs once
in the plain version's order, so every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import QScale as JQScale
from repro.core.sparq import SparqConfig as JCfg
from repro.kernels import ops as jops
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.core.sparq import sparq_recon_int
from repro_torch.kernels.ref import quantize_codes
from repro_torch.kernels.sparq_matmul import (k_slices, plan,
                                              ref_sparq_matmul)

SMS = 132
# (K, N) of the four projections of tinyllama-1.1b (chip_smoke.PROJ)
PROJ = {"wq/wo": (2048, 2048), "wk/wv": (2048, 256),
        "gate/up": (2048, 5632), "down": (5632, 2048)}
SHAPES = [(M, K, N) for M in (8, 71, 256, 445, 2048)
          for K, N in PROJ.values()]
SHAPES += [(8, 70, 256), (445, 70, 2048), (2048, 70, 256),  # ragged K
           (71, 70, 24)]                                  # and N


def _check_plan(M, K, N, sms=SMS):
    p = plan(M, N, K, sms)
    kt = -(-K // p.bk)
    assert p.bk % 2 == 0 and p.bm in (16, 64, 128)
    assert p.kp == kt * p.bk >= K
    slices = k_slices(p, K)
    assert len(slices) == p.split_k
    assert slices[0][0] == 0 and slices[-1][1] == K
    for (b0, e0), (b1, _) in zip(slices, slices[1:]):
        assert e0 == b1                     # no gap, no overlap
    for b, e in slices:
        assert b % p.bk == 0 and b < e      # whole k tiles, none empty
    tiles = -(-M // p.bm) * -(-N // p.bn)
    assert p.blocks == tiles * p.split_k
    assert p.blocks >= sms or p.split_k == kt, p
    return p


@pytest.mark.parametrize("M,K,N", SHAPES,
                         ids=[f"M{m}-K{k}-N{n}" for m, k, n in SHAPES])
def test_plan_slices_cover_k_and_fill_the_card(M, K, N):
    p = _check_plan(M, K, N)
    if M == 2048:
        assert p.split_k == 1, p            # no workspace at scan prefill
    if M <= 16:
        assert p.bm == 16


def _emulate(x, w, a, c, p, cfg):
    """The kernel's arithmetic under plan p: r once, int32 partials per K
    slice, summed, then (float(acc) * a) * c[n]."""
    q = quantize_codes(x, a, cfg.signed, cfg.max_val)
    r = sparq_recon_int(q, cfg) if cfg.enabled else q
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int32)
    for b, e in k_slices(p, x.shape[1]):
        part = r[:, b:e].to(torch.int64) @ w[b:e].to(torch.int64)
        acc += part.to(torch.int32)
    return (acc.to(torch.float32) * a) * c[None, :]


# ragged M, N and K; sms chosen so each shape splits K into several
# slices, the last one shorter
EMU_SHAPES = [(8, 1030, 48, 132), (71, 322, 40, 132), (445, 70, 24, 4096)]
CODECS = {"5opt": dict(bits=4, opts=5, signed=True),
          "a8w8": dict(enabled=False, signed=True)}


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("M,K,N,sms", EMU_SHAPES,
                         ids=[f"M{m}-K{k}-N{n}" for m, k, n, _ in EMU_SHAPES])
def test_split_k_emulation_is_bit_exact(codec, M, K, N, sms):
    p = _check_plan(M, K, N, sms)
    assert p.split_k > 1, p
    rng = np.random.default_rng(M * 1000 + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[rng.random((M, K)) < 0.3] = 0.0      # exercise the vSPARQ pair rule
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    c = (rng.random(N) * 1e-3).astype(np.float32)
    a = np.float32(np.abs(x).max()) / np.float32(127)
    tc, jc = TCfg(**CODECS[codec]), JCfg(**CODECS[codec])
    kw = dict(bits=tc.bits, opts_shifts=tc.shifts, rounding=tc.rounding,
              vsparq=tc.vsparq, signed=tc.signed, max_val=tc.max_val,
              enabled=tc.enabled)
    xt, wt, ct = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c)
    at = torch.tensor(a)
    got = _emulate(xt, wt, at, ct, p, tc).numpy()
    plain = ref_sparq_matmul(xt, wt, at, ct, **kw).numpy()
    jax_ref = np.asarray(jops.quantized_matmul(
        jnp.asarray(x), jnp.asarray(w), JQScale(jnp.float32(a), 8, True),
        jnp.asarray(c), jc, impl="reference"))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_ref)
