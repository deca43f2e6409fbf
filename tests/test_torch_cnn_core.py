"""Port parity, the core modules of the paper's CNN path: 2:4 pruning,
the sparse-tensor-core pairing, ACIQ, the float-level SPARQ products, the
quantizer's helpers and calibration, `repro_torch.core` against
`repro.core` on the same numpy inputs.

Tolerances: integer results (pruning masks, kept lanes, codes,
reconstructions) and the quantizer's divisions and roundings are exact.
Float sums are held where their order differs: `sparq_dot_stc`'s einsum
to f32 1e-6 relative. The ACIQ statistics are f32 means over the whole
tensor: the port's are within 1e-6 relative of an f64 evaluation, and
within 1e-5 of the reference's, whose eager f32 sums are themselves up to
4.8e-6 off f64 on these inputs (measured).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aciq as jaciq
from repro.core import calibration as jcal
from repro.core import pruning as jprune
from repro.core import quantizer as jq
from repro.core import sparq as jsp
from repro.core import vsparq as jvs
from repro_torch.core import aciq as taciq
from repro_torch.core import calibration as tcal
from repro_torch.core import pruning as tprune
from repro_torch.core import quantizer as tq
from repro_torch.core import sparq as tsp
from repro_torch.core import vsparq as tvs

CODECS = [dict(bits=4, opts=5), dict(bits=4, opts=3, rounding=False),
          dict(bits=4, opts=2, vsparq=False), dict(bits=3, opts=6),
          dict(bits=2, opts=7), dict(bits=4, opts=5, signed=True),
          dict(enabled=False), dict(enabled=False, act_bits=4)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _tied_weights(seed=0, shape=(32, 12)):
    """Gaussian weights with ties planted in groups of 4 along axis 0:
    all four equal, equal magnitudes of opposite sign, two-way ties at the
    cut, and zeros."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[0:4, 0] = 0.5                              # four equal
    w[4:8, 1] = [0.3, -0.3, 0.3, -0.3]           # equal |w|, signs differ
    w[8:12, 2] = [0.9, 0.2, 0.2, 0.1]            # tie at the cut
    w[12:16, 3] = [0.0, 0.0, 0.0, 0.0]           # all zero
    w[16:20, 4] = [0.0, 0.7, 0.0, 0.0]           # zeros tie at the cut
    w[20:24, 5] = [-0.4, 0.4, 0.1, -0.1]         # two ties
    return w


@pytest.mark.parametrize("axis", [0, 1])
def test_prune_2_4_and_keep_indices_exact(axis):
    """Masks and kept lanes equal the reference's, ties included: its
    argsorts are stable (prune keeps the later of equal lanes,
    keep_indices names the earlier)."""
    w = _tied_weights()
    if axis == 1:
        w = np.ascontiguousarray(w.T)
    jw = jnp.asarray(w)
    np.testing.assert_array_equal(np.asarray(jprune.prune_2_4(jw, axis)),
                                  tprune.prune_2_4(_t(w), axis).numpy())
    np.testing.assert_array_equal(np.asarray(jprune.keep_indices(jw, axis)),
                                  tprune.keep_indices(_t(w), axis).numpy())
    pruned = np.asarray(jprune.prune_2_4(jw, axis))
    assert tprune.sparsity(_t(pruned)) == jprune.sparsity(jnp.asarray(pruned))
    with pytest.raises(ValueError):
        tprune.prune_2_4(_t(w[:, :6] if axis == 1 else w[:6]), axis)


@pytest.mark.parametrize("codec", CODECS[:6], ids=str)
def test_vsparq_recon_grouped_exact(codec):
    """The STC pairing of the two kept lanes of every group of 4, with
    keep_idx broadcast over leading dims and given per row."""
    jc = jsp.SparqConfig(**codec)
    rng = np.random.default_rng(1)
    lo = -jc.max_val if jc.signed else 0
    x = rng.integers(lo, jc.max_val + 1, (3, 5, 32)).astype(np.int32)
    x[rng.random(x.shape) < 0.3] = 0
    keep = np.asarray(jprune.keep_indices(jnp.asarray(
        rng.standard_normal((32, 5)).astype(np.float32)), axis=0))  # [5, 8, 2]
    for k in (keep, np.broadcast_to(keep, (3, 5, 8, 2)).copy()):
        want = jvs.vsparq_recon_grouped(
            jnp.asarray(x), jnp.asarray(k), jc.bits, jc.shifts, jc.rounding,
            jc.max_val, signed=jc.signed)
        got = tvs.vsparq_recon_grouped(_t(x), _t(k), jc.bits, jc.shifts,
                                       jc.rounding, jc.max_val,
                                       signed=jc.signed)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(ValueError):
        tvs.vsparq_recon_grouped(_t(x[..., :30]), _t(keep), jc.bits,
                                 jc.shifts, jc.rounding, jc.max_val)


@pytest.mark.parametrize("codec", CODECS[:5], ids=str)
def test_sparq_dot_stc(codec):
    """The per-channel STC product on 2:4-pruned weights, N = 64 (two
    channel chunks of 32): within f32 1e-6 relative (its einsum sums 64
    integer products in another order)."""
    jc, tc = jsp.SparqConfig(**codec), tsp.SparqConfig(**codec)
    rng = np.random.default_rng(2)
    x = np.maximum(rng.standard_normal((2, 6, 64)), 0).astype(np.float32)
    w = np.asarray(jprune.prune_2_4(jnp.asarray(
        rng.standard_normal((64, 64)).astype(np.float32)), axis=0))
    span = np.float32(x.max())
    want = jsp.sparq_dot_stc(
        jnp.asarray(x), jnp.asarray(w),
        jq.act_scale_from_stats(span, 8, jc.signed), jc)
    got = tsp.sparq_dot_stc(_t(x), _t(w),
                            tq.act_scale_from_stats(span, 8, tc.signed), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_aciq_clips_and_fake_quant(bits):
    """Laplace and Gauss clips within 1e-6 relative of f64 and 1e-5 of the
    reference (module docstring); the ACIQ scale and fake-quant given the
    same clip agree exactly, and from each side's own clip differ by at
    most one step (a code at a rounding tie)."""
    rng = np.random.default_rng(bits)
    x = np.maximum(rng.laplace(0.3, 1.0, (64, 96)), 0).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    x64 = x.astype(np.float64)
    f64 = {"laplace": taciq._LAPLACE_ALPHA_OVER_B[bits]
           * np.mean(np.abs(x64 - x64.mean())),
           "gauss": taciq._GAUSS_ALPHA_OVER_SIGMA[bits] * x64.std()}
    for dist, jfn, tfn in (
            ("laplace", jaciq.aciq_clip_laplace, taciq.aciq_clip_laplace),
            ("gauss", jaciq.aciq_clip_gauss, taciq.aciq_clip_gauss)):
        got = float(tfn(tx, bits))
        np.testing.assert_allclose(got, f64[dist], rtol=1e-6)
        np.testing.assert_allclose(got, float(jfn(jx, bits)), rtol=1e-5)
    for dist in ("laplace", "gauss"):
        jqs = jaciq.aciq_act_scale(jx, bits, False, dist)
        tqs = taciq.aciq_act_scale(tx, bits, False, dist)
        assert (tqs.bits, tqs.signed, tqs.qmax) == (jqs.bits, jqs.signed,
                                                    jqs.qmax)
        np.testing.assert_allclose(float(tqs.scale), float(jqs.scale),
                                   rtol=1e-5)
        got = taciq.aciq_fake_quant(tx, bits, False, dist).numpy()
        want = np.asarray(jaciq.aciq_fake_quant(jx, bits, False, dist))
        assert np.abs(got - want).max() <= 1.0001 * float(jqs.scale)
        # the same clip on both sides: exact
        clip = np.float32(jaciq.aciq_clip_laplace(jx, bits))
        np.testing.assert_array_equal(
            np.asarray(jq.act_scale_from_stats(clip, bits, False).scale),
            tq.act_scale_from_stats(clip, bits, False).scale.numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weight_dequantize_fake_quant_exact(bits):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((48, 20)).astype(np.float32)
    jcodes, jqs = jq.quantize_weight(jnp.asarray(w), bits)
    tcodes, tqs = tq.quantize_weight(_t(w), bits)
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())
    np.testing.assert_array_equal(np.asarray(jqs.scale), tqs.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jq.dequantize(jcodes, jqs)),
                                  tq.dequantize(tcodes, tqs).numpy())
    x = np.maximum(rng.standard_normal((16, 48)), 0).astype(np.float32)
    for signed in (False, True):
        span = np.float32(np.abs(x).max())
        jas = jq.act_scale_from_stats(span, bits, signed)
        tas = tq.act_scale_from_stats(span, bits, signed)
        np.testing.assert_array_equal(np.asarray(jas.scale),
                                      tas.scale.numpy())
        np.testing.assert_array_equal(
            np.asarray(jq.fake_quant(jnp.asarray(x), jas)),
            tq.fake_quant(_t(x), tas).numpy())


@pytest.mark.parametrize("codec", CODECS, ids=str)
def test_sparq_fake_quant_dot_linear_exact(codec):
    """sparq_fake_quant, sparq_dot (dense and with STC keep indices) and
    sparq_linear: integer codes, f32 products of integers below 2^24 and
    the same f32 epilogue, so bit for bit."""
    jc, tc = jsp.SparqConfig(**codec), tsp.SparqConfig(**codec)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((12, 64)).astype(np.float32)
    if not jc.signed:
        x = np.maximum(x, 0)
    x[rng.random(x.shape) < 0.2] = 0.0
    w = rng.standard_normal((64, 24)).astype(np.float32)
    span = np.float32(np.abs(x).max())
    jas = jq.act_scale_from_stats(span, jc.act_bits, jc.signed)
    tas = tq.act_scale_from_stats(span, tc.act_bits, tc.signed)
    np.testing.assert_array_equal(
        np.asarray(jsp.sparq_fake_quant(jnp.asarray(x), jas, jc)),
        tsp.sparq_fake_quant(_t(x), tas, tc).numpy())
    np.testing.assert_array_equal(
        np.asarray(jsp.sparq_linear(jnp.asarray(x), jnp.asarray(w), jas,
                                    jc)),
        tsp.sparq_linear(_t(x), _t(w), tas, tc).numpy())
    jwc, jws = jq.quantize_weight(jnp.asarray(w), jc.weight_bits)
    twc, tws = tq.quantize_weight(_t(w), tc.weight_bits)
    keep = np.asarray(jprune.keep_indices(jnp.asarray(w), axis=0))[0]
    for k in (None, keep):
        want = jsp.sparq_dot(jnp.asarray(x), jwc, jas, jws, jc,
                             keep_idx=None if k is None else jnp.asarray(k))
        got = tsp.sparq_dot(_t(x), twc, tas, tws, tc,
                            keep_idx=None if k is None else _t(k))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _observe_all(bank, xs, lib):
    for name, x in xs:
        bank.observe(name, lib(x))
    return bank


def test_calib_bank_scales_merge_and_calibrate():
    rng = np.random.default_rng(6)
    xs = [(f"site{i % 3}", (rng.standard_normal((8, 16)) * (i + 1))
           .astype(np.float32)) for i in range(7)]
    xs += [("relu", np.maximum(rng.standard_normal((4, 4)), 0)
            .astype(np.float32))]
    jb = _observe_all(jcal.CalibBank(), xs, jnp.asarray)
    tb = _observe_all(tcal.CalibBank(), xs, _t)
    other = [("site1", np.full((2, 2), 100.0, np.float32)),
             ("new", -np.ones((3,), np.float32))]
    jm = jb.merge(_observe_all(jcal.CalibBank(), other, jnp.asarray))
    tm = tb.merge(_observe_all(tcal.CalibBank(), other, _t))
    for jbank, tbank in ((jb, tb), (jm, tm)):
        assert list(jbank.observers) == list(tbank.observers)
        for k, o in jbank.observers.items():
            t = tbank.observers[k]
            assert (o.max_val, o.min_val, o.count) == (t.max_val, t.min_val,
                                                       t.count)
        for bits in (8, 4):
            js, ts = jbank.scales(bits), tbank.scales(bits)
            for k, s in js.items():
                assert (s.bits, s.signed) == (ts[k].bits, ts[k].signed)
                np.testing.assert_array_equal(np.asarray(s.scale),
                                              ts[k].scale.numpy())
    batches = [x for _, x in xs]

    def apply(lib):
        return lambda params, batch, collect: collect.observe(
            "x", lib(batch) * params)
    jc = jcal.calibrate(apply(jnp.asarray), 2.0, batches)
    tc = tcal.calibrate(apply(_t), 2.0, batches)
    assert vars(jc.observers["x"]) == vars(tc.observers["x"])


def test_recalibrate_batchnorm_exact():
    """The generic EMA of BatchNorm statistics, f32 on both sides."""
    rng = np.random.default_rng(7)
    stats = [{"bn1": (rng.standard_normal(5).astype(np.float32),
                      rng.random(5).astype(np.float32)),
              "bn2": (rng.standard_normal(3).astype(np.float32),
                      rng.random(3).astype(np.float32))} for _ in range(4)]

    def stats_fn(lib):
        return lambda params, batch: {k: (lib(m), lib(v))
                                      for k, (m, v) in stats[batch].items()}
    want = jcal.recalibrate_batchnorm(stats_fn(jnp.asarray), None, range(4))
    got = tcal.recalibrate_batchnorm(stats_fn(_t), None, range(4))
    for k, (m, v) in want.items():
        np.testing.assert_array_equal(np.asarray(m), got[k][0].numpy())
        np.testing.assert_array_equal(np.asarray(v), got[k][1].numpy())
