"""Port parity, codec core: `repro_torch.core` against `repro.core`.

Every check here is exact equality: the codec is integer arithmetic, and
the float quantizer divides by the scale and rounds half to even in both
frameworks.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbit
from repro.core import bsparq as jbs
from repro.core import quantizer as jq
from repro.core import sparq as jsp
from repro_torch.core import bitops as tbit
from repro_torch.core import bsparq as tbs
from repro_torch.core import quantizer as tq
from repro_torch.core import sparq as tsp

BITS_OPTS = [(4, 5), (4, 3), (4, 2), (3, 6), (2, 7)]
GRID = list(itertools.product(BITS_OPTS, [True, False], [True, False],
                              [True, False]))
# jitted: eager dispatch of the integer codec's ops dominates the grid's
# run time, and integer ops give the same codes either way
_j_recon = jax.jit(jsp.sparq_recon_int, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pairs(signed):
    """Every ordered pair of codes in [-127, 127] (signed) or [0, 255]."""
    vals = np.arange(-127, 128) if signed else np.arange(0, 256)
    a, b = np.meshgrid(vals, vals, indexing="ij")
    return np.stack([a.ravel(), b.ravel()], -1).reshape(1, -1).astype(np.int32)


def test_msb_pos_and_select_shift_exact():
    x = np.arange(0, 256, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(jbit.msb_pos(jnp.asarray(x))),
                                  tbit.msb_pos(_t(x)).numpy())
    m = np.arange(0, 8, dtype=np.int32)
    for bits, opts in BITS_OPTS:
        sh = jbs.shifts_for(bits, opts)
        assert tbs.shifts_for(bits, opts) == sh
        np.testing.assert_array_equal(
            np.asarray(jbit.select_shift(jnp.asarray(m), bits, sh)),
            tbit.select_shift(_t(m), bits, sh).numpy())


@pytest.mark.parametrize("bits,opts", BITS_OPTS)
@pytest.mark.parametrize("rounding", [True, False], ids=["R", "noR"])
@pytest.mark.parametrize("max_val", [255, 127])
def test_bsparq_encode_exact(bits, opts, rounding, max_val):
    x = np.arange(0, max_val + 1, dtype=np.int32)
    sh = jbs.shifts_for(bits, opts)
    jq_, js = jbs.bsparq_encode(jnp.asarray(x), bits, sh, rounding, max_val)
    tq_, ts = tbs.bsparq_encode(_t(x), bits, sh, rounding, max_val)
    np.testing.assert_array_equal(np.asarray(jq_), tq_.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("combo", GRID, ids=lambda c: (
    f"{c[0][0]}b{c[0][1]}opt-{'R' if c[1] else 'noR'}-"
    f"{'vS' if c[2] else 'noVS'}-{'signed' if c[3] else 'unsigned'}"))
def test_sparq_recon_int_exact_over_all_pairs(combo):
    """Every ordered pair of integers in [0,255] / [-127,127] through
    sparq_recon_int, for every (bits, opts), ±R, ±vS, signed/unsigned."""
    (bits, opts), rounding, vsparq, signed = combo
    cfg_kw = dict(bits=bits, opts=opts, rounding=rounding, vsparq=vsparq,
                  signed=signed)
    x = _pairs(signed)
    want = np.asarray(_j_recon(jnp.asarray(x), jsp.SparqConfig(**cfg_kw)))
    got = tsp.sparq_recon_int(_t(x), tsp.SparqConfig(**cfg_kw)).numpy()
    np.testing.assert_array_equal(want, got)
    assert tsp.SparqConfig(**cfg_kw).name == jsp.SparqConfig(**cfg_kw).name
    assert tsp.SparqConfig(**cfg_kw).max_val == \
        jsp.SparqConfig(**cfg_kw).max_val


def test_quantize_and_weight_scale_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 96)) * 3).astype(np.float32)
    # values landing exactly on .5 boundaries exercise round-half-even
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                        np.float32) * 0.25
    for signed, bits in ((True, 8), (False, 8), (True, 4)):
        jqs = jq.act_scale_from_stats(3.0, bits=bits, signed=signed)
        tqs = tq.act_scale_from_stats(3.0, bits=bits, signed=signed)
        assert np.asarray(jqs.scale) == tqs.scale.numpy()
        np.testing.assert_array_equal(
            np.asarray(jq.quantize(jnp.asarray(x), jqs)),
            tq.quantize(_t(x), tqs).numpy())
    half = jq.QScale(scale=jnp.float32(0.25), bits=8, signed=True)
    thalf = tq.QScale(scale=torch.tensor(0.25), bits=8, signed=True)
    np.testing.assert_array_equal(
        np.asarray(jq.quantize(jnp.asarray(x[0, :8]), half)),
        tq.quantize(_t(x[0, :8]), thalf).numpy())
    jws, tws = jq.weight_scale(jnp.asarray(x)), tq.weight_scale(_t(x))
    np.testing.assert_array_equal(np.asarray(jws.scale), tws.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jq.quantize(jnp.asarray(x), jws)),
                                  tq.quantize(_t(x), tws).numpy())


def test_minmax_observer_matches():
    rng = np.random.default_rng(1)
    jo, to = jq.MinMaxObserver(), tq.MinMaxObserver()
    for _ in range(3):
        x = rng.standard_normal((8, 16)).astype(np.float32)
        jo, to = jo.update(jnp.asarray(x)), to.update(_t(x))
    assert (jo.max_val, jo.min_val, jo.count) == \
        (to.max_val, to.min_val, to.count)
    assert np.asarray(jo.scale(signed=True).scale) == \
        to.scale(signed=True).scale.numpy()
