"""Port parity, the paper's CNN path: `repro_torch.models.cnn` and
`repro_torch.launch.cnn_eval` against `repro.models.cnn` and the
reference's model-side helpers (`benchmarks/common.py`,
`benchmarks/tables.py::_aciq_scales`), on the reduced `paper-resnet`
(width 16, stages (1, 1), 16 x 16 images, 8 classes), batches of 8.

The data cannot be drawn alike (`jax.random` and `torch.Generator` give
other numbers), so every test feeds images made by the JAX package, as
numpy, to both; parameters carry across with `interop.params_from_jax`.

Tolerances, with their reasons:
- im2col patches, codes and a quantized conv's f32 output: exact (copies,
  integer arithmetic, one f32 epilogue order).
- float forward ("off" mode): 1e-4 of max |logit| (convolution and
  reduction orders differ between XLA and PyTorch).
- BatchNorm recalibration: mean and var within 1e-5 relative of the
  stats' largest magnitude (f32 reductions in another order).
- calibrated site spans: within one f32 ulp.
- quantized forward given the reference's scales: a code may flip at a
  rounding tie after ulp-level differences in BN, ReLU or the residual
  add, and the flip then moves later layers; each layer's flipped codes
  are held to 0.1% and the logits to QUANT_LOGIT_TOL of max |logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_resnet as jconfigs
from repro.core.sparq import SparqConfig as JCfg
from repro.models import cnn as jcnn
from repro.models.common import QuantCtx as JCtx
from repro_torch import configs as tconfigs
from repro_torch.core import quantizer as tq
from repro_torch.core.sparq import SparqConfig as TCfg
from repro_torch.interop import params_from_jax
from repro_torch.launch import cnn_eval as ce
from repro_torch.models import cnn as tcnn
from repro_torch.models.common import QuantCtx as TCtx

# measured on these inputs: the largest |logit| difference over the three
# codecs below is 3.3e-7 of max |logit| (no code flipped in any layer),
# the STC forward's 2.5e-7; held to 1e-5, 30 times the measured
QUANT_LOGIT_TOL = 1e-5
QUANT_CODECS = {"5opt": dict(bits=4, opts=5),
                "2opt_noVS": dict(bits=4, opts=2, vsparq=False),
                "a8w8": dict(enabled=False)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """JAX-made reduced model (BN recalibrated on two batches), its
    calibrated spans, and the same images for both sides. Parameters and
    images are made by the jitted JAX functions (one compile each instead
    of one per eager op); every function under test runs eagerly."""
    cfg = jconfigs.reduced()
    params = jax.jit(jcnn.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    data = jax.jit(jcnn.synthetic_dataset, static_argnums=(1, 2))
    calib = [_np(data(jax.random.PRNGKey(10 + i), cfg, 8)) for i in range(2)]
    evalb = [_np(data(jax.random.PRNGKey(20 + i), cfg, 8)) for i in range(2)]
    jparams = jcnn.recalibrate_bn(
        params, [jax.tree.map(jnp.asarray, b) for b in calib], cfg)
    from repro.core.calibration import CalibBank
    bank = CalibBank()
    for b in calib:
        jcnn.forward(jparams, jnp.asarray(b["image"]), cfg,
                     ctx=JCtx(mode="calibrate", collect=bank))
    scales = {k: float(o.max_val) for k, o in bank.observers.items()}
    return dict(cfg=cfg, init=params, params=jparams, calib=calib,
                evalb=evalb, scales=scales, tcfg=tconfigs.get_reduced_config(
                    "paper-resnet"))


def _tb(batches):
    return [{k: _t(v) for k, v in b.items()} for b in batches]


def test_config_and_registry():
    for name in ("config", "reduced"):
        want = dataclasses.asdict(getattr(jconfigs, name)())
        got = dataclasses.asdict(getattr(tconfigs, "get_config" if name ==
                                         "config" else
                                         "get_reduced_config")("paper-resnet"))
        assert got == want
    assert "paper-resnet" not in tconfigs.ARCHS


def test_params_from_jax_carries_the_cnn_tree(setup):
    """Nested lists under "stages", a bare array under "head", BN stats
    included: the same tree, every leaf equal."""
    tp = params_from_jax(_np(setup["params"]))
    assert isinstance(tp["stages"], list) and isinstance(tp["stages"][0],
                                                         list)
    assert torch.is_tensor(tp["head"])
    jl, jdef = jax.tree.flatten(_np(setup["params"]))
    tl = []

    def walk(n):
        if isinstance(n, dict):
            for k in sorted(n):
                walk(n[k])
        elif isinstance(n, list):
            for v in n:
                walk(v)
        else:
            tl.append(n.numpy())
    walk(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    assert set(tp["stages"][1][0]) == {"w1", "bn1", "w2", "bn2", "proj"}
    assert set(tp["stages"][0][0]["bn1"]) == {"scale", "bias", "mean", "var"}


def _stem_out(setup):
    """The JAX model's stem activation (post-ReLU, NHWC): the input of the
    first quantized conv."""
    cfg, p = setup["cfg"], setup["params"]
    h = jcnn._conv(p["stem"]["w"], jnp.asarray(setup["evalb"][0]["image"]),
                   1, "stem", None)
    h, _ = jcnn._bn(p["stem"]["bn"], h, False)
    return np.asarray(jax.nn.relu(h))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("codec", list(QUANT_CODECS))
def test_quantized_conv_bit_for_bit(setup, stride, codec):
    """One quantized conv on the JAX layer input: equal im2col patches
    (lane order (cin, kh, kw)), equal codes and SPARQ reconstructions,
    equal f32 output.

    At stride 2, "SAME" on the even 16 x 16 input pads 0 rows before and 1
    after (output (i, j) sees input rows 2i..2i+2). A port that padded 1
    on both sides (`F.unfold(padding=1)`, `F.conv2d(padding=1)`) would see
    rows 2i-1..2i+1: every patch would differ, and so would this test's
    patches, codes and output."""
    h = _stem_out(setup)
    w = np.asarray(setup["params"]["stages"][1][0]["w1"] if stride == 2
                   else setup["params"]["stages"][0][0]["w1"])
    jp = jax.lax.conv_general_dilated_patches(
        jnp.asarray(h), (3, 3), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    tp = tcnn.im2col(_t(h), 3, 3, stride)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    jc, tc = JCfg(**QUANT_CODECS[codec]), TCfg(**QUANT_CODECS[codec])
    span = np.float32(setup["scales"]["s0b0/conv1"])
    from repro.core import quantizer as jq
    from repro.core.sparq import sparq_recon_int as jrecon
    from repro_torch.core.sparq import sparq_recon_int as trecon
    jqs = jq.QScale(jnp.float32(span) / jc.max_val, 8, False)
    tqs = tq.QScale(tq.div_qmax(torch.tensor(span), tc.max_val), 8, False)
    jcodes, tcodes = jq.quantize(jp, jqs), tq.quantize(tp, tqs)
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())
    assert int((tcodes > 127).sum()) > 0      # the unsigned range is used
    np.testing.assert_array_equal(np.asarray(jrecon(jcodes, jc)),
                                  trecon(tcodes, tc).numpy())
    scales = {"conv1": span}
    want = jcnn._conv(jnp.asarray(w), jnp.asarray(h), stride, "conv1",
                      JCtx(mode="quantized", cfg=jc, scales={
                          k: jnp.float32(v) for k, v in scales.items()}))
    got = tcnn._conv(_t(w), _t(h), stride, "conv1",
                     TCtx(mode="quantized", cfg=tc, scales={
                         k: torch.tensor(v) for k, v in scales.items()}))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_quantized_conv_matches_pallas_interpret(setup):
    """One image's stride-2 conv through `ops.quantized_matmul(impl=
    "pallas")` (sparq_matmul_pallas in interpret mode) equals the port."""
    h = _stem_out(setup)[:1]
    w = np.asarray(setup["params"]["stages"][1][0]["proj"])
    cfg = dict(bits=4, opts=5)
    span = {"proj": np.float32(setup["scales"]["s1b0/proj"])}
    want = jcnn._conv(jnp.asarray(w), jnp.asarray(h), 2, "proj", JCtx(
        mode="quantized", cfg=JCfg(**cfg), impl="pallas",
        scales={k: jnp.float32(v) for k, v in span.items()}))
    got = tcnn._conv(_t(w), _t(h), 2, "proj", TCtx(
        mode="quantized", cfg=TCfg(**cfg),
        scales={k: torch.tensor(v) for k, v in span.items()}))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_forward_off_mode(setup):
    cfg, tcfg = setup["cfg"], setup["tcfg"]
    tp = params_from_jax(_np(setup["params"]))
    for b in setup["evalb"]:
        want, _ = jcnn.forward(setup["params"], jnp.asarray(b["image"]), cfg)
        got, _ = tcnn.forward(tp, _t(b["image"]), tcfg)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    # accuracy and loss on the same batch
    b = setup["evalb"][0]
    jb = jax.tree.map(jnp.asarray, b)
    assert float(tcnn.accuracy(tp, _tb([b])[0], tcfg)) == float(
        jcnn.accuracy(setup["params"], jb, cfg))
    np.testing.assert_allclose(
        float(tcnn.loss_fn(tp, _tb([b])[0], tcfg, train=False)),
        float(jcnn.loss_fn(setup["params"], jb, cfg, train=False)),
        rtol=1e-5)


def test_recalibrate_bn(setup):
    """Cumulative BN statistics over two batches (momentum 1 / (i + 1)),
    every BN of the tree; the input tree is left as it was."""
    tinit = params_from_jax(_np(setup["init"]))
    got = tcnn.recalibrate_bn(tinit, _tb(setup["calib"]), setup["tcfg"])
    assert float(tinit["stem"]["bn"]["var"].sum()) == 16.0   # untouched
    want = setup["params"]

    def pairs(jn, tn):
        if isinstance(jn, dict):
            if "mean" in jn:
                yield jn, tn
            else:
                for k in jn:
                    yield from pairs(jn[k], tn[k])
        elif isinstance(jn, list):
            for a, b in zip(jn, tn):
                yield from pairs(a, b)
    n = 0
    for jbn, tbn in pairs(want, got):
        for k in ("mean", "var"):
            w_ = np.asarray(jbn[k])
            np.testing.assert_allclose(tbn[k].numpy(), w_, rtol=0,
                                       atol=1e-5 * np.abs(w_).max())
        n += 1
    assert n == 5     # stem + 2 blocks x 2


def _record(monkeypatch, module, sink, mode="quantized"):
    """Wrap `module.dense` to keep each site's input in `mode`."""
    orig = module.dense

    def spy(w, x, site, ctx=None):
        if ctx is not None and ctx.mode == mode:
            sink.append((ctx.site_prefix + site, np.asarray(x)))
        return orig(w, x, site, ctx)
    monkeypatch.setattr(module, "dense", spy)


def test_calibrate_cnn_matches_reference(setup, monkeypatch):
    """cnn_eval.calibrate_cnn against benchmarks/common.py::calibrate_cnn
    on the same calibration batches: BN recalibrated, then every quantized
    site's span. Each span is exactly the max of the port's own site
    inputs, and differs from the reference's by no more than the site
    inputs differ, which is within 1e-6 of their largest value (the float
    stem conv and BN sum in another order; measured: spans within 5 f32
    ulps, so not within the one ulp that bit-equal inputs would give)."""
    from benchmarks import common
    jb = [jax.tree.map(jnp.asarray, b) for b in setup["calib"]]
    monkeypatch.setattr(common, "calib_batches", lambda cfg, n=None: jb)
    jx, tx = [], []
    _record(monkeypatch, jcnn, jx, "calibrate")
    _record(monkeypatch, tcnn, tx, "calibrate")
    jmodel = {"cfg": setup["cfg"], "params": setup["init"]}
    want = common.calibrate_cnn(jmodel)
    tmodel = {"cfg": setup["tcfg"],
              "params": params_from_jax(_np(setup["init"]))}
    got = ce.calibrate_cnn(tmodel, _tb(setup["calib"]), device="cpu")
    assert list(got) == list(want) == [
        "s0b0/conv1", "s0b0/conv2", "s1b0/conv1", "s1b0/conv2", "s1b0/proj"]
    assert [s for s, _ in jx] == [s for s, _ in tx]
    for k, v in want.items():
        mine = [b for s, b in tx if s == k]
        ref = [a for s, a in jx if s == k]
        assert got[k] == max(float(b.max()) for b in mine)
        dx = max(float(np.abs(a - b).max()) for a, b in zip(ref, mine))
        assert dx <= 1e-6 * max(float(np.abs(a).max()) for a in ref), k
        assert abs(got[k] - v) <= dx, (k, got[k], v, dx)


def test_aciq_scales_match_reference(setup, monkeypatch):
    """cnn_eval.aciq_scales against benchmarks/tables.py::_aciq_scales on
    the same batch: each site's Laplace clip within 1e-6 relative of an
    f64 evaluation on the port's site input, and within 1e-3 of the
    reference, whose eager f32 means over a site's 147k-295k values are
    themselves 1.5e-4 to 3e-4 off f64 (measured)."""
    from benchmarks import common, tables
    jb = [jax.tree.map(jnp.asarray, b) for b in setup["calib"][:1]]
    monkeypatch.setattr(common, "calib_batches", lambda cfg, n=None: jb)
    want = tables._aciq_scales({"cfg": setup["cfg"],
                                "params": setup["params"]}, bits=4)
    seen = {}
    orig = tcnn.dense

    def spy(w, x, site, ctx=None):
        seen[ctx.site_prefix + site] = x.numpy().astype(np.float64)
        return orig(w, x, site, ctx)
    monkeypatch.setattr(tcnn, "dense", spy)
    got = ce.aciq_scales({"cfg": setup["tcfg"], "params": params_from_jax(
        _np(setup["params"]))}, 4, _tb(setup["calib"][:1]), device="cpu")
    assert list(got) == list(want) == list(seen)
    for k, v in want.items():
        x = seen[k]
        np.testing.assert_allclose(got[k], 5.03 * np.mean(np.abs(
            x - x.mean())), rtol=1e-6)
        np.testing.assert_allclose(got[k], float(v), rtol=1e-3)


@pytest.mark.parametrize("codec", list(QUANT_CODECS))
def test_quantized_forward_given_reference_scales(setup, monkeypatch,
                                                  codec):
    """The whole quantized forward with the reference's spans: each
    layer's input codes differ in at most 0.1% of places (rounding ties
    after ulp-level differences upstream), the logits by at most
    QUANT_LOGIT_TOL of max |logit|; top-1 and logit_err agree."""
    cfg, tcfg = setup["cfg"], setup["tcfg"]
    jc, tc = JCfg(**QUANT_CODECS[codec]), TCfg(**QUANT_CODECS[codec])
    jctx = JCtx(mode="quantized", cfg=jc, scales={
        k: jnp.float32(v) for k, v in setup["scales"].items()})
    tctx = ce.quant_ctx(setup["scales"], tc, device="cpu")
    tp = params_from_jax(_np(setup["params"]))
    jx, tx = [], []
    _record(monkeypatch, jcnn, jx)
    _record(monkeypatch, tcnn, tx)
    jl, tl = [], []
    for b in setup["evalb"]:
        jl.append(np.asarray(jcnn.forward(setup["params"],
                                          jnp.asarray(b["image"]), cfg,
                                          ctx=jctx)[0]))
        tl.append(tcnn.forward(tp, _t(b["image"]), tcfg, ctx=tctx)[0])
    assert [s for s, _ in jx] == [s for s, _ in tx] and len(jx) == 10
    for (site, a), (_, b) in zip(jx, tx):
        qs = tq.QScale(tq.div_qmax(torch.tensor(setup["scales"][site]),
                                   tc.max_val), 8, False)
        flips = int((tq.quantize(_t(a), qs) != tq.quantize(_t(b), qs))
                    .sum())
        assert flips <= 1e-3 * a.size, (site, flips, a.size)
    for want, got in zip(jl, tl):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=QUANT_LOGIT_TOL * np.abs(want).max())
        assert (got.argmax(-1).numpy() == want.argmax(-1)).all()
    monkeypatch.undo()
    err = ce.logit_err({"cfg": tcfg, "params": tp}, setup["scales"], tc,
                       batches=_tb(setup["evalb"]), device="cpu")
    lf = [np.asarray(jcnn.forward(setup["params"], jnp.asarray(b["image"]),
                                  cfg)[0]) for b in setup["evalb"]]
    want_err = np.mean([np.abs(q - f).mean() / (np.abs(f).mean() + 1e-9)
                        for q, f in zip(jl, lf)])
    np.testing.assert_allclose(err, want_err, rtol=1e-3)


def test_prune_cnn_and_stc_conv(setup):
    """Table 6's path: prune_cnn equals the reference's pruning
    (benchmarks/common.py::train_cnn's apply_prune), and a pruned conv
    through the STC simulation (QuantCtx.stc, one image at stride 2)
    agrees with the reference's within QUANT_LOGIT_TOL of its largest
    output."""
    from repro.core.pruning import prune_2_4

    def apply_prune(p):    # the reference's, from train_cnn
        def prune_leaf(path, leaf):
            if leaf.ndim == 4 and "stem" not in str(path):
                w2 = leaf.reshape(-1, leaf.shape[-1])
                return prune_2_4(w2, axis=0).reshape(leaf.shape)
            return leaf
        return jax.tree_util.tree_map_with_path(prune_leaf, p)
    jpruned = apply_prune(setup["params"])
    tpruned = ce.prune_cnn(params_from_jax(_np(setup["params"])))
    jl = jax.tree.leaves(_np(jpruned))
    tl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tpruned))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    h = _stem_out(setup)[:1]
    w = np.asarray(jpruned["stages"][1][0]["w1"])
    span = {"conv1": np.float32(setup["scales"]["s1b0/conv1"])}
    want = np.asarray(jcnn._conv(jnp.asarray(w), jnp.asarray(h), 2, "conv1",
                                 JCtx(mode="quantized", cfg=JCfg.opt5(),
                                      stc=True, scales={
                                          k: jnp.float32(v)
                                          for k, v in span.items()})))
    got = tcnn._conv(_t(w), _t(h), 2, "conv1", TCtx(
        mode="quantized", cfg=TCfg.opt5(), stc=True,
        scales={k: torch.tensor(v) for k, v in span.items()})).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=QUANT_LOGIT_TOL * np.abs(want).max())


def test_skip_sites_run_in_float(setup):
    """A skipped site is a float matmul in both packages."""
    h = _stem_out(setup)
    w = np.asarray(setup["params"]["stages"][0][0]["w1"])
    scales = {"conv1": np.float32(setup["scales"]["s0b0/conv1"])}
    want = jcnn._conv(jnp.asarray(w), jnp.asarray(h), 1, "conv1", JCtx(
        mode="quantized", cfg=JCfg.opt5(), skip_sites=("conv1",),
        scales={k: jnp.float32(v) for k, v in scales.items()}))
    got = tcnn._conv(_t(w), _t(h), 1, "conv1", TCtx(
        mode="quantized", cfg=TCfg.opt5(), skip_sites=("conv1",),
        scales={k: torch.tensor(v) for k, v in scales.items()}))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_synthetic_dataset_and_batches():
    """The port's task has the reference's shapes, types, label range and
    grating (noise-free images equal to a few ulps), drawn from a
    torch.Generator; eval and calibration batches are seeded."""
    cfg = tconfigs.get_reduced_config("paper-resnet")
    b = ce.eval_batches(cfg, n=16, batch=8, device="cpu")
    assert len(b) == 2 and b[0]["image"].shape == (8, 16, 16, 3)
    assert b[0]["image"].dtype == torch.float32
    assert int(b[0]["label"].min()) >= 0
    assert int(b[0]["label"].max()) < cfg.num_classes
    again = ce.eval_batches(cfg, n=16, batch=8, device="cpu")
    assert torch.equal(b[1]["image"], again[1]["image"])
    assert len(ce.calib_batches(cfg, device="cpu")) == 2
    quiet = cfg.replace(noise=0.0)
    gen = torch.Generator().manual_seed(0)
    t = tcnn.synthetic_dataset(gen, quiet, 8, "cpu")
    # the reference's grating for the port's labels and phases
    gen = torch.Generator().manual_seed(0)
    labels = torch.randint(0, cfg.num_classes, (8,), generator=gen)
    phase = (torch.rand((8,), generator=gen) * 2 * np.pi).numpy()
    S = cfg.img_size
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    lab = labels.numpy()
    f = (2 * np.pi * (1 + np.arange(cfg.num_classes) % 4) / 16.0)[lab]
    a = (np.pi * (np.arange(cfg.num_classes) // 4) / 4.0)[lab]
    wave = np.sin(f[:, None, None] * (np.cos(a)[:, None, None] * xx +
                                      np.sin(a)[:, None, None] * yy)
                  + phase[:, None, None])
    np.testing.assert_allclose(t["image"][..., 0].numpy(), wave, atol=1e-5)
    assert torch.equal(t["label"], labels)


def test_entry_points_raise_without_gpu(monkeypatch):
    """cnn_eval's entry points run on the card unless the caller asks for
    the CPU: with no GPU and no device they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_reduced_config("paper-resnet")
    model = ce.init_model(cfg, device="cpu")
    b = ce.eval_batches(cfg, n=8, batch=8, device="cpu")
    calls = [lambda: ce.init_model(cfg), lambda: ce.eval_batches(cfg),
             lambda: ce.calib_batches(cfg),
             lambda: ce.calibrate_cnn(model, b),
             lambda: ce.aciq_scales(model, 4, b),
             lambda: ce.quant_ctx({}, TCfg()),
             lambda: ce.cnn_accuracy(model, batches=b),
             lambda: ce.logit_err(model, {}, TCfg(), batches=b)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert 0.0 <= ce.cnn_accuracy(model, batches=b, device="cpu") <= 1.0
