"""The paper's post-training quantization procedure on its CNN family
(the model-side helpers of the reference's `benchmarks/common.py`, its
ACIQ calibration and 2:4 pruning, and `_logit_err` of
`tests/test_paper_claims.py`). No CLI: a caller drives it, as
`chip_smoke.py`'s `cnn` phase does.

    model = init_model(get_config("paper-resnet"))        # on the card
    scales = calibrate_cnn(model, calib_batches(model["cfg"]))
    acc = cnn_accuracy(model, quant_ctx(scales, PAPER_CODECS["5opt_R"]))

A model is {"cfg": CNNConfig, "params": tree}. Every entry point takes
`device=None` and resolves it with `repro_torch.resolve_device`: the card
unless the caller asks for the CPU; without a GPU it raises. The data are
the synthetic gratings of `models.cnn.synthetic_dataset`, drawn from a
seeded `torch.Generator` on that device. The float trainer is not ported:
a model is random (seeded) with its BatchNorm recalibrated, or carries
parameters from the JAX package (`interop.params_from_jax`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.aciq import aciq_clip_laplace
from repro_torch.core.calibration import CalibBank
from repro_torch.core.pruning import prune_2_4
from repro_torch.core.quantizer import MinMaxObserver
from repro_torch.core.sparq import SparqConfig
from repro_torch.models import cnn
from repro_torch.models.common import QuantCtx

SEED = 42
N_EVAL = 3072
N_CALIB = 256

# The quantizer configurations of the paper's Tables 1, 2 and 4, by the
# reference's row names (`benchmarks/tables.py`): uniform min-max A8W8,
# A4W8 and A8W4; 5/3/2opt 4-bit windows trimmed, rounded and rounded
# without vSPARQ; 3-bit 6opt and 2-bit 7opt with and without vSPARQ.
# All unsigned: post-ReLU activations.
PAPER_CODECS: Dict[str, SparqConfig] = {
    "a8w8": SparqConfig(enabled=False, act_bits=8, weight_bits=8),
    "a4w8": SparqConfig(enabled=False, act_bits=4, weight_bits=8),
    "a8w4": SparqConfig(enabled=False, act_bits=8, weight_bits=4),
    **{f"{o}opt_{v}": SparqConfig(bits=4, opts=o, rounding=r, vsparq=vs)
       for o in (5, 3, 2)
       for v, r, vs in (("trim", False, True), ("R", True, True),
                        ("R_noVS", True, False))},
    "3b_6opt": SparqConfig.opt6(),
    "2b_7opt": SparqConfig.opt7(),
    "3b_6opt_noVS": SparqConfig.opt6(vsparq=False),
    "2b_7opt_noVS": SparqConfig.opt7(vsparq=False),
}

# Table 6: SPARQ on sparse tensor cores, on a 2:4-pruned model (its A8W8
# row runs the dense path and is PAPER_CODECS["a8w8"]).
STC_CODECS: Dict[str, SparqConfig] = {
    "stc_4b_5opt": SparqConfig.opt5(),
    "stc_4b_3opt": SparqConfig.opt3(),
    "stc_4b_2opt": SparqConfig.opt2(),
    "stc_3b_6opt": SparqConfig.opt6(),
    "stc_2b_7opt": SparqConfig.opt7(),
}


def init_model(cfg: cnn.CNNConfig, seed: int = SEED,
               device=None) -> Dict:
    """A seeded random model on `device`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"cfg": cfg, "params": cnn.init_params(gen, cfg, dev)}


def eval_batches(cfg: cnn.CNNConfig, n: int = N_EVAL, batch: int = 256,
                 seed: int = SEED + 7, device=None) -> List[Dict]:
    """n // batch batches of the synthetic task, drawn in order from one
    generator seeded with `seed`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [cnn.synthetic_dataset(gen, cfg, batch, dev)
            for _ in range(n // batch)]


def calib_batches(cfg: cnn.CNNConfig, n: int = N_CALIB, batch: int = 128,
                  seed: int = SEED + 13, device=None) -> List[Dict]:
    return eval_batches(cfg, n=n, batch=batch, seed=seed, device=device)


def calibrate_cnn(model: Dict, batches: Optional[List[Dict]] = None,
                  device=None) -> Dict[str, float]:
    """Paper §5: recalibrate BatchNorm on the calibration batches (the
    model's params are replaced), then collect each quantized site's
    min-max span over the same batches. `batches` defaults to the
    reference's own choice, one batch of 128 (`calib_batches(cfg, 128)`).
    Returns {site: max} as floats."""
    dev = resolve_device(device)
    cfg = model["cfg"]
    if batches is None:
        batches = calib_batches(cfg, 128, device=dev)
    params = cnn.recalibrate_bn(model["params"], batches, cfg)
    model["params"] = params
    bank = CalibBank()
    ctx = QuantCtx(mode="calibrate", collect=bank)
    for b in batches:
        cnn.forward(params, b["image"], cfg, ctx=ctx, train=False)
    return {k: float(o.max_val) for k, o in bank.observers.items()}


class _ACIQBank(CalibBank):
    """Records the ACIQ-Laplace clip of each site's input, the largest
    over the batches, in place of the observed max."""

    def __init__(self, bits: int):
        super().__init__()
        self.bits = bits

    def observe(self, name: str, x: torch.Tensor) -> None:
        clip = float(aciq_clip_laplace(x, self.bits))
        obs = self.observers.get(name, MinMaxObserver())
        self.observers[name] = MinMaxObserver(max(obs.max_val, clip), 0.0,
                                              obs.count + 1)


def aciq_scales(model: Dict, bits: int,
                batches: Optional[List[Dict]] = None,
                device=None) -> Dict[str, float]:
    """Table 3's ACIQ baseline: per site, the analytic Laplace clip at
    `bits` in place of the min-max span (one calibration batch of 128 by
    default, as the reference)."""
    dev = resolve_device(device)
    cfg = model["cfg"]
    if batches is None:
        batches = calib_batches(cfg, 128, device=dev)
    bank = _ACIQBank(bits)
    ctx = QuantCtx(mode="calibrate", collect=bank)
    for b in batches:
        cnn.forward(model["params"], b["image"], cfg, ctx=ctx, train=False)
    return {k: o.max_val for k, o in bank.observers.items()}


def prune_cnn(params: Dict) -> Dict:
    """Paper §5.3: 2:4-prune every conv weight but the stem's, in groups
    of 4 along the reference's flattening (HWIO reshaped to [9 * cin,
    cout], (kh, kw, cin)-major). A new tree; BN and head unchanged."""
    def walk(node, in_stem=False):
        if isinstance(node, dict):
            return {k: walk(v, in_stem or k == "stem")
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_stem) for v in node]
        if node.ndim == 4 and not in_stem:
            return prune_2_4(node.reshape(-1, node.shape[-1]),
                             axis=0).reshape(node.shape)
        return node
    return walk(params)


def quant_ctx(scales: Dict[str, float], cfg: SparqConfig,
              stc: bool = False, device=None) -> QuantCtx:
    """The quantized-mode context of a calibrated model: per-site spans as
    f32 0-d tensors on `device`."""
    dev = resolve_device(device)
    return QuantCtx(mode="quantized", cfg=cfg, stc=stc, scales={
        k: torch.tensor(v, dtype=torch.float32, device=dev)
        for k, v in scales.items()})


def cnn_accuracy(model: Dict, ctx: Optional[QuantCtx] = None,
                 batches: Optional[List[Dict]] = None, n: int = N_EVAL,
                 batch: int = 256, device=None) -> float:
    """Top-1 accuracy, the mean of the batches' accuracies."""
    dev = resolve_device(device)
    cfg, params = model["cfg"], model["params"]
    if batches is None:
        batches = eval_batches(cfg, n, batch=batch, device=dev)
    return sum(float(cnn.accuracy(params, b, cfg, ctx=ctx))
               for b in batches) / len(batches)


def relative_logit_err(lq: torch.Tensor, lf: torch.Tensor) -> float:
    """mean |lq - lf| / mean |lf|: one batch's relative logit error."""
    return float(torch.abs(lq - lf).mean() / (torch.abs(lf).mean() + 1e-9))


def logit_err(model: Dict, scales: Dict[str, float], cfg: SparqConfig,
              batches: Optional[List[Dict]] = None, n: int = 512,
              device=None) -> float:
    """Mean relative logit perturbation of a quantizer configuration
    against the float model, over the batches (two of 256 by default):
    the model-level degradation measure that stays informative when the
    synthetic task's accuracy saturates."""
    mcfg, params = model["cfg"], model["params"]
    dev = resolve_device(device)
    if batches is None:
        batches = eval_batches(mcfg, n=n, batch=256, device=dev)
    ctx = quant_ctx(scales, cfg, device=dev)
    errs = []
    for b in batches:
        lf, _ = cnn.forward(params, b["image"], mcfg)
        lq, _ = cnn.forward(params, b["image"], mcfg, ctx=ctx)
        errs.append(relative_logit_err(lq, lf))
    return sum(errs) / len(errs)
