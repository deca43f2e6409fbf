"""Paper-faithful CNN substrate (port of `repro.models.cnn`): the
mini-ResNet (ReLU + BatchNorm) of the paper's own model family.

Layouts are the reference's: NHWC activations, HWIO conv weights, so
parameters carry across as plain copies. In the calibrate and quantized
modes every conv but the stem runs as im2col + `dense()`, the paper's
setting (§4: the convolution mapped to a matrix product), so SPARQ sees
the unsigned post-ReLU activation matrix and K1 runs in its unsigned
mode on the card. The stem is never quantized or observed (paper §5), and
the head is a float matmul. Float convs ("off" mode, the stem) are
`F.conv2d` on the explicitly padded input: on the card their precision is
cuDNN's, so a caller that wants full f32 sets
`torch.backends.cudnn.allow_tf32 = False`.

"SAME" padding follows the reference exactly: a 3x3 window at stride 2
on an even size pads 0 before and 1 after (`_same_pads`), which
`padding=1` would not give.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import QuantCtx, dense, trunc_normal


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-resnet"
    num_classes: int = 16
    width: int = 32
    stages: tuple = (1, 1, 1)    # residual blocks per stage
    img_size: int = 32
    in_channels: int = 3
    noise: float = 0.45          # additive pixel noise (task difficulty)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's "SAME": out = ceil(size /
    stride), the excess split with the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int):
    """x [B, H, W, C] zero-padded for a "SAME" window; returns (padded,
    output height, output width)."""
    (t, b), (l, r) = (_same_pads(x.shape[1], kh, stride),
                      _same_pads(x.shape[2], kw, stride))
    return (F.pad(x, (0, 0, l, r, t, b)), -(-x.shape[1] // stride),
            -(-x.shape[2] // stride))


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, Ho, Wo, C * kh * kw] "SAME" patches, lanes
    channel-major (c, i, j) as `jax.lax.conv_general_dilated_patches`
    gives them: vSPARQ pairs adjacent lanes, so the order decides which
    activations pair."""
    xp, ho, wo = _pad_same(x, kh, kw, stride)
    taps = [xp[:, i:i + stride * (ho - 1) + 1:stride,
               j:j + stride * (wo - 1) + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    B, C = x.shape[0], x.shape[3]
    return torch.stack(taps, dim=-1).reshape(B, ho, wo, C * kh * kw)


def _conv(w: torch.Tensor, x: torch.Tensor, stride: int, site: str,
          ctx: Optional[QuantCtx]) -> torch.Tensor:
    """3x3 "SAME" conv, NHWC x HWIO; im2col + dense in the quant modes."""
    kh, kw, cin, cout = w.shape
    if ctx is None or ctx.mode == "off":
        xp, _, _ = _pad_same(x, kh, kw, stride)
        y = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride)
        return y.permute(0, 2, 3, 1)
    patches = im2col(x, kh, kw, stride)
    w2 = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return dense(w2, patches, site, ctx)


def _bn(params: Dict, x: torch.Tensor, train: bool, eps: float = 1e-5):
    """BatchNorm over (B, H, W): batch statistics (population variance)
    when training, the running ones otherwise."""
    if train:
        mean = torch.mean(x, dim=(0, 1, 2))
        var = torch.var(x, dim=(0, 1, 2), correction=0)
    else:
        mean, var = params["mean"], params["var"]
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * params["scale"] + params["bias"], (mean, var)


def _bn_init(c: int, device) -> Dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"scale": torch.ones((c,), **f32), "bias": torch.zeros((c,), **f32),
            "mean": torch.zeros((c,), **f32), "var": torch.ones((c,), **f32)}


def init_params(generator: torch.Generator, cfg: CNNConfig,
                device) -> Dict:
    """Random parameters in the reference's tree: {"stem": {"w", "bn"},
    "stages": [[block, ...], ...], "head": [c, classes]}; a block holds
    w1, bn1, w2, bn2 and, where the width changes, proj. Truncated-normal
    weights (He for the convs), drawn from `generator`."""
    def conv_w(cin, cout):
        return trunc_normal((3, 3, cin, cout), math.sqrt(2.0 / (9 * cin)),
                            generator, device)

    p = {"stem": {"w": conv_w(cfg.in_channels, cfg.width),
                  "bn": _bn_init(cfg.width, device)},
         "stages": [], "head": None}
    c = cfg.width
    for si, n_blocks in enumerate(cfg.stages):
        cout = cfg.width * (2 ** si)
        stage = []
        for _ in range(n_blocks):
            blk = {"w1": conv_w(c, cout), "bn1": _bn_init(cout, device),
                   "w2": conv_w(cout, cout), "bn2": _bn_init(cout, device)}
            if c != cout:
                blk["proj"] = conv_w(c, cout)
            stage.append(blk)
            c = cout
        p["stages"].append(stage)
    p["head"] = trunc_normal((c, cfg.num_classes), math.sqrt(1.0 / c),
                             generator, device)
    return p


def forward(params: Dict, x: torch.Tensor, cfg: CNNConfig,
            ctx: Optional[QuantCtx] = None, train: bool = False):
    """x [B, H, W, C] -> (logits [B, classes], batch BN stats). The stem
    is never quantized (paper §5); the quantized sites are
    `s{stage}b{block}/conv1|conv2|proj`."""
    h = _conv(params["stem"]["w"], x, 1, "stem", None)
    h, s = _bn(params["stem"]["bn"], h, train)
    stats = {"stem": s}
    h = torch.relu(h)
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (bi == 0 and si > 0) else 1
            pre = ctx
            if pre is not None:
                pre = dataclasses.replace(pre, site_prefix=f"s{si}b{bi}/")
            hh = _conv(blk["w1"], h, stride, "conv1", pre)
            hh, s1 = _bn(blk["bn1"], hh, train)
            hh = torch.relu(hh)
            hh = _conv(blk["w2"], hh, 1, "conv2", pre)
            hh, s2 = _bn(blk["bn2"], hh, train)
            skip = h
            if "proj" in blk:
                skip = _conv(blk["proj"], h, stride, "proj", pre)
            h = torch.relu(hh + skip)
            stats[f"s{si}b{bi}"] = (s1, s2)
    pooled = torch.mean(h, dim=(1, 2))
    return torch.matmul(pooled, params["head"]), stats


def loss_fn(params: Dict, batch: Dict, cfg: CNNConfig,
            train: bool = True) -> torch.Tensor:
    logits, _ = forward(params, batch["image"], cfg, train=train)
    labels = F.one_hot(batch["label"].long(), cfg.num_classes).to(
        logits.dtype)
    return -torch.mean(torch.sum(labels * F.log_softmax(logits, -1), -1))


def accuracy(params: Dict, batch: Dict, cfg: CNNConfig,
             ctx: Optional[QuantCtx] = None) -> torch.Tensor:
    logits, _ = forward(params, batch["image"], cfg, ctx=ctx, train=False)
    return torch.mean((torch.argmax(logits, -1) ==
                       batch["label"]).to(torch.float32))


def _copy_tree(tree):
    """New dicts and lists around the same tensors."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def recalibrate_bn(params: Dict, batches, cfg: CNNConfig) -> Dict:
    """Paper §5: recompute the BN running statistics on the calibration
    set, as a cumulative average over its batches (momentum 1 / (i + 1)),
    so the result is the calibration set's statistics themselves. Returns
    a new tree; `params` is left as it was."""
    params = _copy_tree(params)

    def update(bn, mean, var, momentum):
        bn["mean"] = (1 - momentum) * bn["mean"] + momentum * mean
        bn["var"] = (1 - momentum) * bn["var"] + momentum * var

    for i, batch in enumerate(batches):
        momentum = 1.0 / (i + 1)
        _, stats = forward(params, batch["image"], cfg, train=True)
        update(params["stem"]["bn"], *stats["stem"], momentum)
        for si, stage in enumerate(params["stages"]):
            for bi, blk in enumerate(stage):
                (m1, v1), (m2, v2) = stats[f"s{si}b{bi}"]
                update(blk["bn1"], m1, v1, momentum)
                update(blk["bn2"], m2, v2, momentum)
    return params


def synthetic_dataset(generator: torch.Generator, cfg: CNNConfig, n: int,
                      device) -> Dict:
    """The reference's synthetic task: class = frequency and orientation
    of a grating with a random phase, plus Gaussian pixel noise. Drawn
    from `generator` (other numbers than `jax.random` gives)."""
    labels = torch.randint(0, cfg.num_classes, (n,), generator=generator,
                           device=device)
    S = cfg.img_size
    ar = torch.arange(S, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    cls = torch.arange(cfg.num_classes, device=device)
    freqs = 2 * math.pi * (1 + cls % 4).to(torch.float32) / 16.0
    angles = math.pi * (cls // 4).to(torch.float32) / 4.0
    f, a = freqs[labels], angles[labels]
    phase = torch.rand((n,), generator=generator, device=device) \
        * 2 * math.pi
    wave = torch.sin(f[:, None, None] *
                     (torch.cos(a)[:, None, None] * xx[None] +
                      torch.sin(a)[:, None, None] * yy[None])
                     + phase[:, None, None])
    img = wave[..., None].expand(n, S, S, cfg.in_channels)
    img = img + cfg.noise * torch.randn(img.shape, generator=generator,
                                        device=device)
    return {"image": img.to(torch.float32), "label": labels}
