"""Shared model machinery (port of `repro.models.common`): config,
quantization context, and the primitive layers.

Params are nested dicts of tensors laid out as in the JAX package; every
matmul of the network routes through `dense()`, where SPARQ plugs in (off,
calibrate to collect per-site activation statistics, quantized serving).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.calibration import CalibBank
from repro_torch.core.quantizer import (QScale, div_qmax, quantize,
                                        weight_scale)
from repro_torch.core.sparq import SparqConfig, sparq_dot_stc
from repro_torch.kernels.ops import quantized_matmul


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Dense decoder configuration (the fields of the JAX ModelConfig that
    the dense family reads)."""
    name: str
    family: str                  # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"     # swiglu | gelu | geglu
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    logit_chunk: int = 0         # 0 = unchunked loss
    attn_chunk: int = 1024       # flash-style KV chunk in train/prefill
    train_microbatches: int = 1  # gradient accumulation (activation memory)
    remat: bool = True           # recompute each layer in the backward
    param_dtype: Any = torch.float32   # of the weights; bf16 for >100B

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class QuantCtx:
    """How matmuls execute. `scales[site]` is a per-layer 0-d f32 tensor
    (the calibrated span, divided by qmax at use). Sites in `skip_sites`
    run in float; `stc` runs the quantized mode through the sparse-tensor-
    core simulation (`core.sparq.sparq_dot_stc`, plain PyTorch on every
    device) instead of K1, for 2:4-pruned weights."""
    mode: str = "off"                     # off | calibrate | quantized
    cfg: Optional[SparqConfig] = None
    scales: Optional[Dict[str, Any]] = None
    collect: Optional[CalibBank] = None
    skip_sites: tuple[str, ...] = ()      # paper: first layer left intact
    site_prefix: str = ""                 # per-layer prefix (calibration)
    stc: bool = False                     # sparse-TC path (2:4-pruned w)


def dense(w, x: torch.Tensor, site: str,
          ctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out] through the quantization hook. `w`
    is a float tensor or a prequantized {"q": int8, "s": f32} leaf."""
    from repro_torch.models.quantize import as_weight, is_qweight
    if ctx is None or ctx.mode == "off" or site in ctx.skip_sites:
        return torch.matmul(x, as_weight(w, x.dtype))
    if ctx.mode == "calibrate":
        if ctx.collect is not None:
            ctx.collect.observe(ctx.site_prefix + site, x)
        return torch.matmul(x, as_weight(w, x.dtype))
    if ctx.mode == "quantized":
        cfg = ctx.cfg or SparqConfig.a8w8()
        scale = None
        if ctx.scales:
            scale = ctx.scales.get(ctx.site_prefix + site,
                                   ctx.scales.get(site))
        if scale is None:
            scale = torch.amax(torch.abs(x))   # dynamic per-tensor fallback
        act_qs = QScale(
            scale=div_qmax(torch.as_tensor(scale, dtype=torch.float32,
                                           device=x.device), cfg.max_val),
            bits=cfg.act_bits, signed=cfg.signed)
        if ctx.stc:
            return sparq_dot_stc(x, as_weight(w, torch.float32), act_qs,
                                 cfg).to(x.dtype)
        if is_qweight(w):
            w_codes, chan_scale = w["q"], w["s"]
        else:
            w_qs = weight_scale(w, cfg.weight_bits)
            w_codes = quantize(w, w_qs).to(torch.int8)
            chan_scale = w_qs.scale
        return quantized_matmul(x, w_codes, act_qs, chan_scale,
                                cfg).to(x.dtype)
    raise ValueError(ctx.mode)


# ----------------------------------------------------------------------
# primitive layers
# ----------------------------------------------------------------------

def norm(params: Dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """RMSNorm with the reference's `1 + scale` gain, or LayerNorm with
    scale and bias (population variance, as `jnp.var`), computed in f32."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (xf * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)
    if kind != "layernorm":
        raise ValueError(f"unknown norm_type {kind!r}")
    xc = xf - torch.mean(xf, -1, keepdim=True)
    xf = xc * torch.rsqrt(torch.mean(xc * xc, -1, keepdim=True) + eps)
    return (xf * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(x.dtype)


def norm_init(d: int, kind: str, device) -> Dict:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=torch.float32,
                                     device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last axis, computed in f32.
    x [B, T, H, hd]; positions [B, T]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq      # [B, T, half]
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return rot.to(x.dtype)


def trunc_normal(shape, std: float, generator: torch.Generator,
                 device, dtype=torch.float32) -> torch.Tensor:
    """Truncated normal on [-2, 2], times `std` (jax.random.truncated_normal
    semantics; the draws themselves differ between frameworks)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               device, scale: float = 1.0,
               dtype=torch.float32) -> torch.Tensor:
    return trunc_normal((d_in, d_out), scale / math.sqrt(d_in), generator,
                        device, dtype)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    return emb[tokens.long()].to(dtype)


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor,
             ignore: int = -1):
    """(sum of -log p(label), count) over the positions whose label is
    not `ignore`, from logits [..., V] in f32."""
    lse = torch.logsumexp(logits, dim=-1)
    # the label's logit by row indexing, whose backward (an accumulating
    # index_put) has a deterministic CUDA path; gather's scatter_add has none
    flat = logits.reshape(-1, logits.shape[-1])
    rows = torch.arange(flat.shape[0], device=logits.device)
    gold = flat[rows, torch.clamp(labels, min=0).reshape(-1).long()
                ].reshape(labels.shape)
    mask = (labels != ignore).to(torch.float32)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore: int = -1) -> torch.Tensor:
    """Mean CE over non-ignored positions. logits [..., V], labels [...]."""
    s, c = _nll_sum(logits.to(torch.float32), labels, ignore)
    return s / torch.clamp(c, min=1.0)


def chunked_lm_loss(emb_out: torch.Tensor, x: torch.Tensor,
                    labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """CE loss of x [B, T, D] projected by emb_out [D, V], one sequence
    chunk of `chunk` positions at a time (the reference's scan), so the
    [T, V] logits are never whole; unchunked when `chunk` does not split
    T into two or more chunks."""
    B, T, D = x.shape
    if chunk <= 0 or T % chunk != 0 or T == chunk:
        logits = torch.matmul(x, emb_out.to(x.dtype))
        return cross_entropy_loss(logits, labels)
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    c = torch.zeros((), dtype=torch.float32, device=x.device)
    for t0 in range(0, T, chunk):
        logits = torch.matmul(x[:, t0:t0 + chunk],
                              emb_out.to(x.dtype)).to(torch.float32)
        ds, dc = _nll_sum(logits, labels[:, t0:t0 + chunk])
        s, c = s + ds, c + dc
    return s / torch.clamp(c, min=1.0)
