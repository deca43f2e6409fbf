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
    """Model configuration (the fields of the JAX ModelConfig that the
    dense, MoE (MLA among them), RWKV6, RG-LRU, enc-dec and VLM families
    read)."""
    name: str
    family: str                  # dense | moe | rwkv6 | rglru | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"     # swiglu | gelu | geglu
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    rope_theta: float = 10000.0
    use_rope: bool = True
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # deepseek: first k layers use dense FFN
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- RWKV6 ---
    head_size: int = 64
    decay_lora: int = 64
    # --- RG-LRU hybrid (recurrentgemma) ---
    block_pattern: tuple[str, ...] = ()   # ("rg_rec", "rg_rec", "rg_attn")
    lru_width: int = 0
    local_window: int = 2048
    conv_width: int = 4
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    # --- modality front-end stubs (precomputed embeddings) ---
    frontend: str = "none"       # none | vision | audio
    frontend_len: int = 0
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    logit_chunk: int = 0         # 0 = unchunked loss
    attn_chunk: int = 1024       # flash-style KV chunk in train/prefill
    mixer_impl: str = "chunked"  # rwkv/rglru sequence mixer: scan | chunked
    mixer_chunk: int = 16        # keeps chunked-WKV decay factors in f32
    train_microbatches: int = 1  # gradient accumulation (activation memory)
    remat: bool = True           # recompute each layer in the backward
    param_dtype: Any = torch.float32   # of the weights; bf16 for >100B
    tensor_parallel: bool = True  # False: pure ZeRO-DP over all axes
                                  # (the dry run's choice for <~5B models)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

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


def dense_f32(w, x: torch.Tensor, site: str, dtype) -> torch.Tensor:
    """x @ w for a product split over the model axis in training: x in f32
    holding `dtype` values, the weight rounded to `dtype`, the product in
    f32 (the products of `dtype` operands are exact there). A column
    product rounds it to `dtype`, as one device's product does; a row
    product's partial stays f32 until its sum over the axis
    (`row_sum`), so the sum rounds once. `site` names the product (no
    quantization hook: the train path only)."""
    from repro_torch.models.quantize import as_weight
    return torch.matmul(x, as_weight(w, dtype).to(torch.float32))


def row_sum(w, x: torch.Tensor, site: str, mp) -> torch.Tensor:
    """The row-parallel end of a split product: this rank's partial of
    x @ w (x's last dimension and w's rows this rank's block) in f32,
    summed over the model axis (`mp`, a `distributed.tensor.ModelAxis`;
    under sequence parallelism this rank's block of T of the sum) and
    rounded to x's dtype once."""
    return mp.sum_out(dense_f32(w, x.to(torch.float32), site,
                                x.dtype)).to(x.dtype)


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


def sinusoidal_embed(T: int, d: int, device) -> torch.Tensor:
    """[T, d] f32: sin of position / 10000^(2i/d) in the first d/2
    features, cos in the rest (the encoder's positions)."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


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


def vocab_parallel_embed(emb: torch.Tensor, tokens: torch.Tensor, dtype,
                         mp, whole: bool = False) -> torch.Tensor:
    """`embed_tokens` over a vocabulary split on the model axis: `emb` is
    this rank's block of V/m rows; each rank looks up the tokens it holds,
    zeros elsewhere, and the sum over the axis (one nonzero term a token,
    so exact) is the whole lookup: under sequence parallelism this rank's
    block of T (a reduce-scatter), or with `whole` every row."""
    Vl = emb.shape[0]
    local = tokens.long() - mp.index * Vl
    mine = (local >= 0) & (local < Vl)
    rows = emb[torch.where(mine, local, 0)] * mine[..., None].to(emb.dtype)
    return (mp.sum_whole if whole else mp.sum_out)(rows).to(dtype)


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


def _vocab_parallel_nll_sum(logits: torch.Tensor, labels: torch.Tensor,
                            mp, ignore: int = -1):
    """`_nll_sum` of logits [..., V/m] f32, this rank's block of the
    vocabulary: the max over the axis (an all-reduce MAX, detached), the
    sum of exp and the label's logit (from the rank that holds it)
    through `reduce_from`."""
    Vl = logits.shape[-1]
    top = mp.max(torch.amax(logits, -1))
    lse = top + torch.log(mp.reduce(torch.sum(
        torch.exp(logits - top[..., None]), -1)))
    flat = logits.reshape(-1, Vl)
    rows = torch.arange(flat.shape[0], device=logits.device)
    local = labels.reshape(-1).long() - mp.index * Vl
    mine = (local >= 0) & (local < Vl)
    gold = mp.reduce((flat[rows, torch.where(mine, local, 0)]
                      * mine.to(flat.dtype)).reshape(labels.shape))
    mask = (labels != ignore).to(torch.float32)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore: int = -1) -> torch.Tensor:
    """Mean CE over non-ignored positions. logits [..., V], labels [...]."""
    s, c = _nll_sum(logits.to(torch.float32), labels, ignore)
    return s / torch.clamp(c, min=1.0)


def chunked_lm_loss(emb_out: torch.Tensor, x: torch.Tensor,
                    labels: torch.Tensor, chunk: int,
                    mp=None) -> torch.Tensor:
    """CE loss of x [B, T, D] projected by emb_out [D, V], one sequence
    chunk of `chunk` positions at a time (the reference's scan), so the
    [T, V] logits are never whole; unchunked when `chunk` does not split
    T into two or more chunks. With `mp` (a `distributed.tensor.
    ModelAxis`) emb_out is this rank's [D, V/m] block of the vocabulary:
    x enters through `copy_to` and each chunk's CE is taken over the axis
    (`_vocab_parallel_nll_sum`)."""
    B, T, D = x.shape
    if mp is None:
        def logits_of(xc):
            return torch.matmul(xc, emb_out.to(xc.dtype)).to(torch.float32)
        nll = _nll_sum
    else:
        dt = x.dtype
        x = mp.copy(x.to(torch.float32))

        def logits_of(xc):
            return dense_f32(emb_out, xc, "lm_head", dt).to(dt).to(
                torch.float32)

        def nll(logits, labels):
            return _vocab_parallel_nll_sum(logits, labels, mp)
    if chunk <= 0 or T % chunk != 0 or T == chunk:
        s, c = nll(logits_of(x), labels)
        return s / torch.clamp(c, min=1.0)
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    c = torch.zeros((), dtype=torch.float32, device=x.device)
    for t0 in range(0, T, chunk):
        ds, dc = nll(logits_of(x[:, t0:t0 + chunk]),
                     labels[:, t0:t0 + chunk])
        s, c = s + ds, c + dc
    return s / torch.clamp(c, min=1.0)
