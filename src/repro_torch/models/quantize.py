"""Offline weight quantization for serving (port of `repro.models.quantize`).

`quantize_params` replaces every projection weight leaf `w` with
{"q": int8 codes, "s": f32 per-output-channel scales}; embeddings, the LM
head and norms stay float (the paper leaves boundary layers intact).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.quantizer import div_qmax, quantize, weight_scale

_QUANT_KEYS = (
    "wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
    "w_r", "w_k", "w_v", "w_g", "w_o", "w_ck", "w_cr", "w_cv",
    "w_dkv", "w_uk", "w_uv", "w_y", "w_x", "w_a", "w_i", "w_out",
)


def _quantize_leaf(leaf: torch.Tensor, weight_bits: int) -> dict:
    if leaf.ndim == 2:
        qs = weight_scale(leaf, weight_bits)
        return {"q": quantize(leaf, qs).to(torch.int8),
                "s": qs.scale.to(torch.float32)}
    # stacked [L, din, dout]: per-layer per-channel scales [L, dout]
    s = div_qmax(torch.amax(torch.abs(leaf), dim=1),
                 (1 << (weight_bits - 1)) - 1)
    s = torch.clamp(s, min=1e-8)
    codes = torch.clamp(torch.round(leaf / s[:, None, :]),
                        -127, 127).to(torch.int8)
    return {"q": codes, "s": s.to(torch.float32)}


def quantize_params(params: Any, weight_bits: int = 8) -> Any:
    """Float param tree -> serving tree with int8 weight codes."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        if name in _QUANT_KEYS and torch.is_tensor(node) \
                and node.ndim in (2, 3):
            return _quantize_leaf(node, weight_bits)
        return node
    return walk(params)


def is_qweight(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def as_weight(w, dtype) -> torch.Tensor:
    """Dequantize a (possibly) quantized weight leaf to a float tensor."""
    if is_qweight(w):
        s = w["s"]
        if w["q"].ndim == 3 and s.ndim == 2:
            s = s[:, None, :]
        return (w["q"].to(torch.float32) * s).to(dtype)
    return w.to(dtype)
