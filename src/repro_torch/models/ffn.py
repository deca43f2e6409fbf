"""Feed-forward blocks (port of `repro.models.ffn`): SwiGLU (llama,
mistral), GELU (granite, starcoder2), GeGLU. Every matmul routes through
the SPARQ hook `dense`."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import QuantCtx, dense, init_dense

GATED = ("swiglu", "geglu")


def ffn_apply(params: Dict, x: torch.Tensor, mlp_type: str,
              ctx: Optional[QuantCtx] = None) -> torch.Tensor:
    # the reference's jax.nn.gelu(approximate=True) is the tanh form
    if mlp_type == "swiglu":
        h = F.silu(dense(params["w_gate"], x, "ffn_gate", ctx)) \
            * dense(params["w_up"], x, "ffn_up", ctx)
    elif mlp_type == "geglu":
        h = F.gelu(dense(params["w_gate"], x, "ffn_gate", ctx),
                   approximate="tanh") \
            * dense(params["w_up"], x, "ffn_up", ctx)
    elif mlp_type == "gelu":
        h = F.gelu(dense(params["w_up"], x, "ffn_up", ctx),
                   approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_type {mlp_type!r}")
    return dense(params["w_down"], h, "ffn_down", ctx)


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             n_layers: int, device, dtype=torch.float32) -> Dict:
    """f32 draws cast to `dtype`; `w_gate` only for the gated types."""
    out_scale = 1.0 / (2 * n_layers) ** 0.5
    p = {"w_up": init_dense(gen, d_model, d_ff, device, dtype=dtype),
         "w_down": init_dense(gen, d_ff, d_model, device, scale=out_scale,
                              dtype=dtype)}
    if mlp_type in GATED:
        p["w_gate"] = init_dense(gen, d_model, d_ff, device, dtype=dtype)
    return p
