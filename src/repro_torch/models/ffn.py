"""SwiGLU feed-forward block (port of `repro.models.ffn`, swiglu only)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import QuantCtx, dense, init_dense


def ffn_apply(params: Dict, x: torch.Tensor, mlp_type: str,
              ctx: Optional[QuantCtx] = None) -> torch.Tensor:
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported")
    g = dense(params["w_gate"], x, "ffn_gate", ctx)
    u = dense(params["w_up"], x, "ffn_up", ctx)
    return dense(params["w_down"], F.silu(g) * u, "ffn_down", ctx)


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, n_layers: int,
             device) -> Dict:
    out_scale = 1.0 / (2 * n_layers) ** 0.5
    return {"w_up": init_dense(gen, d_model, d_ff, device),
            "w_down": init_dense(gen, d_ff, d_model, device, scale=out_scale),
            "w_gate": init_dense(gen, d_model, d_ff, device)}
