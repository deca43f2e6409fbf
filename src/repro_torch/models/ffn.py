"""Feed-forward blocks (port of `repro.models.ffn`): SwiGLU (llama,
mistral), GELU (granite, starcoder2), GeGLU. Every matmul routes through
the SPARQ hook `dense`."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (QuantCtx, dense, dense_f32,
                                       init_dense, row_sum)

GATED = ("swiglu", "geglu")


def ffn_apply(params: Dict, x: torch.Tensor, mlp_type: str,
              ctx: Optional[QuantCtx] = None, mp=None) -> torch.Tensor:
    """The FFN of x. With `mp` (training; the leaves this rank's blocks
    of d_ff over the model axis) x enters through `copy_to`, the up and
    gate columns are this rank's, and `w_down`'s block sums the partial
    outputs (`row_sum`)."""
    if mp is None:
        def col(name, site):
            return dense(params[name], x, site, ctx)
    else:
        xf = mp.copy(x.to(torch.float32))

        def col(name, site):
            return dense_f32(params[name], xf, site, x.dtype).to(x.dtype)
    # the reference's jax.nn.gelu(approximate=True) is the tanh form
    if mlp_type == "swiglu":
        h = F.silu(col("w_gate", "ffn_gate")) * col("w_up", "ffn_up")
    elif mlp_type == "geglu":
        h = F.gelu(col("w_gate", "ffn_gate"), approximate="tanh") \
            * col("w_up", "ffn_up")
    elif mlp_type == "gelu":
        h = F.gelu(col("w_up", "ffn_up"), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_type {mlp_type!r}")
    if mp is not None:
        return row_sum(params["w_down"], h, "ffn_down", mp)
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
