"""Move the JAX package's parameters and calibrated scales into the port.

Both functions take numpy arrays — the caller converts a JAX tree with
`jax.tree.map(np.asarray, tree)` — so this module imports no jax. The
trees keep their layout: `params["blocks"][g]` holds layer-stacked
[L, ...] leaves, and prequantized weights are {"q": int8, "s": f32}
dicts, as `quantize_params` makes them in either package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(tree: Any, device="cpu") -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    tensors on `device`, dtypes kept (f32 stays f32, int8 codes int8)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":    # ml_dtypes' bf16: numpy has none
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(np_params: Any, device="cpu") -> Any:
    """JAX model params (as numpy) -> port params."""
    return to_torch(np_params, device)


def scales_from_jax(np_scales_groups, device="cpu") -> list:
    """JAX `Model.calibrate` output (as numpy: per group {site: (count,)})
    -> the port's scales_groups (f32 tensors)."""
    return [{site: torch.from_numpy(np.array(v, np.float32)).to(device)
             for site, v in group.items()} for group in np_scales_groups]
