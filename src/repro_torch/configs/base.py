"""The dry run's input shapes and input specs (port of
`repro.configs.base`). The registry stays in `repro_torch.configs`; its
names are re-exported here, where the reference's callers find them.

The four assigned LM shapes:

  train_4k     seq=4096   global_batch=256   (training, train_step)
  prefill_32k  seq=32768  global_batch=32    (inference prefill)
  decode_32k   seq=32768  global_batch=128   (one token, 32k KV cache)
  long_500k    seq=524288 global_batch=1     (one token, 500k state) —
               runs only for sub-quadratic archs (rwkv6, recurrentgemma);
               skipped for pure full-attention archs.

`input_specs` gives meta tensors in place of the reference's
`ShapeDtypeStruct`s: the shapes and dtypes of a step's inputs, with no
storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_reduced_config

__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "ShapeSpec", "cell_is_runnable",
           "get_config", "get_reduced_config", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs for which long_500k is runnable (sub-quadratic sequence mixing)
SUBQUADRATIC = ("rwkv6-7b", "recurrentgemma-9b")


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) dry-run cell."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("full-attention arch: 512k dense KV cache exceeds HBM "
                       "and published context; see DESIGN.md §4")
    return True, ""


def input_specs(cfg, shape: ShapeSpec,
                batch_override: Optional[int] = None) -> Dict:
    """Meta tensors standing in for every model input of a step: int32
    tokens and labels, bf16 "image_embeds" (vlm) and "frames" (enc-dec)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def tok(*s):
        return torch.empty(s, dtype=torch.int32, device="meta")

    def emb(*s):
        return torch.empty(s, dtype=torch.bfloat16, device="meta")

    if shape.kind == "train":
        if cfg.family == "vlm":
            P = cfg.frontend_len
            return {"image_embeds": emb(B, P, cfg.d_model),
                    "tokens": tok(B, S - P), "labels": tok(B, S - P)}
        if cfg.is_encdec:
            return {"frames": emb(B, S, cfg.d_model),
                    "tokens": tok(B, S), "labels": tok(B, S)}
        return {"tokens": tok(B, S), "labels": tok(B, S)}
    if shape.kind == "prefill":
        if cfg.family == "vlm":
            P = cfg.frontend_len
            return {"image_embeds": emb(B, P, cfg.d_model),
                    "tokens": tok(B, S - P)}
        if cfg.is_encdec:
            return {"frames": emb(B, S, cfg.d_model), "tokens": tok(B, S)}
        return {"tokens": tok(B, S)}
    # decode: one new token against a cache of S tokens
    return {"tokens": tok(B, 1)}
