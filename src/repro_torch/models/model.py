"""Public model API (port of `repro.models.model`, dense decoders):
init / forward / loss / calibrate / contiguous-cache prefill / chunked
prefill / decode step.

`Model(cfg, device)` runs on `cuda` unless the caller asks for another
device, and raises when no GPU is present and none was asked for.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.calibration import CalibBank
from repro_torch.models import transformer as tr
from repro_torch.models.cache import CacheConfig
from repro_torch.models.common import (ModelConfig, QuantCtx,
                                       chunked_lm_loss, embed_tokens, norm,
                                       norm_init, trunc_normal)

LB_COEF = 0.01
Z_COEF = 0.001


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = tr.layer_kinds(cfg)
        self.groups_meta = tr._group_runs(self.kinds)

    # ------------------------------------------------------------ init
    def init_params(self, seed: int = 0) -> Dict:
        """Random f32 params at any width, drawn from a torch.Generator
        seeded with `seed` on the model's device (the layout of the JAX
        params; the values differ from jax.random's)."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params: Dict[str, Any] = {
            "embed": trunc_normal((cfg.vocab_size, cfg.d_model), 0.02, gen,
                                  dev),
            "blocks": tr.stack_init(gen, cfg, self.kinds, dev),
            "final_norm": norm_init(cfg.d_model, cfg.norm_type, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = trunc_normal((cfg.d_model, cfg.vocab_size),
                                             0.02, gen, dev)
        return params

    # ------------------------------------------------------------ pieces
    def _embed_in(self, params, tokens, dtype):
        x = embed_tokens(params["embed"], tokens, dtype)
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=dtype,
                                device=x.device)

    def _head(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]
        return torch.matmul(x, w.to(x.dtype))

    def _positions(self, B: int, T: int) -> torch.Tensor:
        return torch.arange(T, device=self.device)[None].expand(B, T)

    # ------------------------------------------------------------ train
    def forward(self, params, batch: Dict, ctx: Optional[QuantCtx] = None,
                scales_groups=None) -> torch.Tensor:
        """Full-sequence hidden states (pre-head). batch["tokens"] [B, T]."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = self._embed_in(params, tokens, cfg.dtype)
        x = tr.stack_apply(self.groups_meta, params["blocks"], x, cfg,
                           positions=self._positions(*tokens.shape),
                           mode="train", ctx=ctx,
                           scales_groups=scales_groups)
        return norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)

    def logits(self, params, batch, ctx=None, scales_groups=None):
        return self._head(params, self.forward(params, batch, ctx,
                                               scales_groups))

    def loss(self, params, batch: Dict, ctx: Optional[QuantCtx] = None,
             scales_groups=None) -> Tuple[torch.Tensor, Dict]:
        """Next-token CE of batch["tokens"] against batch["labels"] (-1
        ignored), the vocab projection `cfg.logit_chunk` positions at a
        time. Returns (total, metrics); the dense family's load-balance
        and z terms are 0, so total == lm_loss."""
        cfg = self.cfg
        x = self.forward(params, batch, ctx, scales_groups)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        head = params["embed"].T if cfg.tie_embeddings \
            else params["lm_head"]
        lm = chunked_lm_loss(head, x, labels, cfg.logit_chunk or x.shape[1])
        aux = {"lb_loss": torch.zeros((), device=self.device),
               "z_loss": torch.zeros((), device=self.device)}
        total = lm + LB_COEF * aux["lb_loss"] + Z_COEF * aux["z_loss"]
        return total, {"lm_loss": lm, **aux}

    # ------------------------------------------------------------ serve
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   cache_cfg=None) -> list:
        """Contiguous decode-time caches, one per layer, on the model's
        device. `cache_cfg` (models.cache.CacheConfig) selects the layout:
        fp (in `dtype` when no config is given) or sparq (§5.1 packed)."""
        cc = cache_cfg or CacheConfig(layout="fp", dtype=dtype)
        return tr.stack_cache_init(self.cfg, self.kinds, batch, max_len,
                                   self.device, cc)

    def prefill(self, params, batch: Dict, caches,
                ctx: Optional[QuantCtx] = None, scales_groups=None):
        """Process the prompt batch["tokens"] [B, T] into the contiguous
        `caches` (written in place). Returns the last token's logits
        [B, V]."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = self._embed_in(params, tokens, cfg.dtype)
        x = tr.stack_apply(self.groups_meta, params["blocks"], x, cfg,
                           positions=self._positions(*tokens.shape),
                           caches=caches, mode="prefill", ctx=ctx,
                           scales_groups=scales_groups)
        x = norm(params["final_norm"], x[:, -1:], cfg.norm_type,
                 cfg.norm_eps)
        return self._head(params, x)[:, 0]

    def prefill_chunk(self, params, tokens, caches, chunk, last_rows,
                      ctx: Optional[QuantCtx] = None, scales_groups=None):
        """One chunk of the packed ragged-prefill stream. tokens [1, C];
        `chunk` a paging.ChunkMeta; `last_rows` [S] the stream row of each
        slot's final prompt token (-1: prefill incomplete). Every layer
        writes the chunk's K/V into §5.1 pages and attends over chunk +
        pages. Returns tok0 [S] int32, the greedy token at each slot's last
        prompt row (garbage where last_rows < 0)."""
        cfg = self.cfg
        x = self._embed_in(params, tokens, cfg.dtype)
        x = tr.stack_apply(self.groups_meta, params["blocks"], x, cfg,
                           positions=chunk.pos[None, :], caches=caches,
                           mode="chunk_prefill", ctx=ctx,
                           scales_groups=scales_groups, chunk=chunk)
        rows = x[0, torch.clamp(last_rows, min=0).long()]        # [S, d]
        h = norm(params["final_norm"], rows, cfg.norm_type, cfg.norm_eps)
        return torch.argmax(self._head(params, h), -1).to(torch.int32)

    def decode_step(self, params, tokens, caches, pos,
                    ctx: Optional[QuantCtx] = None, scales_groups=None):
        """One token for every sequence. tokens [S, 1]; pos the position of
        the new token: a 0-d tensor (uniform batch, the scan engine) or
        [S] (paged continuous batching, per slot). Returns logits [S, V]."""
        cfg = self.cfg
        x = self._embed_in(params, tokens, cfg.dtype)
        positions = pos.reshape(-1, 1).expand(x.shape[0], 1)
        x = tr.stack_apply(self.groups_meta, params["blocks"], x, cfg,
                           positions=positions, caches=caches, mode="decode",
                           ctx=ctx, scales_groups=scales_groups)
        x = norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return self._head(params, x)[:, 0]

    # ------------------------------------------------------------ PTQ
    def quant_sites(self) -> List[str]:
        return ["attn_q", "attn_k", "attn_v", "attn_out",
                "ffn_gate", "ffn_up", "ffn_down"]

    @torch.no_grad()
    def calibrate(self, params, batches: Iterable[Dict],
                  signed: bool = True) -> list:
        """Eager per-layer min-max calibration (paper §5). Returns
        `scales_groups`: per layer group, {site: (count,) f32 tensor} of
        calibrated spans (divided by qmax at use)."""
        cfg = self.cfg
        bank = CalibBank()
        for batch in batches:
            tokens = torch.as_tensor(batch["tokens"], device=self.device)
            x = self._embed_in(params, tokens, cfg.dtype)
            positions = self._positions(*tokens.shape)
            for gi, ((kind, count), stacked) in enumerate(
                    zip(self.groups_meta, params["blocks"])):
                for li in range(count):
                    ctx = QuantCtx(mode="calibrate", collect=bank,
                                   site_prefix=f"g{gi}.l{li}/")
                    x, _ = tr.block_apply(tr.layer_params(stacked, li), x,
                                          cfg, kind, positions=positions,
                                          mode="train", ctx=ctx)
        groups = []
        for gi, (kind, count) in enumerate(self.groups_meta):
            sites: Dict[str, list] = {}
            for name, obs in bank.observers.items():
                if not name.startswith(f"g{gi}."):
                    continue
                li = int(name.split(".l")[1].split("/")[0])
                site = name.split("/")[1]
                span = max(abs(obs.max_val), abs(obs.min_val)) if signed \
                    else obs.max_val
                sites.setdefault(site, [0.0] * count)[li] = float(span)
            groups.append({s: torch.tensor(v, dtype=torch.float32,
                                           device=self.device)
                           for s, v in sites.items()})
        return groups
