"""Public model API (port of `repro.models.model`: dense and MoE decoders,
MLA among them, RWKV6, the RG-LRU hybrid, the enc-dec family (whisper: an
encoder stack over the batch's precomputed "frames", cross-attended by
every decoder layer) and the VLM family (paligemma: the batch's
precomputed "image_embeds" ahead of the tokens, a prefix attended both
ways)): init / forward / loss / calibrate / contiguous-cache prefill /
chunked prefill / decode step.

`Model(cfg, device)` runs on `cuda` unless the caller asks for another
device, and raises when no GPU is present and none was asked for.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.calibration import CalibBank
from repro_torch.models import transformer as tr
from repro_torch.models.cache import CacheConfig
from repro_torch.models.paging import meta_for
from repro_torch.models.common import (ModelConfig, QuantCtx,
                                       chunked_lm_loss, embed_tokens, norm,
                                       norm_init, sinusoidal_embed,
                                       trunc_normal, vocab_parallel_embed)

LB_COEF = 0.01
Z_COEF = 0.001


def stream_lengths(cfg: ModelConfig, batch: Dict) -> List[Tuple[str, int]]:
    """[(stream, T)] of a whole-sequence pass over `batch` (arrays or
    meta tensors): the decoder's (its tokens and a VLM's image prefix)
    and an enc-dec model's encoder's (its frames)."""
    T = tuple(batch["tokens"].shape)[1]
    if cfg.family == "vlm" and "image_embeds" in batch:
        T += tuple(batch["image_embeds"].shape)[1]
    out = [("decoder", T)]
    if cfg.is_encdec:
        out.append(("encoder", tuple(batch["frames"].shape)[1]))
    return out


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = tr.layer_kinds(cfg)
        self.groups_meta = tr._group_runs(self.kinds)

    # ------------------------------------------------------------ init
    def init_params(self, seed: int = 0, dtype=None,
                    blocks: Optional[Callable] = None) -> Dict:
        """Random params at any width, drawn from a torch.Generator seeded
        with `seed` on the model's device (the layout of the JAX params;
        the values differ from jax.random's). Weights and embeddings are
        in `dtype` (default `cfg.param_dtype`), norms in f32; every draw
        is f32, one layer at a time (an MoE expert bank one expert at a
        time), cast as it is stored. An enc-dec model also gets its
        encoder, "enc_blocks" (drawn as a stack of `n_enc_layers`, which
        sets its output projections' scale) and "enc_norm". On the meta
        device nothing is drawn: the tree of shapes.

        `blocks(path, shape)` -> slices keeps only those slices of each
        leaf (a rank's block on a mesh; path as `tree.flatten_with_path`
        gives it, shape the whole leaf's): the draws are the same, and a
        stacked leaf keeps its block of each layer as the layer is drawn."""
        cfg, dev = self.cfg, self.device
        dtype = cfg.param_dtype if dtype is None else dtype
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)

        def keep(path, tree):
            if blocks is None:
                return tree
            if isinstance(tree, dict):
                return {k: keep(path + (k,), v) for k, v in tree.items()}
            return tree[blocks(path, tuple(tree.shape))].clone()
        params: Dict[str, Any] = {
            "embed": keep(("embed",), trunc_normal(
                (cfg.vocab_size, cfg.d_model), 0.02, gen, dev, dtype)),
            "blocks": tr.stack_init(gen, cfg, self.kinds, dev, dtype,
                                    blocks=blocks, path=("blocks",)),
            "final_norm": keep(("final_norm",), norm_init(
                cfg.d_model, cfg.norm_type, dev)),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = keep(("lm_head",), trunc_normal(
                (cfg.d_model, cfg.vocab_size), 0.02, gen, dev, dtype))
        if cfg.is_encdec:
            params["enc_blocks"] = tr.stack_init(
                gen, cfg.replace(n_layers=cfg.n_enc_layers),
                ["enc"] * cfg.n_enc_layers, dev, dtype, blocks=blocks,
                path=("enc_blocks",))
            params["enc_norm"] = keep(("enc_norm",), norm_init(
                cfg.d_model, cfg.norm_type, dev))
        return params

    # ------------------------------------------------------------ pieces
    def _embed_in(self, params, tokens, dtype, mp=None, whole=False):
        """The scaled embeddings; with `mp` and `embed` this rank's block
        of the vocabulary, the lookup over the model axis. Under sequence
        parallelism (`mp.sp`) this rank's block of T, unless `whole`."""
        emb = params["embed"]
        if mp is not None and emb.shape[0] != self.cfg.vocab_size:
            x = vocab_parallel_embed(emb, tokens, dtype, mp, whole)
        else:
            x = embed_tokens(emb, tokens, dtype)
            if mp is not None and not whole:
                x = mp.shard(x)
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=dtype,
                                device=x.device)

    def _embed_batch(self, params, batch: Dict, mp=None):
        """(x, prefix_len): the scaled token embeddings, and for a VLM
        batch its "image_embeds" ahead of them, cast to the model dtype
        and not scaled; prefix_len is their row count (0 otherwise).
        Under sequence parallelism x is this rank's block of the stream's
        T."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        if not (cfg.family == "vlm" and "image_embeds" in batch):
            return self._embed_in(params, tokens, cfg.dtype, mp), 0
        x = self._embed_in(params, tokens, cfg.dtype, mp, whole=True)
        img = torch.as_tensor(batch["image_embeds"], device=self.device)
        x = torch.cat([img.to(cfg.dtype), x], 1)
        return (x if mp is None else mp.shard(x)), img.shape[1]

    def _encode(self, params, frames, ctx, mp=None):
        """The encoder over the frames [B, T, d]: the f32 sinusoidal
        positions added in the model dtype, the "enc" stack in mode train
        under `ctx` (no calibrated spans: a quantized ctx takes each
        site's dynamic range), then `enc_norm`. Under sequence
        parallelism the encoder's stream is split over T as the
        decoder's, and its output is made whole once, for the decoder's
        cross attention (an all-gather whose backward reduce-scatters)."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(cfg.dtype)
        B, T = x.shape[:2]
        x = x + sinusoidal_embed(T, cfg.d_model, self.device).to(cfg.dtype)
        sp = mp is not None and mp.sp
        x, _ = tr.stack_apply([("enc", cfg.n_enc_layers)],
                              params["enc_blocks"],
                              mp.shard(x) if sp else x, cfg,
                              positions=self._positions(B, T),
                              mode="train", ctx=ctx, mp=mp)
        x = norm(params["enc_norm"], x, cfg.norm_type, cfg.norm_eps)
        return mp.gather(x, 1) if sp else x

    def _inputs(self, params, batch: Dict, ctx, mp=None):
        """(x, prefix_len, enc_out) of a whole-sequence pass. Under
        sequence parallelism the model axis must divide every stream's
        T (`stream_lengths`): a ValueError otherwise, since the gradients
        of the leaves not split over "model" are summed there as partial
        (`distributed.fsdp`), which only a split stream makes them."""
        if mp is not None and mp.sp:
            whole = [f"the {k}'s T {t}" for k, t in
                     stream_lengths(self.cfg, batch) if t % mp.size]
            if whole:
                raise ValueError(
                    f"sequence parallelism over a model axis of {mp.size} "
                    f"does not divide {', '.join(whole)}: run the step "
                    f"with sp=False")
        x, prefix_len = self._embed_batch(params, batch, mp)
        enc_out = self._encode(params, batch["frames"], ctx, mp) \
            if self.cfg.is_encdec else None
        return x, prefix_len, enc_out

    def _head(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]
        return torch.matmul(x, w.to(x.dtype))

    def _positions(self, B: int, T: int) -> torch.Tensor:
        return torch.arange(T, device=self.device)[None].expand(B, T)

    # ------------------------------------------------------------ train
    def _forward(self, params, batch: Dict, ctx, scales_groups,
                 gather=None, experts=None):
        """(hidden states, prefix_len, the stack's summed aux terms).
        Under sequence parallelism the final norm runs on this rank's
        block of T and its output is made whole."""
        cfg = self.cfg
        mp = None if gather is None else gather.model_axis
        x, prefix_len, enc_out = self._inputs(params, batch, ctx, mp)
        sp = mp is not None and mp.sp
        x, aux = tr.stack_apply(self.groups_meta, params["blocks"], x, cfg,
                                positions=self._positions(
                                    x.shape[0],
                                    x.shape[1] * (mp.size if sp else 1)),
                                mode="train", ctx=ctx,
                                scales_groups=scales_groups,
                                prefix_len=prefix_len, enc_out=enc_out,
                                gather=None if gather is None
                                else gather.layer,
                                groups=experts, mp=mp)
        x = norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return (mp.gather(x, 1) if sp else x), prefix_len, aux

    def forward(self, params, batch: Dict, ctx: Optional[QuantCtx] = None,
                scales_groups=None) -> torch.Tensor:
        """Full-sequence hidden states (pre-head), a VLM's image prefix
        among them. batch["tokens"] [B, T] (and "frames" or
        "image_embeds")."""
        return self._forward(params, batch, ctx, scales_groups)[0]

    def logits(self, params, batch, ctx=None, scales_groups=None):
        """Logits of the token positions (a VLM's prefix cut)."""
        x, prefix_len, _ = self._forward(params, batch, ctx, scales_groups)
        return self._head(params, x[:, prefix_len:])

    def loss(self, params, batch: Dict, ctx: Optional[QuantCtx] = None,
             scales_groups=None, gather=None,
             experts=None) -> Tuple[torch.Tensor, Dict]:
        """Next-token CE of batch["tokens"] against batch["labels"] (-1
        ignored), the vocab projection `cfg.logit_chunk` positions at a
        time, plus LB_COEF x the MoE layers' load-balance loss and Z_COEF
        x their router z-loss (both 0 for a dense stack). Returns (total,
        metrics).

        `gather` (a `distributed.fsdp.FSDP`) takes `params` as a rank's
        blocks and `batch` as its rows: the leaves outside the layer
        stacks are made whole here, each layer's inside its remat body
        (`gather.layer`). `experts` (the `distributed.expert.ExpertGroups`
        that `gather.rows` returns beside the rows) makes the MoE layers
        route over the whole microbatch, their experts split over "model"
        where the banks are. Where `gather` splits leaves over the model
        axis (`gather.model_axis`), each layer computes on its blocks
        (column and row products, heads, experts) and the embedding and
        the loss on this rank's block of the vocabulary. Under sequence
        parallelism (`gather.model_axis.sp`) the stream between the
        blocks is this rank's block of T, and a head that is not split
        passes 1/m of the loss's gradient (`ModelAxis.partial`)."""
        cfg = self.cfg
        if gather is not None:
            params = gather.outside(params)
        mp = None if gather is None else gather.model_axis
        x, prefix_len, aux = self._forward(params, batch, ctx, scales_groups,
                                           gather, experts)
        x = x[:, prefix_len:]
        labels = torch.as_tensor(batch["labels"], device=self.device)
        head = params["embed"].T if cfg.tie_embeddings \
            else params["lm_head"]
        split = mp is not None and head.shape[1] != cfg.vocab_size
        lm = chunked_lm_loss(head, x, labels, cfg.logit_chunk or x.shape[1],
                             mp if split else None)
        if mp is not None and not split:
            lm = mp.partial(lm)
        total = lm + LB_COEF * aux["lb_loss"] + Z_COEF * aux["z_loss"]
        return total, {"lm_loss": lm, **aux}

    # ------------------------------------------------------------ serve
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   cache_cfg=None, mesh=None) -> list:
        """Decode-time caches, one per layer, on the model's device.
        `cache_cfg` (models.cache.CacheConfig) selects the layout of the
        KV planes: fp (in `dtype` when no config is given) or sparq (§5.1
        packed). Recurrent states are stored in the fp layout's dtype, or
        in `dtype` under the sparq layout, as the reference's. `mesh` (a
        `launch.mesh.TPMesh`, its lead the model's device) shards the
        dense layers' sparq planes on their KV heads: decode then reads
        them through K5 once a shard."""
        cc = cache_cfg or CacheConfig(layout="fp", dtype=dtype)
        return tr.stack_cache_init(self.cfg, self.kinds, batch, max_len,
                                   self.device, cc, dtype, mesh=mesh)

    def prefill(self, params, batch: Dict, caches,
                ctx: Optional[QuantCtx] = None, scales_groups=None):
        """Process the prompt batch["tokens"] [B, T] into the contiguous
        `caches` (written in place): a VLM's image prefix ahead of it, an
        enc-dec model's frames through the encoder (under `ctx`, without
        calibrated spans), whose output every decoder layer's cache keeps
        for cross attention. Returns the last token's logits [B, V]."""
        cfg = self.cfg
        x, prefix_len, enc_out = self._inputs(params, batch, ctx)
        x, _ = tr.stack_apply(self.groups_meta, params["blocks"], x, cfg,
                              positions=self._positions(*x.shape[:2]),
                              caches=caches, mode="prefill", ctx=ctx,
                              scales_groups=scales_groups,
                              prefix_len=prefix_len, enc_out=enc_out)
        x = norm(params["final_norm"], x[:, -1:], cfg.norm_type,
                 cfg.norm_eps)
        return self._head(params, x)[:, 0]

    def prefill_chunk(self, params, tokens, caches, chunk, last_rows,
                      ctx: Optional[QuantCtx] = None, scales_groups=None):
        """One chunk of the packed ragged-prefill stream. tokens [1, C];
        `chunk` a paging.ChunkMeta (under TP one a shard device,
        `paging.meta_for`); `last_rows` [S] the stream row of each
        slot's final prompt token (-1: prefill incomplete). Every layer
        writes the chunk's K/V into §5.1 pages and attends over chunk +
        pages. Returns tok0 [S] int32, the greedy token at each slot's last
        prompt row (garbage where last_rows < 0)."""
        cfg = self.cfg
        x = self._embed_in(params, tokens, cfg.dtype)
        pos = meta_for(chunk, tokens.device).pos
        x, _ = tr.stack_apply(self.groups_meta, params["blocks"], x, cfg,
                              positions=pos[None, :], caches=caches,
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
        x, _ = tr.stack_apply(self.groups_meta, params["blocks"], x, cfg,
                              positions=positions, caches=caches,
                              mode="decode", ctx=ctx,
                              scales_groups=scales_groups)
        x = norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return self._head(params, x)[:, 0]

    # ------------------------------------------------------------ PTQ
    def quant_sites(self) -> List[str]:
        """Every `dense` site name of the family (the reference lists the
        FFN sites for MoE too, though its experts never reach `dense`;
        with MLA they are the first dense layers' FFN). The enc-dec and
        VLM families take the dense list."""
        if self.cfg.family == "rwkv6":
            return ["tm_r", "tm_k", "tm_v", "tm_g", "tm_out",
                    "cm_k", "cm_r", "cm_v"]
        if self.cfg.family == "rglru":
            return ["rg_gate", "rg_in", "rg_rgate", "rg_igate", "rg_out",
                    "attn_q", "attn_k", "attn_v", "attn_out",
                    "ffn_gate", "ffn_up", "ffn_down"]
        if self.cfg.kv_lora_rank:
            return ["mla_q", "mla_dkv", "mla_uk", "mla_uv", "mla_out",
                    "ffn_gate", "ffn_up", "ffn_down"]
        return ["attn_q", "attn_k", "attn_v", "attn_out",
                "ffn_gate", "ffn_up", "ffn_down"]

    @torch.no_grad()
    def calibrate(self, params, batches: Iterable[Dict],
                  signed: bool = True) -> list:
        """Eager per-layer min-max calibration (paper §5) of the decoder
        stack (an enc-dec model's encoder runs in float, unobserved).
        Returns `scales_groups`: per layer group, {site: (count,) f32
        tensor} of calibrated spans (divided by qmax at use)."""
        cfg = self.cfg
        bank = CalibBank()
        for batch in batches:
            x, prefix_len, enc_out = self._inputs(params, batch,
                                                  QuantCtx(mode="off"))
            positions = self._positions(*x.shape[:2])
            for gi, ((kind, count), stacked) in enumerate(
                    zip(self.groups_meta, params["blocks"])):
                for li in range(count):
                    ctx = QuantCtx(mode="calibrate", collect=bank,
                                   site_prefix=f"g{gi}.l{li}/")
                    x, _, _ = tr.block_apply(
                        tr.layer_params(stacked, li), x, cfg, kind,
                        positions=positions, mode="train", ctx=ctx,
                        prefix_len=prefix_len, enc_out=enc_out)
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
