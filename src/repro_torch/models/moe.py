"""Mixture-of-Experts with capacity-based slotting (port of
`repro.models.moe`).

Top-k token-choice routing over an f32 router. Each (token, k) assignment
takes the next free slot of its expert, in the order of the flattened
[N, K] assignments; assignments past an expert's capacity C drop to the
residual path. Tokens are gathered into an (E, C, D) buffer, the experts
run as batched matrix products, and each token sums its kept expert
outputs. The expert products are plain batched products in the reference
too (no Pallas kernel), so they stay `torch.bmm`. Aux terms: the
Switch-style load balance and the router z-loss.

Two behaviours of the reference's scatters are kept exactly:
  * the slot table is written with the dropped assignments pointing at
    slot C - 1 with the empty marker, after the kept ones, so an expert
    that overflows loses its last kept slot too;
  * the combine adds each token's expert outputs in ascending expert
    order, rounding to the activation dtype after each add. Here that is
    K vector adds in a fixed order, never an atomic scatter-add, so the
    sum is the same on every run and every device.

Sharded (`groups`, a `distributed.expert.ExpertGroups`, in training on a
mesh) the layer computes what the reference computes over the whole
microbatch: C from the global token count, each assignment's slot its
place among all earlier global assignments to its expert (the counts of
the ranks before this one, gathered, plus its local place), the
last-slot quirk wherever an expert overflows globally, and the load-
balance term from the global density times the local mean probability
(the dp mean of the ranks' terms is the reference's term). Where the
banks arrive split over "model" ([E/m, ...]), a rank runs only its
experts over the group's tokens and the partial outputs are summed over
the group in f32 and rounded to the activation dtype once; the tokens
and gates enter the experts through `copy_to`, so the router and every
layer below get the whole gradient.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, QuantCtx, init_dense,
                                       trunc_normal)
from repro_torch.models.ffn import GATED


def _expert_ffn(wg, wu, wd, x: torch.Tensor, mlp_type: str,
                dtype=None) -> torch.Tensor:
    """x [E, C, D]; weights [E, D, F] / [E, F, D] in any dtype. With
    `dtype` (a block of F split over the model axis: x f32 holding
    `dtype` values) every product takes the weights rounded to `dtype`
    with an f32 result, the hidden rounded to `dtype`, and the down
    product's f32 partial is returned."""
    if dtype is not None:
        def mm(a, w):
            return torch.bmm(a, w.to(dtype).to(torch.float32)).to(dtype)
        up, gate = mm(x, wu), mm(x, wg) if mlp_type in GATED else None
        h = _act(gate, up, mlp_type).to(torch.float32)
        return torch.bmm(h, wd.to(dtype).to(torch.float32))
    up = torch.bmm(x, wu.to(x.dtype))
    gate = torch.bmm(x, wg.to(x.dtype)) if mlp_type in GATED else None
    return torch.bmm(_act(gate, up, mlp_type), wd.to(x.dtype))


def _act(gate, up, mlp_type: str) -> torch.Tensor:
    if mlp_type in GATED:
        act = F.silu(gate) if mlp_type == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        return act * up
    if mlp_type == "gelu":
        return F.gelu(up, approximate="tanh")
    raise ValueError(f"unknown mlp_type {mlp_type!r}")


def route(x2: torch.Tensor, router: torch.Tensor, K: int):
    """(logits [N, E] f32, probs [N, E], gates [N, K] renormalised,
    expert ids [N, K] int64). Ties go to the lower expert id, as
    `lax.top_k` breaks them: a stable descending sort."""
    logits = torch.matmul(x2.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :K], ids[:, :K]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, -1, keepdim=True), min=1e-9)
    return logits, probs, gate_vals, expert_ids


def capacity(N: int, cfg: ModelConfig, exact: bool) -> int:
    if exact:
        return N
    return min(N, max(int(N * cfg.experts_per_token / cfg.n_experts
                          * cfg.capacity_factor), 1))


def global_slots(expert_ids: torch.Tensor, before: torch.Tensor,
                 total: torch.Tensor, C: int):
    """(slot [N*K], kept [N*K] bool) of a rank's flattened assignments:
    each one's place in its expert's queue over the whole microbatch (its
    local place plus `before[e]`, the assignments to e of the rows ahead
    of this rank's), and whether it lands in the slot table of capacity
    C given `total[e]`, the microbatch's assignments to e."""
    flat = expert_ids.reshape(-1)
    onehot = F.one_hot(flat, total.shape[0]).to(torch.int32)
    slot = torch.sum((torch.cumsum(onehot, 0) - 1) * onehot, -1) \
        + before[flat]
    # the dropped assignments of an overflowing expert overwrite its slot
    # C - 1 with the empty marker (the reference's scatter, last write wins)
    overflow = total > C                                      # [E]
    kept = (slot < C) & ~((slot == C - 1) & overflow[flat])
    return slot, kept


def expert_counts(expert_ids: torch.Tensor, E: int) -> torch.Tensor:
    """[E] int64: the assignments to each expert."""
    return torch.sum(F.one_hot(expert_ids.reshape(-1), E), 0)


def slot_assignments(expert_ids: torch.Tensor, E: int, C: int):
    """(slot [N*K], kept [N*K] bool): each flattened assignment's place
    in its expert's queue, and whether it lands in the slot table (one
    process: nothing ahead of these rows)."""
    total = expert_counts(expert_ids, E)
    return global_slots(expert_ids, torch.zeros_like(total), total, C)


def combine(out_buf: torch.Tensor, gate_vals: torch.Tensor,
            expert_ids: torch.Tensor, slot: torch.Tensor,
            kept: torch.Tensor, first: int = 0,
            acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y [N, D]: per token, its kept expert outputs, each times its gate
    cast to out_buf's dtype, summed in ascending expert order with a
    rounding after each add (the reference's scatter-add) in `acc_dtype`
    (default out_buf's). out_buf holds experts first .. first + E - 1;
    `slot` is an assignment's row there."""
    E, C, D = out_buf.shape
    N, K = expert_ids.shape
    dt = out_buf.dtype
    acc = acc_dtype or dt
    rows = out_buf.reshape(E * C, D)
    idx = (torch.clamp(expert_ids.reshape(-1) - first, 0, E - 1) * C
           + torch.clamp(slot, max=C - 1))
    prod = rows[idx] * gate_vals.reshape(-1).to(dt)[:, None]
    contrib = torch.where(kept[:, None], prod,
                          torch.zeros((), dtype=dt, device=prod.device)
                          ).reshape(N, K, D)
    order = torch.argsort(expert_ids, dim=-1)
    contrib = torch.gather(contrib, 1, order[:, :, None].expand(N, K, D))
    y = torch.zeros((N, D), dtype=acc, device=out_buf.device)
    for k in range(K):
        y = y + contrib[:, k].to(acc)
    return y


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[QuantCtx] = None, exact_capacity: bool = False,
              groups=None, mp=None):
    """x [B, T, D]. Returns (y [B, T, D] in x's dtype, {"lb_loss",
    "z_loss"}). `exact_capacity` (decode, chunked prefill): C = N, so no
    token drops and one token's routing never depends on another's.
    `ctx` is accepted as the reference's is: the router and the experts
    run in float in every mode. `groups` (a `distributed.expert.
    ExpertGroups`; None in one process) makes x a rank's rows of the
    microbatch: routing, capacity and density are over all of them, and
    banks of E/m experts (this rank's, at `groups.model_index`) run
    expert-parallel; shared experts that arrive as blocks of F run on
    this rank's block, their f32 partial joining the routed experts'
    before the one sum over "model". `mp` (the model axis) under sequence
    parallelism: x is the whole stream, the copies are the identity, the
    sum is reduce-scattered to this rank's block of T (the returned y is
    that block) and the load-balance and z terms, which every rank
    computes alike, pass 1/m of their gradient (`ModelAxis.partial`)."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    sp = mp is not None and mp.sp
    N = B * T
    xt = x.reshape(N, D)
    logits, probs, gate_vals, expert_ids = route(xt, params["router"], K)
    local = expert_counts(expert_ids, E)
    if groups is None:
        C = capacity(N, cfg, exact_capacity)
        before, total = torch.zeros_like(local), local
    else:
        C = capacity(N * groups.row_size, cfg, exact_capacity)
        before, total = groups.counts(local)
    slot, kept = global_slots(expert_ids, before, total, C)

    # this rank's experts [e0, e0 + El): all E, or its block on "model"
    El = params["w_up"].shape[0]
    split = El < E
    e0 = groups.model_index * El if split else 0
    flat = expert_ids.reshape(-1)
    mine = kept & (flat >= e0) & (flat < e0 + El)
    # an assignment's row in its expert's part of the buffer: its place
    # after the rows ahead of this rank's (< N, as a token routes to an
    # expert at most once; = slot in one process, where Cl = C)
    pos = slot - before[flat]
    Cl = min(C, N)
    xe, ge = xt, gate_vals
    if split and not sp:
        xe, ge = groups.copy_to_experts(xt), groups.copy_to_experts(gate_vals)

    # the slot table: which token feeds each (expert, row), -1 empty.
    # Kept assignments have distinct (expert, row) cells; the others all
    # write one trash cell past the table, so no shape depends on the
    # data and nothing waits on the device
    tokens = torch.arange(N, device=x.device).repeat_interleave(K)
    cell = torch.where(mine, (flat - e0) * Cl + pos, El * Cl)
    table = torch.full((El * Cl + 1,), -1, dtype=torch.int64,
                       device=x.device)
    table = table.index_put((cell,), tokens)[:El * Cl].reshape(El, Cl)
    buf = xe[torch.clamp(table, min=0)] * (table >= 0)[..., None].to(x.dtype)
    out_buf = _expert_ffn(params["w_gate"], params["w_up"],
                          params["w_down"], buf, cfg.mlp_type)
    # f32 partials summed over the model axis once: the routed experts'
    # where the banks split, the shared experts' where their F does
    partial = y = None
    if split:
        partial = combine(out_buf, ge, expert_ids, pos, mine, e0,
                          torch.float32)
    else:
        y = combine(out_buf, ge, expert_ids, pos, mine)
    sh = None
    if cfg.n_shared_experts:
        sh_split = groups is not None and params["sh_up"].shape[-1] != \
            cfg.moe_d_ff * cfg.n_shared_experts
        if sh_split:
            xs = xt.to(torch.float32)
            sh_part = _expert_ffn(
                params["sh_gate"], params["sh_up"], params["sh_down"],
                (xs if sp else groups.copy_to_experts(xs))[None],
                cfg.mlp_type, x.dtype)[0]
            partial = sh_part if partial is None else partial + sh_part
        else:
            sh = _expert_ffn(params["sh_gate"], params["sh_up"],
                             params["sh_down"], xt[None], cfg.mlp_type)[0]
    if sp:      # this rank's block of T of every term, in the same order
        y = None if y is None else mp.shard(y.reshape(B, T, D))
        sh = None if sh is None else mp.shard(sh.reshape(B, T, D))
    if partial is not None:
        y_sum = (groups.reduce_scatter_from_experts(
            partial.reshape(B, T, D), 1) if sp
            else groups.reduce_from_experts(partial)).to(x.dtype)
        y = y_sum if y is None else y + y_sum
    if sh is not None:
        y = y + sh

    if groups is None:
        density = torch.mean(F.one_hot(expert_ids, E).to(torch.float32),
                             dim=(0, 1))
    else:   # the microbatch's, from the gathered counts (no gradient)
        density = total.to(torch.float32) / (N * groups.row_size * K)
    lb_loss = E * torch.sum(density * torch.mean(probs, 0))
    z_loss = torch.mean(torch.logsumexp(logits, -1) ** 2)
    if sp:
        lb_loss, z_loss = mp.partial(lb_loss), mp.partial(z_loss)
    return y.reshape(B, -1, D).to(x.dtype), {"lb_loss": lb_loss,
                                             "z_loss": z_loss}


def moe_init(gen: torch.Generator, cfg: ModelConfig, device,
             dtype=torch.float32) -> Dict:
    """One layer's MoE params in the reference's layout: the router in
    f32, expert banks [E, D, F] / [E, F, D] in `dtype`, each expert drawn
    in f32 and cast as it is stored (one expert's f32 draw alive at a
    time), and the shared experts fused into one [1, D, F * S] expert."""
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5

    def experts(d_in, d_out, scale=1.0):
        bank = torch.empty((E, d_in, d_out), dtype=dtype, device=device)
        for e in range(E):
            bank[e] = trunc_normal((d_in, d_out), scale / d_in ** 0.5, gen,
                                   device, dtype)
        return bank

    p = {"router": init_dense(gen, D, E, device),
         "w_up": experts(D, Fd),
         "w_gate": experts(D, Fd) if cfg.mlp_type in GATED else
         torch.zeros((E, 1, 1), dtype=dtype, device=device),
         "w_down": experts(Fd, D, out_scale)}
    if cfg.n_shared_experts:
        Fs = Fd * cfg.n_shared_experts
        p["sh_up"] = init_dense(gen, D, Fs, device, dtype=dtype)[None]
        p["sh_gate"] = init_dense(gen, D, Fs, device, dtype=dtype)[None]
        p["sh_down"] = init_dense(gen, Fs, D, device, scale=out_scale,
                                  dtype=dtype)[None]
    return p
