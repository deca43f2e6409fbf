"""Where a fresh process's first train step spends its time on the card:
tinyllama-1.1b at full width cut to 2 layers, batch 8 x 128, each part
synchronized and timed on the host clock, then the same parts again.
The layer's pieces run under no_grad; `Model.loss` with grad enabled
goes through `torch.utils.checkpoint` (remat), whose first call imports
`torch._dynamo`.

    PYTHONPATH=src python probes/first_step_probe.py
"""
import os
import time

import torch

T0 = time.perf_counter()


def mark(what, t):
    torch.cuda.synchronize()
    now = time.perf_counter()
    print(f"{what:28s} {1e3 * (now - t):9.1f} ms", flush=True)
    return now


def main():
    t = mark("import torch", T0)
    x = torch.zeros(1, device="cuda")
    t = mark("cuda init", t)
    a = torch.randn(1024, 2048, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    t = mark("randn", t)
    (a @ b).sum()
    t = mark("first bf16 matmul", t)
    (a.float() @ b.float()).sum()
    t = mark("first f32 matmul", t)
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    t = mark("import repro_torch", t)
    cfg = get_config("tinyllama-1.1b").replace(n_layers=2)
    model = Model(cfg, device="cuda")
    params = model.init_params(0, dtype=torch.float32)
    t = mark("init params", t)
    data = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                              global_batch=8, seed=0))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.global_batch(0).items()}
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import chunked_lm_loss, norm
    for rep in range(2):
        with torch.no_grad():
            x = model._embed_in(params, batch["tokens"], cfg.dtype)
            t = mark(f"embed ({rep})", t)
            pos = model._positions(*x.shape[:2])
            p0 = tr.layer_params(params["blocks"][0], 0)
            h = norm(p0["ln1"], x, cfg.norm_type, cfg.norm_eps)
            t = mark(f"rmsnorm ({rep})", t)
            from repro_torch.models import attention as attn
            attn.attention_block(p0["attn"], h, cfg, positions=pos)
            t = mark(f"attention block ({rep})", t)
            x, _, _ = tr.block_apply(p0, x, cfg, "dense", positions=pos)
            t = mark(f"block ({rep})", t)
            chunked_lm_loss(params["lm_head"], x, batch["labels"], 512)
            t = mark(f"lm loss ({rep})", t)
        model.loss(params, batch)
        t = mark(f"loss, params not requiring grad ({rep})", t)
        req = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss, _ = model.loss(T.unflatten(params, req), batch)
        t = mark(f"forward ({rep})", t)
        torch.autograd.grad(loss, req)
        t = mark(f"backward ({rep})", t)
    opt = AdamW(lr=cosine_schedule(3e-4, 1, 10))
    step = build_train_step(model, opt)
    state = opt.init(params)
    t = mark("opt init", t)
    for i in range(2):
        params, state, _, m = step(params, state, None,
                                   data.global_batch(i))
        float(m["loss"])
        t = mark(f"train step {i}", t)
    for k in ("CUDA_MODULE_LOADING", "CUDA_CACHE_PATH", "CUDA_CACHE_DISABLE",
              "HOME"):
        print(k, os.environ.get(k))


if __name__ == "__main__":
    main()
