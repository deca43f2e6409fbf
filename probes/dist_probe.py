"""Which collectives gloo carries for CUDA tensors, and how
`init_device_mesh` builds its groups, with ranks sharing one card.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        probes/dist_probe.py

Each rank prints one JSON line of what worked and what raised, and the
time of an all-reduce of 176 MB (one tinyllama-1.1b layer's f32
weights), an all-gather of its halves, a reduce-scatter of it onto the
halves (the sharded trainer's gradient reduction over dp) and an
all-reduce of 8 MB (a tinyllama-1.1b row product's f32 partial sum over
the model axis, 8 x 128 x 2048)."""
import json
import os
import sys

import torch
import torch.distributed as dist


def main():
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    n = torch.cuda.device_count()
    dev = torch.device("cuda", rank % max(n, 1))
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", rank=rank, world_size=world)
    out = {"rank": rank, "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "cards": n}
    x = torch.full((4,), float(rank + 1), device=dev)
    for name, fn in (
            ("all_reduce_sum", lambda: dist.all_reduce(x.clone())),
            ("all_reduce_max", lambda: dist.all_reduce(
                x.clone(), op=dist.ReduceOp.MAX)),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(world)], x)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(world * 4, device=dev), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(4 // world, device=dev), x)),
            ("barrier", lambda: dist.barrier())):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:          # noqa: BLE001 - reported, not hidden
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    from torch.distributed.device_mesh import init_device_mesh
    for label, kw in (("plain", {}),
                      ("override", {"backend_override": {
                          "data": "gloo", "model": "gloo"}})):
        try:
            dm = init_device_mesh("cuda", (world, 1),
                                  mesh_dim_names=("data", "model"), **kw)
            g = dm.get_group("data")
            y = x.clone()
            dist.all_reduce(y, group=g)
            out[f"mesh_{label}"] = {
                "backend": dist.get_backend(g), "sum": y[0].item(),
                "coord": dm.get_coordinate()}
        except Exception as e:          # noqa: BLE001
            out[f"mesh_{label}"] = f"{type(e).__name__}: {str(e)[:200]}"
    # rates at one tinyllama-1.1b layer's f32 weights (176 MB)
    import time
    big = torch.ones(44_000_000, device=dev)
    parts = [torch.empty(22_000_000, device=dev) for _ in range(world)]
    block = torch.empty(44_000_000 // world, device=dev)
    small = torch.ones(8 * 128 * 2048, device=dev)
    for name, fn in (("all_reduce_176MB", lambda: dist.all_reduce(big)),
                     ("all_gather_88MB_each", lambda: dist.all_gather(
                         parts, big[:22_000_000])),
                     ("reduce_scatter_176MB", lambda:
                      dist.reduce_scatter_tensor(block, big)),
                     ("all_reduce_8MB", lambda: dist.all_reduce(small))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out[name + "_ms"] = (time.perf_counter() - t) / 3 * 1e3
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
