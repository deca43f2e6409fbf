"""K3's route between its two hand-written kernels, on the CPU.

`kernels/sparq_prefill_attn.py::k3_path` names the kernel a K3 call
launches: the f64 tensor-core kernel (`csrc/sparq_chunked_prefill_attn.cu`)
exactly where it takes the shape, else the general loop kernel
(`csrc/sparq_chunked_prefill_attn_loop.cu`). The Pallas kernel takes any
even hd, any rows per query tile and any page size, so the rule may raise
only where the loop kernel's block does not fit in shared memory. The
wrapper is driven here with its two kernels' launches replaced by
recorders: it must launch the kernel k3_path names, with no plain version
in between.
"""
import inspect
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.kernels import build as _b
from repro_torch.kernels import sparq_prefill_attn as pre
from repro_torch.kernels.build import CSRC
from repro_torch.launch import serve


def _cli_default(flag):
    """The default of a `launch/serve.py` CLI flag, read from its parser."""
    m = re.search(r'"' + flag + r'", type=int, default=(\d+)',
                  inspect.getsource(serve.main))
    assert m, flag
    return int(m.group(1))


ALIGN = _cli_default("--chunk-align")
PAGE = _cli_default("--page-size")


def _shape(cfg):
    return cfg.head_dim, cfg.n_heads // cfg.n_kv_heads


def test_cli_defaults():
    assert (ALIGN, PAGE) == (8, 16)


def test_full_tinyllama_takes_the_tensor_cores():
    hd, G = _shape(get_config("tinyllama-1.1b"))
    assert (hd, G) == (64, 8)
    assert pre.k3_path(hd, G, ALIGN, PAGE, True) == "dmma"


@pytest.mark.parametrize("case,want", [
    ("reduced", (16, 4, 8, 16)),          # the North-star --reduced run
    ("chunk-align 16", (64, 8, 16, 16)),  # bq * G = 128
    ("page-size 128", (64, 8, 8, 128)),
])
def test_shapes_the_tensor_cores_refuse_take_the_loop(case, want):
    cfg = get_reduced_config("tinyllama-1.1b") if case == "reduced" \
        else get_config("tinyllama-1.1b")
    hd, G = _shape(cfg)
    bq = 16 if case == "chunk-align 16" else ALIGN
    ps = 128 if case == "page-size 128" else PAGE
    assert (hd, G, bq, ps) == want
    assert pre.k3_path(hd, G, bq, ps, True) == "loop"


@pytest.mark.parametrize("hd,G,bq,ps,aligned,want", [
    (64, 8, 8, 16, True, "dmma"),
    (64, 8, 8, 64, True, "dmma"),      # a page size dividing the key tile
    (64, 4, 16, 32, True, "dmma"),     # 64 rows exactly
    (64, 8, 8, 16, False, "loop"),     # a tensor not 16-byte aligned
    (64, 8, 8, 48, True, "loop"),      # 48 does not divide 64
    (64, 1, 65, 16, True, "loop"),     # 65 rows
    (128, 8, 8, 16, True, "loop"),
    (16, 4, 4, 4, True, "loop"),       # test_torch_kernels' small stream
    (8, 4, 4, 4, True, "loop"),
])
def test_k3_path_rule(hd, G, bq, ps, aligned, want):
    assert pre.k3_path(hd, G, bq, ps, aligned) == want


def test_k3_path_raises_only_beyond_shared_memory():
    assert pre.loop_smem_bytes(128, 48, 1, 16) <= _b.SMEM_LIMIT
    assert pre.k3_path(128, 48, 1, 16, True) == "loop"   # granite, bq 1
    with pytest.raises(ValueError, match="shared memory"):
        pre.k3_path(128, 48, 8, 16, True)
    with pytest.raises(ValueError, match="shared memory"):
        pre.k3_path(64, 8, 64, 16, True)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_ported_configs_route_at_cli_defaults(arch, reduced):
    hd, G = _shape((get_reduced_config if reduced else get_config)(arch))
    for bq, ps in ((ALIGN, PAGE), (16, PAGE), (ALIGN, 128)):
        assert pre.k3_path(hd, G, bq, ps, True) in ("dmma", "loop")


def test_loop_smem_is_the_launchers():
    """The footprint k3_path checks is the one the loop launcher asks
    for, and the chunk tile is the loop kernel's."""
    src = (CSRC / "sparq_chunked_prefill_attn_loop.cu").read_text()
    assert f"constexpr int KT = {pre.LOOP_KEY_TILE};" in src
    flat = " ".join(src.split())
    assert ("sizeof(float) * (2 * R * hd + 2 * T * (hd + 1) + R * T + 3 * R)"
            " + sizeof(int) * (3 * bq + 2 * KT)") in flat
    R, T = 8 * 4, 16
    assert pre.loop_smem_bytes(16, 4, 8, 16) == \
        4 * (2 * R * 16 + 2 * T * 17 + R * T + 3 * R) + 4 * (3 * 8 + 2 * 16)


@pytest.mark.parametrize("hd,G,bq,ps,offset,want", [
    (64, 8, 8, 16, 0, "sparq_chunked_prefill_attn"),
    (16, 4, 8, 16, 0, "sparq_chunked_prefill_attn_loop"),
    (64, 8, 8, 128, 0, "sparq_chunked_prefill_attn_loop"),
    (64, 8, 8, 16, 1, "sparq_chunked_prefill_attn_loop"),   # q 4 bytes off
])
def test_wrapper_launches_the_kernel_k3_path_names(monkeypatch, hd, G, bq,
                                                   ps, offset, want):
    launched = []
    for k in (pre.KERNEL, pre.LOOP_KERNEL):
        monkeypatch.setattr(k, "launch",
                            lambda *a, _k=k: launched.append(_k.name))
    monkeypatch.setattr(_b, "stream_ptr", lambda t: 0)
    C, KV, S, NB, P = 32, 2, 2, 4, 6
    qbuf = torch.zeros(C * KV * G * hd + offset)
    q = qbuf[offset:].view(C, KV, G, hd)
    kc = torch.zeros((C, KV, hd))
    pools = [torch.zeros((P, ps, KV, hd), dtype=torch.int8)
             for _ in range(4)]
    sc = torch.ones(S)
    bt = torch.from_numpy((np.arange(S * NB) % P).reshape(S, NB)
                          .astype(np.int32))
    ints = [torch.zeros(C, dtype=torch.int32) for _ in range(3)]
    ts = torch.zeros(C // bq, dtype=torch.int32)
    out = pre.sparq_chunked_prefill_attn_cuda(
        q, kc, kc.clone(), pools[0], pools[1], sc, pools[2], pools[3], sc,
        bt, *ints, ts)
    assert launched == [want] and out.shape == (C, KV, G, hd)
