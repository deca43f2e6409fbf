"""K3's instantiation rule and its wrapper, on the CPU.

`kernels/sparq_prefill_attn.py::k3_traits` names the instantiation of the
f64 tensor-core kernel (`csrc/sparq_chunked_prefill_attn.cu`) a K3 call
runs: the head dim (the call's, or the next compiled one up, zero-padded),
the key tile, the query rows a block holds and the row blocks a query tile
is cut into (the launch grid's third dimension). The Pallas kernel takes any even hd, any rows per query tile and any
page size, so the rule may raise only past hd 256. The wrapper is driven
here with the kernel's launch replaced by a recorder: it must pass the
rule's choices and hand the kernel aligned copies of misaligned tensors
only, with no plain version in between.
"""
import inspect
import re

import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.kernels import build as _b
from repro_torch.kernels import sparq_prefill_attn as pre
from repro_torch.kernels.build import CSRC
from repro_torch.launch import serve

SRC = (CSRC / "sparq_chunked_prefill_attn.cu").read_text()


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


def _traits(*args):
    t = pre.k3_traits(*args)
    return (t.hd, t.key_tile, t.rows, t.row_blocks)


def test_cli_defaults():
    assert (ALIGN, PAGE) == (8, 16)


def test_full_tinyllama_takes_the_tensor_cores():
    hd, G = _shape(get_config("tinyllama-1.1b"))
    assert (hd, G) == (64, 8)
    assert pre.k3_traits(hd, G, ALIGN, PAGE) == pre.Traits(64, 64, 64, 12, 1)


@pytest.mark.parametrize("case,want,traits", [
    # the North-star --reduced run
    ("reduced", (16, 4, 8, 16), (16, 64, 32, 1)),
    # bq * G = 128: two row blocks of 64
    ("chunk-align 16", (64, 8, 16, 16), (64, 64, 64, 2)),
    # two key tiles a page
    ("page-size 128", (64, 8, 8, 128), (64, 64, 64, 1)),
])
def test_shapes_the_loop_kernel_took_take_the_tensor_cores(case, want,
                                                           traits):
    cfg = get_reduced_config("tinyllama-1.1b") if case == "reduced" \
        else get_config("tinyllama-1.1b")
    hd, G = _shape(cfg)
    bq = 16 if case == "chunk-align 16" else ALIGN
    ps = 128 if case == "page-size 128" else PAGE
    assert (hd, G, bq, ps) == want
    assert _traits(hd, G, bq, ps) == traits


@pytest.mark.parametrize("hd,G,bq,ps,want", [
    (64, 8, 8, 16, (64, 64, 64, 1)),
    (64, 8, 8, 64, (64, 64, 64, 1)),     # a page size equal to the tile
    (64, 4, 16, 32, (64, 64, 64, 1)),    # 64 rows exactly
    (64, 8, 8, 48, (64, 64, 64, 1)),     # 48 neither divides 64 nor is a
                                         # multiple of it
    (64, 1, 65, 16, (64, 64, 64, 2)),    # 65 rows: two row blocks
    (64, 1, 8, 16, (64, 64, 16, 1)),     # 8 rows: one row group
    (64, 4, 8, 16, (64, 64, 32, 1)),     # 32 rows: two row groups
    (128, 8, 8, 16, (128, 32, 64, 1)),
    (128, 48, 8, 16, (128, 32, 64, 6)),  # granite at chunk-align 8
    (128, 48, 16, 16, (128, 32, 64, 12)),
    (96, 2, 8, 16, (128, 32, 16, 1)),    # zero-padded to 128
    (256, 8, 8, 16, (256, 16, 32, 2)),   # hd 256 holds two row groups
    (256, 16, 16, 128, (256, 16, 32, 8)),
    (16, 4, 4, 4, (16, 64, 16, 1)),      # test_torch_kernels' small stream
    (8, 4, 4, 4, (16, 64, 16, 1)),
    (10, 4, 8, 16, (16, 64, 32, 1)),
    (2, 1, 1, 1, (16, 64, 16, 1)),
])
def test_k3_traits_rule(hd, G, bq, ps, want):
    t = pre.k3_traits(hd, G, bq, ps)
    assert (t.hd, t.key_tile, t.rows, t.row_blocks) == want
    assert t.warps == 2 * t.rows // 16 + pre.PRODUCER_WARPS
    assert t.rows * t.row_blocks >= bq * G > t.rows * (t.row_blocks - 1)


@pytest.mark.parametrize("hd,G,bq,ps", [
    (7, 4, 8, 16),      # odd: the Pallas kernel asserts an even hd too
    (258, 1, 8, 16),    # past every instantiation
    (0, 4, 8, 16),
    (64, 8, 8, 0),
    (64, 0, 8, 16),
])
def test_k3_traits_raises_only_past_every_instantiation(hd, G, bq, ps):
    with pytest.raises(ValueError, match="K3"):
        pre.k3_traits(hd, G, bq, ps)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_ported_configs_route_at_cli_defaults(arch, reduced):
    hd, G = _shape((get_reduced_config if reduced else get_config)(arch))
    for bq, ps in ((ALIGN, PAGE), (16, PAGE), (ALIGN, 128)):
        t = pre.k3_traits(hd, G, bq, ps)
        assert t.hd >= hd and t.rows * t.row_blocks >= bq * G


def _jax_attention_configs():
    out = []
    for name in jcfg.ARCHS:
        for reduced in (False, True):
            cfg = (jcfg.get_reduced_config if reduced
                   else jcfg.get_config)(name)
            if getattr(cfg, "n_heads", 0) and getattr(cfg, "n_kv_heads", 0):
                out.append((name, reduced))
    return out


@pytest.mark.parametrize("name,reduced", _jax_attention_configs())
def test_every_repo_config_gets_a_tensor_core_instantiation(name, reduced):
    """Every attention config of the JAX package (its hd and G), at the
    CLI defaults, --chunk-align 16 and --page-size 128, with a block table
    for 4096 positions and a 256-token chunk: an instantiation whose block
    fits in shared memory."""
    cfg = (jcfg.get_reduced_config if reduced else jcfg.get_config)(name)
    hd, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    for bq, ps in ((ALIGN, PAGE), (16, PAGE), (ALIGN, 128)):
        t = pre.k3_traits(hd, G, bq, ps)
        assert t.hd in pre.KEY_TILES and t.rows // 16 in pre.GROUPS[t.hd]
        smem = pre.smem_bytes(t.hd, t.rows // 16, 256, 4096 // ps, ps)
        assert smem <= _b.SMEM_LIMIT, (name, hd, G, bq, ps, smem)


def test_smem_is_the_launchers():
    """The instantiations, key tiles and shared-memory formula k3_traits
    and smem_bytes use are the ones the source compiles, and every
    instantiation's fixed part fits a block with room for the per-call
    index arrays of a 4096-position table and a 2048-token chunk."""
    tiles = dict((int(h), int(k)) for h, k in re.findall(
        r"template <> struct KeyTile<(\d+)> \{ static constexpr int value "
        r"= (\d+); \};", SRC))
    assert tiles == pre.KEY_TILES
    inst = {}
    for h, n in re.findall(r"K3_INSTANCE\((\d+), (\d+)\)", SRC):
        inst.setdefault(int(h), []).append(int(n))
    assert {h: tuple(v) for h, v in inst.items()} == pre.GROUPS
    flat = " ".join(SRC.split())
    assert ("sizeof(double) * (ROWS * LD + 4 * KT * LD + ROWS * LDP + CW * "
            "16) + sizeof(float) * CW * 16") in flat
    assert ("LD = HD + 4;" in flat and "LDP = KT + 4;" in flat
            and "CW = 2 * NG;" in flat
            and f"PW = {pre.PRODUCER_WARPS};" in flat)
    assert ("sizeof(int) * (a.NB + 2 * (npt + (a.C + Tr::KT - 1) / "
            "Tr::KT))") in flat
    for h, groups in pre.GROUPS.items():
        for n in groups:
            assert pre.smem_bytes(h, n, 2048, 4096 // 16, 16) \
                <= _b.SMEM_LIMIT, (h, n)
    # hd 64 at 4 row groups: Q and P 64 x 68, two K/V buffers 4 x 64 x 68
    # (f64), the pair exchanges of 8 consumer warps
    assert pre.smem_bytes(64, 4) == 8 * (64 * 68 * 2 + 4 * 64 * 68 + 128) \
        + 4 * 128


@pytest.mark.parametrize("hd,G,bq,ps,row_blocks", [
    (64, 8, 8, 16, 1),      # the serving shape: 64 rows, one block
    (64, 8, 16, 128, 2),    # the wide path: 128 rows in two blocks
    (16, 4, 8, 16, 1),      # the cli path: 32 rows, two row groups
    (128, 48, 8, 16, 6),    # granite-class: 384 rows in blocks of 64
    (256, 8, 8, 16, 2),     # hd 256: at most 2 row groups, 32 rows
])
def test_grid_row_blocks_are_the_rules(hd, G, bq, ps, row_blocks):
    """The launcher's grid has ceil(bq G / ROWS) row blocks a query tile,
    ROWS = 16 NG of the instantiation k3_traits names: the row_blocks the
    rule reports, each block's rows [rb ROWS, (rb + 1) ROWS) of the
    tile's bq G."""
    flat = " ".join(SRC.split())
    assert ("dim3 grid(a.C / a.bq, a.KV, (a.bq * a.G + Tr::ROWS - 1) / "
            "Tr::ROWS);") in flat
    assert "const int r0 = rb * ROWS;" in SRC
    t = pre.k3_traits(hd, G, bq, ps)
    assert t.row_blocks == row_blocks == -(-bq * G // t.rows)


def test_page_divisor_is_exact():
    """The launcher's x / ps as __umulhi(x, mul) >> shr, mul = ceil(2^(31
    + l) / ps), shr = l - 1, l = ceil(log2 ps): exact for 0 <= x < 2^31."""
    m = re.search(r"a\.ps_mul = static_cast<unsigned>\(\(\(1ull << \(31 \+ "
                  r"l\)\) \+ ps - 1\) / ps\);\s*a\.ps_shr = l - 1;", SRC)
    assert m
    rng = np.random.default_rng(0)
    for ps in list(range(2, 300)) + [4096, 12345, 1 << 20]:
        ln = (ps - 1).bit_length()
        mul = ((1 << (31 + ln)) + ps - 1) // ps
        assert mul < 1 << 32
        x = np.concatenate([rng.integers(0, 1 << 31, 1000), np.arange(4096),
                            [(1 << 31) - 1]]).astype(np.uint64)
        q = ((x * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(ln - 1)
        np.testing.assert_array_equal(q, x // np.uint64(ps))


@pytest.mark.parametrize("KV,hd,G,bq,ps,offset,want", [
    (4, 64, 8, 8, 16, 0, (64, 4)),    # the serving shape: 128 blocks
    (4, 16, 4, 8, 16, 0, (16, 2)),
    (4, 64, 8, 8, 128, 0, (64, 4)),
    (4, 64, 8, 16, 16, 0, (64, 4)),
    (1, 128, 48, 8, 16, 0, (128, 4)),
    (4, 256, 8, 8, 16, 0, (256, 2)),
    (4, 10, 4, 8, 16, 0, (16, 2)),
    (2, 64, 8, 8, 16, 0, (64, 4)),    # 64 blocks
    (4, 64, 8, 8, 16, 1, (64, 4)),    # q 4 bytes off: an aligned copy
    (4, 64, 8, 8, 16, 3, (64, 4)),    # the pools 3 bytes off as well
])
def test_wrapper_launches_the_kernel_k3_traits_names(monkeypatch, KV, hd, G,
                                                     bq, ps, offset, want):
    launched = []
    monkeypatch.setattr(pre.KERNEL, "launch",
                        lambda *a: launched.append(a))
    monkeypatch.setattr(_b, "stream_ptr", lambda t: 0)
    C, S, NB, P = 256, 2, 4, 6
    n = C * KV * G * hd
    qbuf = torch.zeros(n + 8)
    skip = (16 - qbuf.data_ptr() % 16) % 16 // 4 + (1 if offset else 0)
    q = qbuf[skip:skip + n].view(C, KV, G, hd)
    kc, vc = torch.zeros((C, KV, hd)), torch.zeros((C, KV, hd))

    def pool():
        m = P * ps * KV * hd
        buf = torch.zeros(m + 32, dtype=torch.int8)
        shift = (16 - buf.data_ptr() % 16) % 16 + (offset if offset > 1
                                                   else 0)
        return buf[shift:shift + m].view(P, ps, KV, hd)
    pools = [pool() for _ in range(4)]
    sc = torch.ones(S)
    bt = torch.from_numpy((np.arange(S * NB) % P).reshape(S, NB)
                          .astype(np.int32))
    ints = [torch.zeros(C, dtype=torch.int32) for _ in range(3)]
    ts = torch.zeros(C // bq, dtype=torch.int32)
    ins = (q, kc, vc, pools[0], pools[1], pools[2], pools[3])
    out = pre.sparq_chunked_prefill_attn_cuda(
        q, kc, vc, pools[0], pools[1], sc, pools[2], pools[3], sc, bt,
        *ints, ts)
    assert len(launched) == 1 and out.shape == (C, KV, G, hd)
    a = launched[0]
    assert tuple(a[-4:-2]) == want             # hd_pad, groups
    assert a[15:23] == (C, KV, G, hd, ps, NB, bq, 0)
    ptrs = [a[i].value for i in (0, 1, 2, 3, 4, 6, 7)]
    assert all(p % 16 == 0 for p in ptrs)
    for t, p in zip(ins, ptrs):
        assert (p == t.data_ptr()) == (t.data_ptr() % 16 == 0)
    assert sum(t.data_ptr() % 16 != 0 for t in ins) == \
        (0 if not offset else 1 if offset == 1 else 5)
    assert a[14].value == out.data_ptr()
