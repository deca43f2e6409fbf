"""Port parity, the dry run (`repro_torch.configs.base`,
`repro_torch.launch.dryrun`, `distributed.sharding.cache_pspecs`) against
the reference's (`repro.configs.base`, `repro.launch.dryrun`,
`repro.distributed.sharding.cache_pspecs`), and the meta rank's counts.

- `SHAPES`, `SUBQUADRATIC`, `ARCHS` and `cell_is_runnable` (its reason
  word for word) equal the reference's; `input_specs` gives JAX's keys,
  shapes and dtypes for every arch x shape; `model_stats` equals JAX's
  for every arch x shape (integers exact, floats to 1e-12 relative).
- `cache_pspecs`: leaf by leaf, the port's per-layer spec is JAX's
  stacked spec without its first entry (and the shapes likewise), for
  every arch at `prefill_32k` and `decode_32k` (+16) on 16 x 16 and 2 x
  16 x 16, tensor parallelism on and off; a rank's cache bytes at
  tinyllama `decode_32k` on 16 x 16 by hand (369 MB).
- The meta rank over a fake process group (this file run as a script in
  a subprocess, torch only: the fake group never shares a process with
  a gloo test): the collective bytes of reduced tinyllama's step on 4 x 1
  and 1 x 4 against counts worked out by hand from the shapes; the
  expert path's kinds for reduced deepseek (the [E] count gather on 4 x
  1, the experts' sums on 1 x 4); FLOPs on one rank within [6 N D, 8 N D
  + the attention's matmuls x 4] (the forward, remat's recompute and the
  backward's two); one full-width cell, tinyllama-1.1b x train_4k on 16 x
  16, whose state a rank equals the reference's rules' bytes.
- The CLI: a decode cell and the reference's skip record.
Tolerances: exact unless stated.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the fake-group cases: (name, arch, mesh dims, tensor parallel, rows)
COUNT_CASES = (("tiny_4x1", "tinyllama-1.1b", (4, 1), True, 8),
               ("tiny_1x4", "tinyllama-1.1b", (1, 4), True, 8),
               ("tiny_2x2_zero", "tinyllama-1.1b", (2, 2), False, 8),
               ("tiny_1x1", "tinyllama-1.1b", (1, 1), True, 2),
               ("deepseek_4x1", "deepseek-v2-lite-16b", (4, 1), True, 8),
               ("deepseek_1x4", "deepseek-v2-lite-16b", (1, 4), True, 8))
SEQ = 64


# ----------------------------------------------------------------------
# the fake-group side: torch and the port only
# ----------------------------------------------------------------------

def _small_shape():
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec("train_small", SEQ, 8, "train")


def _rank_main(out):
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import input_specs
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    res = {}
    for name, arch, dims, tp, rows in COUNT_CASES:
        cfg = get_reduced_config(arch)
        batch = input_specs(cfg, _small_shape(), batch_override=rows)
        res[name] = dryrun.trace_train_step(cfg, dryrun.layout_of(dims), tp,
                                            batch)
    res["cell"] = dryrun.run_cell("tinyllama-1.1b", "train_4k", False)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1]))


# ----------------------------------------------------------------------
# test side
# ----------------------------------------------------------------------
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


def _jdryrun():
    """The reference's dry-run module. Its import forces 512 host devices
    through XLA_FLAGS for its own process; the variable is put back at
    once, so that no later JAX start in this process sees it."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdry


def test_shapes_archs_and_runnable_equal_reference():
    assert tbase.SHAPES.keys() == jbase.SHAPES.keys()
    for k, s in tbase.SHAPES.items():
        js = jbase.SHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (js.name, js.seq_len, js.global_batch, js.kind)
    assert tbase.SUBQUADRATIC == jbase.SUBQUADRATIC
    assert tbase.ARCHS == jbase.ARCHS
    for arch in jbase.ARCHS:
        for shape in jbase.SHAPES:
            assert tbase.cell_is_runnable(arch, shape) == \
                jbase.cell_is_runnable(arch, shape), (arch, shape)
    assert tbase.get_config is not None and tbase.get_reduced_config


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_input_specs_equal_reference(arch):
    jc, tc = jbase.get_config(arch), tbase.get_config(arch)
    for shape in jbase.SHAPES:
        for override in (None, 3):
            js = jbase.input_specs(jc, jbase.SHAPES[shape], override)
            ts = tbase.input_specs(tc, tbase.SHAPES[shape], override)
            assert list(ts) == list(js), (arch, shape)
            for k in js:
                assert ts[k].device.type == "meta"
                assert tuple(ts[k].shape) == js[k].shape, (arch, shape, k)
                assert ts[k].dtype == DTYPES[js[k].dtype.type], \
                    (arch, shape, k)


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_model_stats_equal_reference(arch):
    jdry = _jdryrun()
    jc, tc = jbase.get_config(arch), tbase.get_config(arch)
    for shape in jbase.SHAPES:
        want = jdry.model_stats(jc, jbase.SHAPES[shape])
        got = dryrun.model_stats(tc, tbase.SHAPES[shape])
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, int):
                assert got[k] == v and isinstance(got[k], int), \
                    (arch, shape, k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-12,
                                           err_msg=f"{arch} {shape} {k}")


def test_tensor_parallel_rule_matches_reference():
    """ZeRO-DP exactly where the reference's `build_cell` takes it: a
    train cell of a `tensor_parallel=False` config whose 256 rows divide
    the ranks (16 x 16 only)."""
    zero = set()
    for arch in jbase.ARCHS:
        jc = jbase.get_config(arch)
        assert tbase.get_config(arch).tensor_parallel == jc.tensor_parallel
        for mp in (False, True):
            layout = dryrun.production_layout(mp)
            for shape in jbase.SHAPES:
                s = jbase.SHAPES[shape]
                want = jc.tensor_parallel or s.kind != "train" or \
                    s.global_batch % layout.world != 0
                got = dryrun.uses_tensor_parallel(
                    tbase.get_config(arch), tbase.SHAPES[shape], layout)
                assert got == want
                if not got:
                    zero.add((arch, shape, layout.world))
    assert zero == {(a, "train_4k", 256) for a in
                    ("tinyllama-1.1b", "starcoder2-3b", "whisper-base")}


# ------------------------------------------------------------ cache specs

class _Mesh:
    def __init__(self, dims):
        lay = dryrun.layout_of(dims)
        self.shape, self.axis_names = lay.shape, lay.axis_names


def _jkey(path) -> str:
    return "/".join(str(getattr(p, "name", getattr(p, "key",
                                                   getattr(p, "idx", p))))
                    for p in path)


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_cache_pspecs_equal_reference(arch):
    jm = JModel(jbase.get_config(arch))
    tm = TModel(tbase.get_config(arch), device="meta")
    where = [(gi, j) for gi, (_, count) in enumerate(tm.groups_meta)
             for j in range(count)]
    for shape in ("prefill_32k", "decode_32k"):
        s = jbase.SHAPES[shape]
        jc = jax.eval_shape(lambda: jm.init_cache(s.global_batch,
                                                  s.seq_len + 16))
        tc = tm.init_cache(s.global_batch, s.seq_len + 16)
        leaves = tshd.cache_leaves(tc)
        jshape = {_jkey(p): leaf.shape for p, leaf in
                  jax.tree_util.tree_flatten_with_path(jc)[0]}
        for dims in ((16, 16), (2, 16, 16)):
            mesh = _Mesh(dims)
            for tp in (True, False):
                jspecs = jax.tree_util.tree_flatten_with_path(
                    jshd.cache_pspecs(jc, jm, mesh, tensor_parallel=tp),
                    is_leaf=lambda x: isinstance(x, P))[0]
                jspec = {_jkey(p): tuple(sp) for p, sp in jspecs}
                tspec = tshd.cache_pspecs(tc, tm, mesh, tensor_parallel=tp)
                seen = set()
                for path, leaf in leaves:
                    gi, j = where[path[0]]
                    key = "/".join([str(gi)] + [
                        "self" if n == "self_kv" else str(n)
                        for n in path[1:]])
                    seen.add(key)
                    want = jspec[key]
                    assert tuple(leaf.shape) == jshape[key][1:], key
                    assert not want or want[0] is None   # [L] whole
                    got = tspec[T.path_key(path)]
                    assert got == want[1:], \
                        (arch, shape, dims, tp, key, got, want)
                assert seen == set(jspec), (arch, shape)


def test_tinyllama_decode_cache_bytes_by_hand():
    """16 x 16, TP: the batch of 128 over "data" (8 rows), the 32784 slots
    over "model" (2049), 4 KV heads x 64 whole, bf16: 8,392,704 bytes a
    plane a layer; 22 layers of K and V, and each layer's two f32 scales
    and int32 position whole (12 bytes)."""
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", False)
    assert rec["status"] == "ok"
    plane = (128 // 16) * (32784 // 16) * 4 * 64 * 2
    assert plane == 8_392_704
    assert rec["memory"]["cache_bytes"] == 22 * (2 * plane + 12)
    assert abs(rec["memory"]["cache_bytes"] / 1e6 - 369.3) < 0.1
    assert rec["flops_per_device"] is None
    assert rec["collective_bytes_per_device"] is None
    assert "meta device" in rec["reason"]
    assert rec["bytes_per_device"] is None and rec["hlo_full"] is None
    assert rec["memory"]["temp_bytes"] is None
    assert rec["fits"]["ok"] and rec["sp"] is False
    assert rec["origin"]["memory"] == "from specs"


# ------------------------------------------------------------ meta rank

@pytest.fixture(scope="module", autouse=True)
def _fake_group_run(tmp_path_factory):
    """The fake-group cases, started once in a subprocess (torch only)
    when this file's first test starts, so that they run while the JAX
    comparisons do."""
    out = tmp_path_factory.mktemp("dryrun") / "counts.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        yield proc, out
    finally:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def counted(_fake_group_run):
    proc, out = _fake_group_run
    log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log[-4000:]
    return json.loads(out.read_text())


def _tiny_leaf_bytes():
    """Reduced tinyllama's f32 leaves, whole: (outside the layers with a
    dp split: embed and lm_head; one layer's split leaves; one layer's
    norms; the final norm)."""
    from repro_torch.configs import get_reduced_config
    c = get_reduced_config("tinyllama-1.1b")
    d, f, V = c.d_model, c.d_ff, c.vocab_size
    kv = c.n_kv_heads * c.head_dim
    assert (d, f, V, kv, c.n_layers) == (128, 256, 512, 32, 2)
    outside = 2 * V * d * 4                       # embed, lm_head
    layer = (2 * d * d + 2 * d * kv + 3 * d * f) * 4   # wq wo wk wv, ffn
    norms = 2 * d * 4                              # ln1, ln2
    return c, outside, layer, norms, d * 4


def test_collective_bytes_on_4x1_by_hand(counted):
    """dp 4: every split leaf gathered over "data" (the layers twice: the
    forward and remat's recompute), its f32 gradient reduce-scattered to
    a quarter once; the norms' gradients all-reduced whole; the loss and
    its three terms (16 bytes) and the norm (4) all-reduced."""
    c, outside, layer, norms, final = _tiny_leaf_bytes()
    L = c.n_layers
    got = counted["tiny_4x1"]["kinds"]
    assert got["all-gather"] == outside + 2 * L * layer
    assert got["reduce-scatter"] == (outside + L * layer) // 4
    assert got["all-reduce"] == L * norms + final + 16 + 4
    assert got["all-to-all"] == got["collective-permute"] == 0
    sites = counted["tiny_4x1"]["sites"]
    assert sites["metrics"]["all-reduce"] == 20
    assert sites["model_axis"] == dict.fromkeys(got, 0)


def test_collective_bytes_on_1x4_by_hand(counted):
    """model 4, 8 rows x 64 tokens on every rank (N = 512): the 8 heads
    split, the 2 KV heads do not (k and v computed whole, `wk` / `wv`
    gathered over "model", twice a layer). Each layer's f32 sums over
    "model": `copy_to`'s backward on the attention input, k, v and the
    FFN input (d, 32, 32, d floats a token), the attention's row sum
    forward twice (the forward and remat's recompute) and the FFN's once
    (the layer's last op: the checkpoint's recompute stops early, once
    every tensor the backward saved is back); outside the layers the
    vocabulary-parallel lookup (d a token), the loss input's `copy_to`
    (d), the logits' max, sum of exp and label logit (1 each); the norm
    (4 bytes). No dp: no reduce-scatter, no loss mean."""
    c, _, _, _, _ = _tiny_leaf_bytes()
    d, kv, L, N = c.d_model, c.n_kv_heads * c.head_dim, c.n_layers, 8 * SEQ
    got = counted["tiny_1x4"]["kinds"]
    assert got["all-gather"] == L * 2 * (2 * d * kv * 4)
    per_layer = N * (2 * d + 2 * kv) * 4 + (2 + 1) * N * d * 4
    assert got["all-reduce"] == L * per_layer + N * (2 * d + 3) * 4 + 4
    assert got["reduce-scatter"] == 0
    assert counted["tiny_1x4"]["sites"]["model_axis"]["all-reduce"] == \
        got["all-reduce"] - 4


def test_zero_dp_counts(counted):
    """ZeRO-DP on 2 x 2: every axis is dp, nothing is summed over the
    model axis, the layer stacks (2 layers over "model") are gathered
    once with the leaves outside the layers."""
    got = counted["tiny_2x2_zero"]
    assert got["sites"]["model_axis"] == dict.fromkeys(got["kinds"], 0)
    assert got["kinds"]["reduce-scatter"] > 0
    assert got["kinds"]["all-gather"] > 0


def test_expert_path_kinds(counted):
    """Reduced deepseek: on 4 x 1 the MoE layers gather their [E] int64
    counts over "data" (forward and recompute) and split nothing; on 1 x 4
    the experts split over "model" and only their f32 sums cross."""
    from repro_torch.configs import get_reduced_config
    c = get_reduced_config("deepseek-v2-lite-16b")
    n_moe = c.n_layers - c.first_dense_layers
    dp4 = counted["deepseek_4x1"]["sites"]["experts"]
    assert dp4["all-gather"] == n_moe * 2 * 4 * c.n_experts * 8
    assert dp4["all-reduce"] == 0
    mp4 = counted["deepseek_1x4"]["sites"]["experts"]
    assert mp4["all-gather"] == 0 and mp4["reduce-scatter"] == 0
    N, d, K = 8 * SEQ, c.d_model, c.experts_per_token
    # copy_to's backward: tokens, gates, the shared experts' input; the
    # partial outputs' sum forward, twice (remat)
    assert mp4["all-reduce"] == n_moe * (N * d * 4 + N * K * 4
                                         + N * d * 4 + 2 * N * d * 4)


def test_flops_on_one_rank_within_bounds(counted):
    """FlopCounterMode's count of reduced tinyllama's step on one rank (2
    rows x 64): at least model_stats' 6 N D (the forward and the
    backward's two products of every weight), at most 8 N D (remat's
    recompute of the layers) plus 4 x the attention's QK^T and PV
    matmuls over full T x T score blocks."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeSpec
    c = get_reduced_config("tinyllama-1.1b")
    stats = dryrun.model_stats(c, ShapeSpec("s", SEQ, 2, "train"))
    ND = stats["model_flops"] / 6
    attn = 4 * 2 * c.n_heads * SEQ * SEQ * c.head_dim * c.n_layers
    flops = counted["tiny_1x1"]["flops"]
    assert 6 * ND <= flops <= 8 * ND + 4 * attn, (flops, ND, attn)


def test_full_width_train_cell(counted):
    """tinyllama-1.1b x train_4k on 16 x 16 runs through `run_cell` in the
    ZeRO-DP layout. Its state a rank is what the reference's rules give:
    a stacked leaf's ZeRO spec lands on its layer axis, which 22 layers
    cannot split 256 or 16 ways, so the layers stay whole on every rank
    and only the embedding and the head shard (JAX's `param_pspecs` on
    the same mesh gives the same bytes)."""
    rec = counted["cell"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["tensor_parallel"] is False and rec["sp"] is False
    assert "sp_note" not in rec
    jm = JModel(jbase.get_config("tinyllama-1.1b"))
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    specs = jshd.param_pspecs(shapes, _Mesh((16, 16)), tensor_parallel=False)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    per_rank = 0
    for (_, sp), leaf in zip(flat, jax.tree.leaves(shapes)):
        n = math.prod(16 ** len(e) if isinstance(e, tuple) else
                      (16 if e else 1) for e in sp)
        per_rank += leaf.size // n * 4
    mem = rec["memory"]
    assert mem["params_bytes"] == per_rank
    assert mem["opt_state_bytes"] == 2 * per_rank + 4
    assert mem["batch_bytes"] == 2 * 4096 * 4          # one row, 2 leaves
    assert mem["argument_bytes"] == 3 * per_rank + 4 + mem["batch_bytes"]
    cfg = jbase.get_config("tinyllama-1.1b")
    whole_layers = sum(x.size for x in jax.tree.leaves(shapes["blocks"]))
    assert per_rank == (whole_layers + cfg.d_model
                        + 2 * cfg.vocab_size * cfg.d_model // 256) * 4
    kinds = rec["collective_bytes_per_device"]
    assert set(kinds) == {"all-gather", "all-reduce", "reduce-scatter",
                          "all-to-all", "collective-permute"}
    assert kinds["all-reduce"] > 0 and kinds["all-gather"] > 0
    assert rec["flops_per_device"] > rec["model_stats"]["model_flops"] / 256
    assert rec["flops_counted"] == "aten matmul/conv/attention only"
    assert rec["origin"]["flops_per_device"] == "counted on meta, CPU"
    assert rec["fits"]["ok"]


def test_cli_decode_cell_and_skip(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "dry.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                        "--out", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[16x16] tinyllama-1.1b x decode_32k: ok" in r.stdout
    assert "1 cells: 1 ok, 0 skipped, 0 errors" in r.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    skip = dryrun.run_cell("tinyllama-1.1b", "long_500k", True)
    ok, reason = jbase.cell_is_runnable("tinyllama-1.1b", "long_500k")
    assert skip == {"arch": "tinyllama-1.1b", "shape": "long_500k",
                    "mesh": "2x16x16", "status": "skipped",
                    "reason": reason} and not ok
