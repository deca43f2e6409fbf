"""Port parity, sequence parallelism (`FSDP(..., sp=True)`: the reference's
Megatron-SP layout, `activation_spec(mesh, sp=True)`, which its dry run
takes for a tensor-parallel train cell) against the same step without it,
against one device and against JAX's step without a mesh.

- Gloo CPU ranks, mesh 1 x 2 (this file run as a script, torch only, one
  intra-op thread a rank): reduced tinyllama, reduced deepseek-v2-lite
  (MoE, its experts split over "model"), reduced rwkv6 and reduced
  whisper (the encoder's stream split too, its output gathered once for
  the cross attention), two steps from JAX's params with SP on, with SP
  off and on one device: losses, grad norms, the updated norm weights
  and every updated parameter; the first batch's gradient of every leaf
  under SP against one process's, leaf by leaf (a leaf whose gradient
  were summed over "model" once too often would be m times too large,
  which AdamW's scale invariance hides from the updated parameters). SP
  must be engaged: the model axis reduce-scatters and the non-split
  leaves' gradients are summed over it. A batch one of whose streams
  the model axis does not divide (tinyllama's T 15; whisper's 15
  frames under 16 tokens) is refused with SP and runs without it.
- JAX's `build_train_step` without a mesh on the same params and
  batches, in this process while the ranks run: the SP losses and grad
  norms, and the updated parameters, as tests/test_torch_train_sharded.py
  holds the sharded step.
- The fake group of the dry run (its own subprocess: a fake group never
  shares a process with gloo): reduced tinyllama's step on 1 x 4 with SP,
  its collective bytes worked out by hand from the shapes, beside the
  non-SP count of tests/test_torch_dryrun.py; `run_cell` records `sp`
  true on a tensor-parallel train cell, false with `sp=False`, with the
  CLI's `--no-sp` and on a cell whose T the model axis does not divide.
Tolerances, with their reasons: losses and grad norms
`chip_smoke.SHARDED_TOL` relative against SP off and one device (the
sums over "model" add the partials in another order: f32 rounding), and
1e-5 against JAX as the sharded tests hold theirs (rwkv6's second grad
norm 1e-3: its reduced training amplifies rounding, the sharded tests'
`LATER_NORM_TOL`); parameters `chip_smoke.train_params_close`, as the
sharded and one-device trainers' tests hold them, and each norm weight
by the same rule, and within 1e-5 absolute of the SP-off step's (the
same layout but for SP: two AdamW steps of lr 1e-3 from gradients equal
up to rounding); gradients within 1e-5 of the leaf's largest element of
one process's, as the sharded tests' `test_split_gradients_match_one_
process`. Against one device a norm element whose gradient is near 0 may
take the other sign's Adam step, which `train_params_close` bounds.
Collective bytes: exact.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_reduced_config as jcfg_reduced
    from repro.distributed.sharding import set_activation_spec
    from repro.launch.train import build_train_step as jbuild
    from repro.models.model import Model as JModel
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.adamw import cosine_schedule as jcosine

FAMILIES = (("tinyllama", "tinyllama-1.1b"),
            ("deepseek", "deepseek-v2-lite-16b"),
            ("rwkv6", "rwkv6-7b"), ("whisper", "whisper-base"))
STEPS = 2
NORMS = ("ln1", "ln2", "ln_x", "final_norm", "enc_norm")
SEQ = 64
# the batch whose streams the model axis of 2 does not divide: (tokens,
# frames) a row
ODD = {"tinyllama": (15, None), "whisper": (16, 15)}
# as tests/test_torch_train_sharded.py's LATER_NORM_TOL: the grad norms
# after the first step held to JAX at this rtol
LATER_NORM_TOL = {"rwkv6": 1e-3}


# ----------------------------------------------------------------------
# rank side: torch and the port only
# ----------------------------------------------------------------------

def _cfg(arch):
    from repro_torch.configs import get_reduced_config
    return get_reduced_config(arch).replace(dtype=torch.float32,
                                            attn_chunk=8)


def _batch(rng, cfg, T, frames=None):
    """Tokens and next-token labels, 4 x T, and whisper's frames (4 x
    `frames` or T rows)."""
    toks = rng.integers(0, cfg.vocab_size, (4, T)).astype(np.int32)
    b = {"tokens": toks, "labels": np.concatenate(
        [toks[:, 1:], np.full((4, 1), -1, np.int32)], 1)}
    if cfg.frontend == "audio":
        b["frames"] = (rng.standard_normal((4, frames or T, cfg.d_model))
                       * 0.02).astype(np.float32)
    return b


def _train(step, params, state, batches):
    rec = {"loss": [], "grad_norm": [], "lr": []}
    for b in batches:
        params, state, _, m = step(params, state, None, b)
        for k in rec:
            rec[k].append(float(m[k]))
    return params, rec


def _grad_errs(model, fsdp, specs, mesh, params, b):
    """{leaf key: max |SP gradient block - one process's| / max |one
    process's|} of the loss on batch `b`: each rank's gradient of its
    blocks through the SP step's gathers and their backward, against the
    same block of the one-process gradient."""
    from repro_torch import tree as T
    from repro_torch.distributed.sharding import block_slices, shard_tree
    from repro_torch.launch.train import value_and_grad
    rows, experts = fsdp.rows(b)
    _, _, got = value_and_grad(lambda p: model.loss(
        p, rows, gather=fsdp, experts=experts),
        shard_tree(params, specs, mesh))
    _, _, want = value_and_grad(lambda p: model.loss(p, b), params)
    out = {}
    for (path, g), w in zip(T.flatten_with_path(got), T.leaves(want),
                            strict=True):
        key = T.path_key(path)
        w = w[block_slices(tuple(w.shape), specs[key], mesh)]
        out[key] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30)
    return out


def _run_family(name, arch, path):
    """Two steps with SP on, SP off (mesh 1 x 2) and on one device from
    the params and batches at `path`; the first batch's gradients under
    SP; with an odd batch, the SP step's refusal and the SP-off step."""
    from repro_torch import tree as T
    from repro_torch.distributed import comm
    from repro_torch.distributed.fsdp import FSDP
    from repro_torch.distributed.sharding import (param_pspecs, shard_tree,
                                                  unshard_leaf)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    inputs = torch.load(path, weights_only=False)
    cfg = _cfg(arch)
    model = Model(cfg, device="cpu")
    params, batches = inputs["params"], inputs["batches"]
    specs = param_pspecs(params, mesh)

    def opt():
        return AdamW(lr=cosine_schedule(1e-3, 1, 3))
    out = {}
    for mode, sp in (("sp", True), ("tp", False)):
        fsdp = FSDP(mesh, specs, cfg, sp=sp)
        o = opt()
        p = shard_tree(params, specs, mesh)
        with comm.counting() as traffic:
            p, rec = _train(build_train_step(model, o, fsdp=fsdp), p,
                            o.init(p), batches)
        rec["sites"] = {k: dict(v) for k, v in traffic.sites.items()}
        rec["params"] = {T.path_key(path): unshard_leaf(
            b, specs[T.path_key(path)], mesh)
            for path, b in T.flatten_with_path(p)}
        out[mode] = rec
    fsdp = FSDP(mesh, specs, cfg, sp=True)
    out["grad_errs"] = _grad_errs(model, fsdp, specs, mesh, params,
                                  batches[0])
    o = opt()
    p, rec = _train(build_train_step(model, o), params, o.init(params),
                    batches)
    rec["params"] = {T.path_key(path): leaf
                     for path, leaf in T.flatten_with_path(p)}
    out["one"] = rec
    if "odd" in inputs:
        for mode, sp in (("odd_sp", True), ("odd_tp", False)):
            fsdp = FSDP(mesh, specs, cfg, sp=sp)
            o = opt()
            p = shard_tree(params, specs, mesh)
            try:
                out[mode] = _train(build_train_step(model, o, fsdp=fsdp), p,
                                   o.init(p), [inputs["odd"]])[1]
            except ValueError as e:
                out[mode] = {"error": str(e)}
    return out


def _gloo_main(rank, store, out, inputs):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    res = {name: _run_family(name, arch, f"{inputs}/{name}.pt")
           for name, arch in FAMILIES}
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()
    return 0


def _fake_main(out):
    """The dry run's fake-group side: reduced tinyllama's step on 1 x 4
    with SP and without; `run_cell` on a tensor-parallel train cell (the
    reduced config, attention chunk 1024, at train_4k on 2 x 16 x 16)
    with SP, without, and through the CLI's --no-sp."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeSpec, input_specs
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    cfg = get_reduced_config("tinyllama-1.1b")
    batch = input_specs(cfg, ShapeSpec("train_small", SEQ, 8, "train"),
                        batch_override=8)
    res = {name: dryrun.trace_train_step(cfg, dryrun.layout_of((1, 4)),
                                         True, batch, sp=sp)
           for name, sp in (("sp", True), ("tp", False))}
    # the reduced config with the published configs' attention chunk:
    # the reduced one's 64 walks 64 x 64 key blocks at T 4096 on meta
    dryrun.get_config = lambda arch: get_reduced_config(arch).replace(
        attn_chunk=1024)
    res["cell_sp"] = dryrun.run_cell("tinyllama-1.1b", "train_4k", True)
    res["cell_no_sp"] = dryrun.run_cell("tinyllama-1.1b", "train_4k", True,
                                        sp=False)
    # a train cell whose T (1000) the model axis of 16 does not divide
    dryrun.SHAPES["train_odd"] = ShapeSpec("train_odd", 1000, 256, "train")
    res["cell_odd"] = dryrun.run_cell("tinyllama-1.1b", "train_odd", True)
    report = out + ".cli.json"
    try:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                     "--multi-pod", "--no-sp", "--out", report])
    except SystemExit as e:
        res["cli_exit"] = e.code
    with open(report) as f:
        res["cli"] = json.load(f)
    for k in ("cell_sp", "cell_no_sp", "cell_odd"):
        res[k].pop("traceback", None)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "fake":
        sys.exit(_fake_main(sys.argv[2]))
    sys.exit(_gloo_main(int(sys.argv[1]), *sys.argv[2:]))


# ----------------------------------------------------------------------
# test side
# ----------------------------------------------------------------------
import pytest  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _inputs(name, arch, d):
    """JAX's model and init (the key 0) and the family's batches, 4 x 16
    (whisper's frames 16 rows), and its odd batch; the params in the
    port's layout and the batches saved for the ranks at d/<name>.pt."""
    from repro_torch.interop import params_from_jax
    jm = JModel(jcfg_reduced(arch).replace(dtype=jnp.float32, attn_chunk=8))
    jp0 = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    batches = [_batch(rng, jm.cfg, 16) for _ in range(STEPS)]
    saved = {"params": params_from_jax(jax.tree.map(np.asarray, jp0)),
             "batches": batches}
    if name in ODD:
        saved["odd"] = _batch(rng, jm.cfg, *ODD[name])
    torch.save(saved, d / f"{name}.pt")
    return jm, jp0, batches


def _reference(jm, jp0, batches):
    """JAX `build_train_step` (no mesh, no activation spec) over the
    batches: losses, grad norms and the updated params' leaves."""
    set_activation_spec(None)
    jo = JAdamW(lr=jcosine(1e-3, 1, 3))
    step = jax.jit(jbuild(jm, jo, None, 1))
    jp, js = jp0, jo.init(jp0)
    rec = {"loss": [], "grad_norm": []}
    for b in batches:
        jp, js, _, m = step(jp, js, None, jax.tree.map(jnp.asarray, b))
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    rec["params"] = [np.asarray(x) for x in jax.tree.leaves(jp)]
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo world and the fake-group process, started together; the
    JAX references computed here while they run."""
    d = tmp_path_factory.mktemp("sp")
    inputs = {name: _inputs(name, arch, d) for name, arch in FAMILIES}
    gloo = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(d / "store"),
         str(d / "gloo.pt"), str(d)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    fake = subprocess.Popen([sys.executable, __file__, "fake",
                             str(d / "fake.json")], env=_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    procs = gloo + [fake]
    logs = []
    try:
        refs = {name: _reference(*inputs[name]) for name in inputs}
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return {"gloo": torch.load(d / "gloo.pt", weights_only=False),
            "fake": json.loads((d / "fake.json").read_text()),
            "ref": refs}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _is_norm(key):
    return any(n in key.split("/") for n in NORMS)


@pytest.mark.parametrize("name", [f for f, _ in FAMILIES])
def test_sp_step_matches_sp_off_and_one_device(runs, name):
    cs = _chip_smoke()
    tol = cs.SHARDED_TOL
    res = runs["gloo"][name]
    sp = res["sp"]
    norms = [k for k in sp["params"] if _is_norm(k)]
    lr_sum = sum(sp["lr"])
    assert lr_sum > 0
    assert norms and any(k.startswith("final_norm") for k in norms)
    for other in ("tp", "one"):
        want = res[other]
        np.testing.assert_allclose(sp["loss"], want["loss"],
                                   rtol=tol["loss"], err_msg=other)
        np.testing.assert_allclose(sp["grad_norm"], want["grad_norm"],
                                   rtol=tol["grad_norm"], err_msg=other)
        assert sp["params"].keys() == want["params"].keys()
        cs.train_params_close(
            [want["params"][k] for k in sp["params"]],
            [sp["params"][k] for k in sp["params"]], lr_sum,
            f"{name} SP against {other}")
        for k in norms:
            cs.train_params_close([want["params"][k]], [sp["params"][k]],
                                  lr_sum, f"{name} {k}: SP against {other}")
            if other == "tp":
                np.testing.assert_allclose(sp["params"][k].numpy(),
                                           want["params"][k].numpy(),
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", [f for f, _ in FAMILIES])
def test_sp_step_matches_reference(runs, name):
    """The SP step against JAX's step without a mesh on the same params
    and batches: losses and grad norms within 1e-5 (rwkv6's second norm
    `LATER_NORM_TOL`), every updated parameter by `train_params_close`."""
    sp, ref = runs["gloo"][name]["sp"], runs["ref"][name]
    np.testing.assert_allclose(sp["loss"], ref["loss"], rtol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(sp["grad_norm"][:1], ref["grad_norm"][:1],
                               rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(sp["grad_norm"][1:], ref["grad_norm"][1:],
                               rtol=LATER_NORM_TOL.get(name, 1e-5),
                               err_msg=name)
    _chip_smoke().train_params_close(ref["params"], list(sp["params"]
                                                         .values()),
                                     sum(sp["lr"]), f"{name} SP against JAX")


@pytest.mark.parametrize("name", [f for f, _ in FAMILIES])
def test_sp_gradients_match_one_process(runs, name):
    """The first batch's gradient of every leaf on a rank under SP (the
    entries' reduce-scatters, the row products' gathers, the sums over
    "model" of the leaves not split over it) within 1e-5 of the leaf's
    largest element of one process's: a sum taken twice (a leaf's
    gradient m times too large) or not at all fails it."""
    errs = runs["gloo"][name]["grad_errs"]
    assert errs.keys() == runs["gloo"][name]["sp"]["params"].keys()
    assert any(_is_norm(k) for k in errs)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (name, worst, errs[worst])


@pytest.mark.parametrize("name", sorted(ODD))
def test_sp_refuses_an_undivided_stream(runs, name):
    """A batch one of whose streams the model axis of 2 does not divide
    (tinyllama's 15 tokens; whisper's 15 frames under 16 tokens): the SP
    step raises and names the stream (its norms' gradients would be
    summed over "model" as partial while whole), the step without SP
    runs."""
    res = runs["gloo"][name]
    stream = "decoder's T 15" if name == "tinyllama" else "encoder's T 15"
    assert stream in res["odd_sp"]["error"], res["odd_sp"]
    assert "error" not in res["odd_tp"], res["odd_tp"]
    assert np.isfinite(res["odd_tp"]["loss"]).all()
    assert np.isfinite(res["odd_tp"]["grad_norm"]).all()


@pytest.mark.parametrize("name", [f for f, _ in FAMILIES])
def test_sp_is_engaged(runs, name):
    """With SP the model axis reduce-scatters (the row products' ends,
    the entries' backward) and the leaves that are not split over it sum
    their gradients there; without it neither happens."""
    res = runs["gloo"][name]
    sp, tp = res["sp"]["sites"], res["tp"]["sites"]
    assert sp["model_axis"]["reduce-scatter"] > 0
    assert sp["sp_grads"]["all-reduce"] > 0
    assert tp["sp_grads"]["all-reduce"] == 0
    assert sp["model_axis"]["all-gather"] > tp["model_axis"]["all-gather"]
    assert sp["model_axis"]["all-reduce"] < tp["model_axis"]["all-reduce"]


def test_sp_collective_bytes_on_1x4_by_hand(runs):
    """Reduced tinyllama, model 4, 8 rows x 64 tokens (N = 512), d 128,
    the 2 KV heads (kv = 32 floats) whole, 2 layers, bf16 forward. A
    layer: its normed inputs all-gathered over T before the attention and
    the FFN (bf16, N d a gather: the forward and remat's recompute), the
    attention's and the FFN's row sums reduce-scattered over T (f32, N d /
    4: the attention's twice, the FFN's once, remat's recompute stopping
    before the layer's last op), and the backward's reduce-scatters of
    the two entries' gradients (f32) and all-gathers of the two row sums'
    (f32, N d); `wk` / `wv` gathered twice as without SP. Outside the
    layers: the vocabulary-parallel lookup reduce-scattered over T (f32)
    and its gradient all-gathered back, the final norm's output
    all-gathered (bf16) and its gradient reduce-scattered; the loss's
    max, sum of exp and label logit (N floats each) all-reduced. The
    leaves not split over "model" sum their gradients there: `wk`, `wv`,
    `ln1`, `ln2` a layer and `final_norm`; the norm (4 bytes). SP takes
    away the `copy_to` all-reduces of the non-SP count (d + 2 kv + d a
    token a layer, d at the loss) and the row sums' all-reduces."""
    from repro_torch.configs import get_reduced_config
    c = get_reduced_config("tinyllama-1.1b")
    d, kv, L, N, m = (c.d_model, c.n_kv_heads * c.head_dim, c.n_layers,
                      8 * SEQ, 4)
    assert (d, kv, L) == (128, 32, 2)
    got = runs["fake"]["sp"]["kinds"]
    sites = runs["fake"]["sp"]["sites"]
    blk = N // m * d * 4
    assert got["all-gather"] == (L * 2 * (2 * d * kv * 4)
                                 + L * (4 * N * d * 2 + 2 * N * d * 4)
                                 + N * d * 2 + N * d * 4)
    assert got["reduce-scatter"] == L * 5 * blk + 2 * blk
    assert sites["sp_grads"]["all-reduce"] == \
        L * (2 * d * kv * 4 + 2 * d * 4) + d * 4
    assert sites["model_axis"]["all-reduce"] == 3 * N * 4
    assert got["all-reduce"] == sites["sp_grads"]["all-reduce"] + \
        3 * N * 4 + 4
    # the same step without SP moves more bytes over "model"
    tp = runs["fake"]["tp"]["kinds"]
    assert sum(got.values()) < sum(tp.values())
    assert runs["fake"]["tp"]["sites"]["sp_grads"] == \
        dict.fromkeys(tp, 0)


def test_dry_run_records_sp(runs):
    """A tensor-parallel train cell (the reduced config at train_4k on 2 x
    16 x 16: 256 rows do not divide 512 ranks) runs with SP and says so;
    `sp=False` and the CLI's --no-sp give today's record, and so does a
    cell whose T the model axis does not divide."""
    f = runs["fake"]
    on, off = f["cell_sp"], f["cell_no_sp"]
    assert on["status"] == "ok" and off["status"] == "ok", \
        (on.get("error"), off.get("error"))
    assert on["tensor_parallel"] is True and on["sp"] is True
    assert "sp_note" not in on
    assert off["sp"] is False
    assert f["cli_exit"] == 0 and len(f["cli"]) == 1
    assert f["cli"][0]["sp"] is False
    assert f["cli"][0]["collective_bytes_per_device"] == \
        off["collective_bytes_per_device"]
    ag = on["collective_bytes_per_device"]
    assert ag["reduce-scatter"] > off["collective_bytes_per_device"][
        "reduce-scatter"]
    assert on["collective_bytes_by_site"]["sp_grads"]["all-reduce"] > 0
    # T 1000 on a model axis of 16: the cell runs without SP
    odd = f["cell_odd"]
    assert odd["status"] == "ok", odd.get("error")
    assert odd["tensor_parallel"] is True and odd["sp"] is False
    assert odd["collective_bytes_by_site"]["sp_grads"]["all-reduce"] == 0
