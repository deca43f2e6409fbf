"""The port's LLM trainer end to end on the CPU, at the reduced
tinyllama: the port's versions of the reference's three training system
tests (`tests/test_system.py`: exact restart, the loss decreases, SPARQ-
compressed gradients still train), the data pipeline's labels and host
shards, and the reference's flags that the port does not serve yet.

Tolerances: a restarted run repeats the uninterrupted one's losses
exactly (the CPU path is deterministic and the data are a pure function
of the step; the reference's own test allows 2e-4). The learning tests
keep the reference's margin: the mean of the last 5 losses at least 0.05
below the mean of the first 5.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.launch import train as T

BASE = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
        "--log-every", "100"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small tensors: with several
    test workers on the machine, idle OpenMP threads spinning between
    small ops would take the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_checkpoint_restart_exact(tmp_path):
    """8 steps straight through against 4 steps, a checkpoint, and a
    restored run of the last 4 (the schedule's horizon fixed at 8)."""
    run = ["--steps", "8", "--lr-total", "8", "--batch", "4", "--seq", "32",
           "--checkpoint-every", "4"]
    full = T.main(BASE + run + ["--checkpoint-dir", str(tmp_path / "a")])
    T.main(BASE + ["--steps", "4", "--lr-total", "8", "--batch", "4",
                   "--seq", "32", "--checkpoint-every", "4",
                   "--checkpoint-dir", str(tmp_path / "b")])
    resumed = T.main(BASE + run + ["--checkpoint-dir", str(tmp_path / "b"),
                                   "--restore"])
    assert len(resumed) == 4
    assert full[4:] == resumed


def test_train_loss_decreases():
    losses = T.main(BASE + ["--steps", "30", "--batch", "8", "--seq", "64",
                            "--lr", "2e-3"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_train_with_grad_compression_converges():
    """SPARQ-compressed gradients (error feedback) still train."""
    metrics = []
    losses = T.main(BASE + ["--steps", "30", "--batch", "8", "--seq", "64",
                            "--lr", "2e-3", "--compress-grads"],
                    metrics=metrics)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    assert [m["loss"] for m in metrics] == losses
    assert all(np.isfinite(m["grad_norm"]) and m["ms"] > 0 for m in metrics)


def test_train_accumulation_matches_whole_batch():
    """cfg.train_microbatches splits the batch into microbatches whose
    mean gradient is the whole batch's: one step's loss agrees to f32
    noise (1e-6 relative)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    cfg = get_reduced_config("tinyllama-1.1b").replace(dtype=torch.float32)
    batch = Batcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4, seed=3)).global_batch(0)
    out = []
    for micro in (1, 2):
        model = Model(cfg.replace(train_microbatches=micro), device="cpu")
        params = model.init_params(0)
        opt = AdamW()
        step = T.build_train_step(model, opt)
        _, _, _, m = step(params, opt.init(params), None, batch)
        out.append(float(m["loss"]))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6)


def test_batcher_labels_and_host_shards():
    cfg = DataConfig(vocab_size=512, seq_len=16, global_batch=8, seed=1)
    b = Batcher(cfg).global_batch(3)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()
    np.testing.assert_array_equal(Batcher(cfg).global_batch(3)["tokens"],
                                  b["tokens"])
    shards = [Batcher(cfg, host_id=h, n_hosts=2).local_batch(3)
              for h in range(2)]
    assert all(s["tokens"].shape == (4, 16) for s in shards)
    assert not np.array_equal(shards[0]["tokens"], shards[1]["tokens"])
    np.testing.assert_array_equal(
        Batcher(cfg, host_id=0, n_hosts=1).local_batch(3)["tokens"],
        b["tokens"])
    calib = Batcher(cfg).calib_batches(2)
    assert len(calib) == 2 and calib[0]["tokens"].shape == (8, 16)


@pytest.mark.parametrize("flags", [["--mesh", "production"], ["--multi-pod"],
                                   ["--model-parallel", "2"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        T.main(BASE + ["--steps", "1"] + flags)


def test_entry_point_needs_a_device_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--reduced", "--steps", "1"])
