"""Port parity for preemption under chunked admission: the cases of
tests/test_torch_preempt.py (the oversubscribed trace of
tests/test_scheduler.py, pages of 4, three slots) with prompts streamed
through the chunk path, where a requeued victim re-streams its prompt and
replays its tokens through the ordinary decode steps, and a victim caught
mid-prefill or mid-replay requeues even under the swap policy."""
import pytest

from test_torch_preempt import (_no_activation_spec,  # noqa: F401
                                _one_thread, models, runs)
from test_torch_preempt import test_preemption_matches_jax_engine as _check


@pytest.mark.parametrize("name", ["pool8-requeue-chunked",
                                  "pool6-swap-chunked"])
def test_preemption_chunked_matches_jax_engine(runs, name):
    """As test_preemption_matches_jax_engine, chunked."""
    _check(runs, name)


def test_prefill_scheduler_start_cancel_and_backlog_match_jax():
    """`add(..., expect_tok0, start)`, `cancel` and `pending_tokens` on
    the port's PrefillScheduler against the JAX one: the same jobs give
    the same chunk plans (rows, positions, segment starts, completions
    with their expected first token) under a tight page budget."""
    import numpy as np
    from repro.launch.prefill import PrefillScheduler as JSched
    from repro_torch.launch.prefill import PrefillScheduler as TSched
    kw = dict(chunk_size=16, align=4, page_size=4, n_slots=3, seg=4)
    js, ts = JSched(None, **kw), TSched(None, **kw)
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, 100, n) for n in (13, 9, 22)]
    for sch in (js, ts):
        sch.add(0, 10, toks[0], start=8)            # a shared 8-token prefix
        sch.add(1, 11, toks[1], expect_tok0=42)     # a requeue resume
        sch.add(2, 12, toks[2])
        sch.cancel(1)
        sch.add(1, 11, toks[1], expect_tok0=42)
    assert ts.pending_tokens == js.pending_tokens == 5 + 9 + 22
    bts = [np.full((3, 8), -1, np.int64) for _ in range(2)]
    for bt in bts:
        bt[0, :2] = [5, 6]                          # the shared pages
    free = [[p for p in range(24) if p not in (5, 6)] for _ in range(2)]
    budget = [3, 2, 4, 8, 8, 8]
    for step in range(6):
        plans = []
        for sch, bt, fr in zip((js, ts), bts, free):
            def grant(slot, blocks, bt=bt, fr=fr):
                for b in blocks:
                    bt[slot, b] = fr.pop(0)
            plans.append(sch.plan(lambda: budget[step], grant, bt))
        jp, tp = plans
        if jp is None:
            assert tp is None
            continue
        for f in ("tokens", "seq_id", "pos", "hist", "tile_seq",
                  "last_rows"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
        assert tp.completed == jp.completed and tp.advanced == jp.advanced
        np.testing.assert_array_equal(bts[0], bts[1])
        assert ts.pending_tokens == js.pending_tokens
    assert not ts.pending and not js.pending
