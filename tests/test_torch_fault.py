"""Simulated-cluster tests for the port's copy of distributed/fault.py
(`repro_torch.distributed.fault`): the reference's own cases
(`tests/test_fault.py`), run against the copy, and a check that the copy
keeps the reference's code.

Everything runs on injected clocks (`now=` params) and synthetic step
times — no `time.time()` in any assertion, so the suite is deterministic
on arbitrarily loaded CI hosts. The scenario test at the bottom drives a
whole simulated fleet through warmup, a straggling host, a silent death,
and the elastic remesh + checkpoint-restore decision that follows.
"""
import dataclasses

import pytest

from repro_torch.distributed.fault import (ElasticCoordinator,
                                           HeartbeatMonitor, RemeshPlan,
                                           StragglerDetector, plan_remesh)


# ----------------------------------------------------------------------
# HeartbeatMonitor
# ----------------------------------------------------------------------

def test_heartbeat_dead_after_timeout():
    mon = HeartbeatMonitor(timeout_s=10.0)
    mon.beat(0, step=1, now=100.0)
    mon.beat(1, step=1, now=100.0)
    assert mon.dead_workers(now=105.0) == []
    assert sorted(mon.alive(now=105.0)) == [0, 1]
    # worker 1 goes silent; worker 0 keeps beating
    mon.beat(0, step=2, now=109.0)
    assert mon.dead_workers(now=111.0) == [1]
    assert mon.alive(now=111.0) == [0]


def test_heartbeat_exactly_at_timeout_is_alive():
    # the contract is strict: dead means silent *past* timeout_s
    mon = HeartbeatMonitor(timeout_s=10.0)
    mon.beat(7, step=3, now=50.0)
    assert mon.dead_workers(now=60.0) == []
    assert mon.dead_workers(now=60.0001) == [7]


def test_heartbeat_revival_clears_death():
    mon = HeartbeatMonitor(timeout_s=5.0)
    mon.beat(2, step=1, now=0.0)
    assert mon.dead_workers(now=20.0) == [2]
    mon.beat(2, step=2, now=20.0)           # the host came back
    assert mon.dead_workers(now=21.0) == []
    assert mon.last_step[2] == 2


# ----------------------------------------------------------------------
# StragglerDetector
# ----------------------------------------------------------------------

def test_straggler_needs_fleet_of_four():
    det = StragglerDetector()
    for w in range(3):
        det.record(w, 1.0)
    det.record(2, 100.0)                    # huge, but only 3 workers
    assert det.stragglers() == []


def test_straggler_flags_slow_worker():
    det = StragglerDetector(alpha=0.5, z_threshold=1.5)
    # 7 healthy workers at ~1s, one worker consistently 10x slower
    for _ in range(20):
        for w in range(7):
            det.record(w, 1.0)
        det.record(7, 10.0)
    assert det.stragglers() == [7]


def test_straggler_uniform_fleet_is_clean():
    det = StragglerDetector()
    for _ in range(10):
        for w in range(8):
            det.record(w, 1.0)
    assert det.stragglers() == []


def test_straggler_ewma_forgets_one_hiccup():
    """One slow step must not brand a worker; a persistent slowdown
    must. That's the point of the EWMA over raw step times. Healthy
    workers carry a little deterministic jitter so the fleet std is
    realistic (the z-score is scale-invariant, so against a perfectly
    uniform fleet any residual would trip it)."""
    det = StragglerDetector(alpha=0.2, z_threshold=3.0)
    base = lambda w: 1.0 + 0.05 * (w % 4)
    for w in range(16):
        det.record(w, base(w))
    det.record(3, 30.0)                     # single GC pause / retry
    for _ in range(40):
        for w in range(16):
            det.record(w, base(w))
    assert det.stragglers() == []           # hiccup decayed into the noise
    for _ in range(40):
        for w in range(16):
            det.record(w, 8.0 if w == 3 else base(w))
    assert det.stragglers() == [3]


# ----------------------------------------------------------------------
# plan_remesh
# ----------------------------------------------------------------------

def test_remesh_raises_below_tp_degree():
    with pytest.raises(ValueError, match="need >= 16"):
        plan_remesh(15, model_parallel=16)


@pytest.mark.parametrize("n_avail,want_shape,want_axes", [
    # data axis snaps DOWN to a power of two; model axis never changes
    (256, (16, 16), ("data", "model")),
    (255, (8, 16), ("data", "model")),      # 15 -> 8
    (48, (2, 16), ("data", "model")),
    (16, (1, 16), ("data", "model")),
    # >= 512 chips and even data axis: split off the pod axis
    (512, (2, 16, 16), ("pod", "data", "model")),
    (1024, (2, 32, 16), ("pod", "data", "model")),
])
def test_remesh_grid_policy(n_avail, want_shape, want_axes):
    plan = plan_remesh(n_avail, model_parallel=16)
    assert plan.mesh_shape == want_shape
    assert plan.axis_names == want_axes
    # the planned grid always fits the surviving devices
    n = 1
    for d in plan.mesh_shape:
        n *= d
    assert n <= n_avail


def test_remesh_records_dropped_and_restore_step():
    plan = plan_remesh(48, model_parallel=16, dropped=(3, 9),
                       restore_step=1200)
    assert plan == RemeshPlan((2, 16), ("data", "model"), (3, 9), 1200)
    # frozen: a plan is a decision record, not mutable state
    with pytest.raises(dataclasses.FrozenInstanceError):
        plan.restore_step = 0


# ----------------------------------------------------------------------
# ElasticCoordinator: the simulated cluster
# ----------------------------------------------------------------------

def test_coordinator_healthy_fleet_never_remeshes():
    coord = ElasticCoordinator(n_workers=32, model_parallel=16,
                               monitor=HeartbeatMonitor(timeout_s=30.0))
    t = 0.0
    for step in range(50):
        for w in range(32):
            coord.step_report(w, step, step_time=1.0, now=t)
        t += 1.0
        assert coord.maybe_remesh(now=t) is None


def test_coordinator_death_triggers_power_of_two_shrink():
    """32 workers, one dies silently mid-run: the remesh keeps TP=16 and
    shrinks the data axis to the largest power of two the 31 survivors
    support (1), recording the victim and the restore step."""
    coord = ElasticCoordinator(n_workers=32, model_parallel=16,
                               monitor=HeartbeatMonitor(timeout_s=30.0))
    t = 0.0
    for step in range(10):                  # warmup, all healthy
        for w in range(32):
            coord.step_report(w, step, step_time=1.0, now=t)
        t += 1.0
    for step in range(10, 50):              # worker 13 goes silent
        for w in range(32):
            if w != 13:
                coord.step_report(w, step, step_time=1.0, now=t)
        t += 1.0
    plan = coord.maybe_remesh(restore_step=48, now=t)
    assert plan is not None
    assert plan.dropped_workers == (13,)
    assert plan.mesh_shape == (1, 16)       # 31 // 16 = 1
    assert plan.restore_step == 48
    # a straggler alone (alive, just slow) never forces a remesh
    # (one outlier among n uniform workers has z = sqrt(n-1) = sqrt(7),
    # so the threshold must sit below 2.64 for 8 workers to flag it)
    coord2 = ElasticCoordinator(n_workers=8, model_parallel=4,
                                monitor=HeartbeatMonitor(timeout_s=30.0),
                                detector=StragglerDetector(z_threshold=2.0))
    t = 0.0
    for step in range(30):
        for w in range(8):
            coord2.step_report(w, step,
                               step_time=9.0 if w == 5 else 1.0, now=t)
        t += 1.0
    assert coord2.detector.stragglers() == [5]
    assert coord2.maybe_remesh(now=t) is None


def test_copy_keeps_the_reference_code():
    """Below their docstrings, the port's module and the reference's are
    the same source: the copy carries no change of behaviour."""
    import ast
    import inspect

    import repro.distributed.fault as ref
    import repro_torch.distributed.fault as port

    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        tree.body = tree.body[1:]                   # the module docstring
        return ast.dump(tree)
    assert body(port) == body(ref)
