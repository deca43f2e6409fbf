"""Fault tolerance: heartbeats, straggler detection, elastic remesh plans
(a copy of `repro.distributed.fault`, which is plain Python).

On a real multi-pod deployment these hooks sit in the coordinator:
workers heartbeat every step; a worker silent past `timeout_s` is declared
dead and an elastic remesh plan is generated (largest usable device grid),
after which the job restores the latest checkpoint onto the new mesh
(checkpoint.manager restores are mesh-elastic by construction).
Stragglers are flagged by step-time z-score against the fleet EWMA —
the scheduler's cue to re-replicate input shards or demote the host.
This module is deliberately pure-python state (deterministic, unit-tested);
the simulated cluster in tests/test_fault.py drives the reference's copy,
tests/test_torch_fault.py this one.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)
    last_step: Dict[int, int] = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, step: int, now: Optional[float] = None):
        self.last_seen[worker] = time.monotonic() if now is None else now
        self.last_step[worker] = step

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def alive(self, now: Optional[float] = None) -> List[int]:
        dead = set(self.dead_workers(now))
        return [w for w in self.last_seen if w not in dead]


@dataclasses.dataclass
class StragglerDetector:
    """Per-worker EWMA of step time; z-score against fleet distribution."""
    alpha: float = 0.2
    z_threshold: float = 3.0
    ewma: Dict[int, float] = dataclasses.field(default_factory=dict)

    def record(self, worker: int, step_time: float):
        prev = self.ewma.get(worker, step_time)
        self.ewma[worker] = (1 - self.alpha) * prev + self.alpha * step_time

    def stragglers(self) -> List[int]:
        if len(self.ewma) < 4:
            return []
        vals = list(self.ewma.values())
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        std = math.sqrt(var) + 1e-9
        return [w for w, v in self.ewma.items()
                if (v - mean) / std > self.z_threshold]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_workers: Tuple[int, ...]
    restore_step: Optional[int]


def plan_remesh(n_available: int, model_parallel: int = 16,
                dropped: Tuple[int, ...] = (),
                restore_step: Optional[int] = None) -> RemeshPlan:
    """Elastic scaling policy: keep the model axis fixed (TP degree is a
    property of the model's memory footprint), shrink the data axis to the
    largest multiple that fits, splitting off a pod axis when the grid
    spans >= 2 * 256 chips."""
    if n_available < model_parallel:
        raise ValueError(
            f"need >= {model_parallel} devices for TP, have {n_available}")
    data = n_available // model_parallel
    # power-of-two data axis keeps batch divisibility stable across remeshes
    data = 2 ** int(math.log2(data))
    if data * model_parallel >= 512 and data % 2 == 0:
        return RemeshPlan((2, data // 2, model_parallel),
                          ("pod", "data", "model"), tuple(dropped),
                          restore_step)
    return RemeshPlan((data, model_parallel), ("data", "model"),
                      tuple(dropped), restore_step)


@dataclasses.dataclass
class ElasticCoordinator:
    """Glue: heartbeats + stragglers -> remesh decision."""
    n_workers: int
    model_parallel: int = 16
    monitor: HeartbeatMonitor = dataclasses.field(
        default_factory=HeartbeatMonitor)
    detector: StragglerDetector = dataclasses.field(
        default_factory=StragglerDetector)

    def step_report(self, worker: int, step: int, step_time: float,
                    now: Optional[float] = None):
        self.monitor.beat(worker, step, now)
        self.detector.record(worker, step_time)

    def maybe_remesh(self, restore_step: Optional[int] = None,
                     now: Optional[float] = None) -> Optional[RemeshPlan]:
        dead = self.monitor.dead_workers(now)
        if not dead:
            return None
        alive = len(self.monitor.alive(now))
        return plan_remesh(alive, self.model_parallel, tuple(dead),
                           restore_step)
