"""Fault tolerance: failure injection, restart from a checkpoint, and
straggler detection.

A cluster manager detects a dead process and restarts it; here the same
control flow is exercised by injecting failures into a control loop and
asserting exact-resume semantics:

* **checkpoint/restart** — a deterministic loop plus atomic checkpoints
  (:mod:`repro_torch.checkpoint`) mean a restart reproduces the
  uninterrupted run (the fleet controller resumes with its learned models,
  forecasters and guard memory),
* **straggler detection** — per-step wall time is tracked with a robust
  (median + MAD) deadline; steps exceeding it are flagged and the policy
  hook fires (recorded and surfaced to the caller).
"""
from __future__ import annotations

import dataclasses
from typing import Callable


class InjectedFailure(RuntimeError):
    """Stand-in for a host or process failure."""


@dataclasses.dataclass
class FailurePlan:
    """Deterministic failure schedule: fail right *after* step N executes
    (models a machine dying mid-run; the step's effects are lost unless
    checkpointed)."""

    fail_after_steps: tuple[int, ...] = ()
    triggered: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_after_steps and step not in self.triggered:
            self.triggered.add(step)
            raise InjectedFailure(f"injected failure after step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    """Robust per-step deadline: median + k * MAD over a sliding window."""

    window: int = 32
    k: float = 6.0
    min_samples: int = 8
    times: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)
    on_straggler: Callable[[int, float, float], None] | None = None

    def observe(self, step: int, seconds: float) -> bool:
        ts = self.times[-self.window:]
        is_straggler = False
        if len(ts) >= self.min_samples:
            med = sorted(ts)[len(ts) // 2]
            mad = sorted(abs(t - med) for t in ts)[len(ts) // 2]
            deadline = med + self.k * max(mad, 0.05 * med)
            if seconds > deadline:
                is_straggler = True
                self.stragglers.append((step, seconds, deadline))
                if self.on_straggler is not None:
                    self.on_straggler(step, seconds, deadline)
        self.times.append(seconds)
        return is_straggler


def run_with_restarts(
    run: Callable[[int], int],
    max_restarts: int = 8,
) -> tuple[int, int]:
    """Drive ``run(start_attempt)`` until it completes, restarting on
    InjectedFailure — the supervisor loop a cluster manager provides.
    Returns (result, restarts_used)."""
    restarts = 0
    while True:
        try:
            return run(restarts), restarts
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
