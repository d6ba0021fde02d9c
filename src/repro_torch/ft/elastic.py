"""Fault tolerance: failure detection and straggler monitoring. The port
of `repro.ft.elastic`'s policy layer.

  * checkpoint/restart: the trainer saves every `ckpt_every` steps and,
    after a step raises, restarts from the latest checkpoint, at most
    `max_restarts` times (train/trainer.py);
  * straggler detection: an EWMA of step time; a step slower than
    `straggler_factor` x the EWMA is an event (logged and counted);
  * `FailureInjector`: a deterministic failure schedule, the signal layer
    that tests and the card's smoke run inject.

The elastic re-mesh (`resolve_spec_for_mesh`, `remesh_state`) waits for
the port's sharding (`models/sharding.py`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class FaultConfig:
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    max_restarts: int = 3
    ewma_alpha: float = 0.2


class StragglerMonitor:
    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.ewma: Optional[float] = None
        self.events: List[Tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None and
                        dt > self.cfg.straggler_factor * self.ewma)
        if is_straggler:
            self.events.append((step, dt))
        a = self.cfg.ewma_alpha
        self.ewma = dt if self.ewma is None else (1 - a) * self.ewma + a * dt
        return is_straggler


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps, once
    each."""

    def __init__(self, fail_steps=()):
        self.fail_steps = set(fail_steps)
        self.fired = set()

    def check(self, step: int) -> None:
        if step in self.fail_steps and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")
