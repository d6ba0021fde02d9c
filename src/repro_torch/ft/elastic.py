"""Fault tolerance: failure detection and straggler monitoring. The port
of `repro.ft.elastic`'s policy layer.

  * checkpoint/restart: the trainer saves every `ckpt_every` steps and,
    after a step raises, restarts from the latest checkpoint, at most
    `max_restarts` times (train/trainer.py);
  * straggler detection: an EWMA of step time; a step slower than
    `straggler_factor` x the EWMA is an event (logged and counted);
  * `FailureInjector`: a deterministic failure schedule, the signal layer
    that tests and the card's smoke run inject;
  * elastic re-mesh: `remesh_state` lays a state tree (a restored
    checkpoint, or a state placed on another mesh) out over a new mesh,
    each leaf by its spec with the axes the new mesh lacks dropped
    (`resolve_spec_for_mesh`); the values do not change. With the
    `param_specs` of the new mesh, an FSDP layout there
    (`train_step.load_train_state` fills a state laid out so).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.distributed import Mesh
from repro_torch.models.sharding import P, keep_axes, place


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


def resolve_spec_for_mesh(p, mesh: Mesh) -> P:
    """`p` with the mesh axes that `mesh` lacks dropped (elastic
    downsizing from (pod, data, model) to (data, model) or one device)."""
    return keep_axes(p, set(mesh.axis_names))


def remesh_state(state, spec_tree, new_mesh: Mesh):
    """`state` (dicts and lists of tensors, numpy arrays or Placed values)
    placed on `new_mesh`: each leaf by its spec in `spec_tree` (the same
    structure, a P at each leaf), every value bit-equal to what it was."""
    def walk(node, p):
        if isinstance(node, dict):
            return {k: walk(v, p[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, q) for v, q in zip(node, p)]
        return place(node, new_mesh, resolve_spec_for_mesh(p, new_mesh))

    return walk(state, spec_tree)
