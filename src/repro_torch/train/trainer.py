"""Trainer: the fault-tolerant loop (checkpoint/restart, straggler
monitoring, deterministic data resume). The port of
`repro.train.trainer`.

The step (`train_step.make_train_step`) runs eagerly on the model's
device and updates the state in place. A step that raises (a node
failure; `ft.elastic.FailureInjector` in tests) restarts the run from
the latest checkpoint: the weights are drawn anew from the seed and
overwritten by the checkpoint, if there is one, and the data of each
step is regenerated from its number, so the replayed steps repeat the
first run's losses.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.ft.elastic import FailureInjector, FaultConfig, StragglerMonitor
from repro_torch.models.model import LM
from repro_torch.optim.compression import init_error_state
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.train_step import (load_train_state, make_train_state,
                                          make_train_step)

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    micro_batches: int = 1
    compress: Optional[str] = None
    seed: int = 0


class Trainer:
    """`model` must hold float32 leaves (`LM(..., param_dtype=
    torch.float32)`); its weights are drawn from `tcfg.seed` on a
    generator of its device."""

    def __init__(self, model: LM, data: TokenPipeline, opt_cfg: OptConfig,
                 tcfg: TrainerConfig, ckpt_dir: str,
                 fault_cfg: Optional[FaultConfig] = None,
                 failure_injector: Optional[FailureInjector] = None):
        self.model = model
        self.data = data
        self.tcfg = tcfg
        self.fault_cfg = fault_cfg or FaultConfig()
        self.ckpt = Checkpointer(ckpt_dir)
        self.monitor = StragglerMonitor(self.fault_cfg)
        self.injector = failure_injector
        self.step_fn = make_train_step(model, opt_cfg,
                                       micro_batches=tcfg.micro_batches,
                                       compress=tcfg.compress)
        self.restarts = 0
        self.history: list = []

    def _fresh_state(self) -> Dict:
        gen = torch.Generator(self.model.device).manual_seed(self.tcfg.seed)
        state = make_train_state(self.model, gen)
        if self.tcfg.compress:
            state["err"] = init_error_state(state["params"])
        return state

    def _try_restore(self, state):
        last = self.ckpt.latest_step()
        if last is None:
            return state, 0
        load_train_state(state, self.ckpt.restore(last, state))
        log.info("restored checkpoint at step %d", last)
        return state, last

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def run(self) -> Dict:
        state = self._fresh_state()
        state, start = self._try_restore(state)
        step = start
        while step < self.tcfg.total_steps:
            try:
                batch = self.data.batch(step)  # deterministic in step
                if self.injector is not None:
                    self.injector.check(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                self._sync()
                dt = time.perf_counter() - t0
                if self.monitor.observe(step, dt):
                    log.warning("straggler at step %d: %.3fs (ewma %.3fs)",
                                step, dt, self.monitor.ewma)
                self.history.append(dict(step=step, loss=loss, dt=dt))
                if step % self.tcfg.log_every == 0:
                    log.info("step %d loss %.4f (%.1f ms)",
                             step, loss, dt * 1e3)
                step += 1
                if step % self.fault_cfg.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except Exception as e:  # node failure -> restart from ckpt
                self.restarts += 1
                if self.restarts > self.fault_cfg.max_restarts:
                    raise
                log.warning("step %d failed (%s); restart %d/%d",
                            step, e, self.restarts,
                            self.fault_cfg.max_restarts)
                self.ckpt.wait()
                state = self._fresh_state()
                state, step = self._try_restore(state)
        self.ckpt.save(step, state)
        self.ckpt.wait()
        return dict(state=state, history=self.history,
                    restarts=self.restarts,
                    stragglers=len(self.monitor.events))
