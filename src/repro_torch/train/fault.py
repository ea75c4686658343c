"""Fault tolerance at step granularity: checkpoint/restart controller,
simulated node failure, straggler (slow-step) detection.

The port of the reference's `repro.train.fault`, with the same contract:
(a) any step may raise; (b) after a `SimulatedFailure`, `run` restores
the latest checkpoint and replays deterministically (the data pipeline
is a pure function of step); (c) slow steps are detected against a
rolling median and surfaced through a callback. The counters live on the
reference's registry paths, `straggler{i}/stragglers_flagged` and
`train_controller{i}/{restarts,checkpoints_saved,failures_injected}`.
On a mesh the controller's `spec_tree` makes its checkpoints gather and
its restore reshard the state's blocks (`train.checkpoint`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.obs import metrics as obs
from repro_torch.train.checkpoint import Checkpointer


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 20
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    stragglers_flagged = obs.counter_attr()

    def __post_init__(self):
        obs.instance_scope(self, "straggler", indexed=True)
        self.stragglers_flagged = 0

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = sorted(self.times[-self.window:])
        med = hist[len(hist) // 2]
        slow = len(self.times) >= 5 and dt > self.factor * med
        if slow:
            self.flagged.append((step, dt, med))
            self.stragglers_flagged += 1
        return slow


@dataclass
class TrainController:
    """Drives (step_fn, state) with checkpoint/restart + straggler watch."""
    step_fn: Callable                    # (state, batch) -> (state, metrics)
    batch_fn: Callable                   # step:int -> batch
    ckpt: Checkpointer
    checkpoint_every: int = 50
    on_straggler: Optional[Callable] = None
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    # on a mesh: the state's spec tree, for `save` / `restore` of blocks
    spec_tree: Any = None

    restarts = obs.counter_attr()
    checkpoints_saved = obs.counter_attr()
    failures_injected = obs.counter_attr()

    def __post_init__(self):
        obs.instance_scope(self, "train_controller", indexed=True)
        self.restarts = 0
        self.checkpoints_saved = 0
        self.failures_injected = 0

    def _save(self, step, state):
        self.ckpt.save(step, state, spec_tree=self.spec_tree)
        self.checkpoints_saved += 1

    def run(self, state, start_step: int, num_steps: int,
            fail_at: Optional[int] = None, _resumed: bool = False):
        """Returns (final_state, last_step, history). ``fail_at`` injects a
        SimulatedFailure once, exercising the restore path. A step's time
        is the host's around `step_fn`, which returns once the step is
        enqueued on the card (the straggler watch sees host time)."""
        history = []
        step = start_step
        try:
            while step < start_step + num_steps:
                if fail_at is not None and step == fail_at and not _resumed:
                    self.failures_injected += 1
                    raise SimulatedFailure(f"injected at step {step}")
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, self.batch_fn(step))
                dt = time.monotonic() - t0
                if self.monitor.observe(step, dt) and self.on_straggler:
                    self.on_straggler(step, dt)
                history.append((step, metrics))
                step += 1
                if step % self.checkpoint_every == 0:
                    self._save(step, state)
        except SimulatedFailure:
            self.ckpt.wait()
            restored_step = self.ckpt.latest_step()
            if restored_step is None:
                raise
            _, state = self.ckpt.restore(state, restored_step,
                                         spec_tree=self.spec_tree)
            self.restarts += 1
            remaining = (start_step + num_steps) - restored_step
            state, last, h2 = self.run(state, restored_step, remaining,
                                       fail_at=fail_at, _resumed=True)
            return state, last, history + h2
        self._save(step, state)
        self.ckpt.wait()
        return state, step, history
