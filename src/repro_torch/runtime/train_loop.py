"""Fault-tolerant training loop.

* checkpoint/restart: restores the latest checkpoint on start, saves
  (optionally cuSZ-Hi-compressed) snapshots asynchronously every
  save_every steps, final synchronous save on exit/preemption;
* preemption: SIGTERM flips a flag; the loop finishes the in-flight step,
  saves synchronously, and exits cleanly;
* straggler mitigation: per-step wall-time EWMA; steps slower than
  ``straggler_factor`` x EWMA are logged and counted — the deployment hook
  (``on_straggler``) can re-shard input or alert the scheduler. NaN losses
  trigger a rollback to the last checkpoint (skip-and-continue); after
  ``MAX_ROLLBACKS`` rollbacks in a row with no finite step between them the
  loop raises instead of restoring the same state again (the JAX package's
  loop retries forever; a state that diverges, such as AdamW's v restored
  from an error-bounded checkpoint, never recovers).

The JAX package's loop (``repro.runtime.train_loop``) on a tree of tensors.
The state lives on one device (the card, or the CPU where the caller built
it there); each batch's leaves move there, checkpoints compress and restore
there, and the restore takes the state itself as its template. Checkpoint
leaf names are the JAX package's, so either package's Trainer resumes from
the other's checkpoints. A state placed on a device mesh (DTensor leaves)
restores with itself as the template, so each leaf comes back with its
placements; saves gather and write through rank 0
(``checkpoint.save``), and the SIGTERM flag is agreed on across the
ranks every step (one rank's signal stops all of them after the same
step). The loss is the same on every rank, so a rollback is too.
Tracing spans: ``train.step`` (a step, the loss
read back included), ``train.save`` (the final synchronous save) and
``train.restore``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import tempfile
import time
from typing import Callable

import torch
from torch.profiler import record_function as span

from .. import checkpoint as ckpt
from ..core.tree import leaf_paths
from .partitioning import is_placed
from .steps import batch_to

MAX_ROLLBACKS = 3  # non-finite steps in a row, each rolled back, before the loop gives up


def _multi_rank(state) -> bool:
    """Whether ``state`` is placed on a mesh of more than one rank."""
    import torch.distributed as dist

    placed = any(is_placed(leaf) for _, leaf in leaf_paths(state))
    return placed and dist.is_initialized() and dist.get_world_size() > 1


def default_ckpt_dir() -> str:
    """``repro_torch_ckpt`` under the temporary directory (``TMPDIR`` when
    set): apart from the JAX package's fixed ``/tmp/repro_ckpt``, whose
    checkpoints this Trainer would resume from."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    save_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=default_ckpt_dir)
    ckpt_eb: float = 0.0            # >0: error-bounded compressed checkpoints
    straggler_factor: float = 3.0
    ewma: float = 0.9
    log_every: int = 10


class Trainer:
    def __init__(self, step_fn: Callable, state, data_iter, cfg: LoopConfig, *, log=print):
        self.step_fn = step_fn
        self.state = state
        self.data = data_iter
        self.cfg = cfg
        self.log = log
        self.preempted = False
        self.stragglers = 0
        self.step = 0
        self.losses: list[float] = []
        self.rollbacks = 0  # in a row, since the last finite step
        self.device = next(leaf for _, leaf in leaf_paths(state) if isinstance(leaf, torch.Tensor)).device
        self._multi_rank = _multi_rank(state)
        self._saver = ckpt.AsyncCheckpointer(cfg.ckpt_dir, eb=cfg.ckpt_eb, device=self.device)
        self._restore()

    def _restore(self):
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is not None:
            with span("train.restore"):
                self.state, manifest = ckpt.restore(self.state, self.cfg.ckpt_dir, last, device=self.device)
            self.step = manifest["step"]
            self.log(f"[trainer] restored step {self.step} (ckpt CR {manifest.get('cr')})")

    def _handle_sigterm(self, *_):
        self.preempted = True

    def _stop(self) -> bool:
        """The preemption flag, agreed on by every rank of a placed state."""
        if not self._multi_rank:
            return self.preempted
        import torch.distributed as dist

        flag = torch.tensor([int(self.preempted)], dtype=torch.int32, device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self.preempted = bool(flag.item())
        return self.preempted

    def run(self):
        old = signal.signal(signal.SIGTERM, self._handle_sigterm)
        ewma_t = None
        try:
            while self.step < self.cfg.total_steps and not self._stop():
                batch = batch_to(next(self.data), self.device)
                t0 = time.time()
                with span("train.step"):
                    self.state, metrics = self.step_fn(self.state, batch)
                    loss = float(metrics["loss"])
                dt = time.time() - t0
                self.step += 1
                if not math.isfinite(loss):
                    self.rollbacks += 1
                    if self.rollbacks > MAX_ROLLBACKS:
                        raise RuntimeError(f"[trainer] step {self.step}: non-finite loss after {MAX_ROLLBACKS} "
                                           "rollbacks in a row; the restored state does not recover")
                    self.log(f"[trainer] step {self.step}: non-finite loss, rolling back")
                    self._saver.wait()  # the rollback sees every snapshot submitted before it
                    self._restore()
                    continue
                self.rollbacks = 0
                self.losses.append(loss)
                if ewma_t is not None and dt > self.cfg.straggler_factor * ewma_t:
                    self.stragglers += 1
                    self.on_straggler(self.step, dt, ewma_t)
                if self.step > 1:  # exclude the first (warm-up) step from the EWMA
                    ewma_t = dt if ewma_t is None else self.cfg.ewma * ewma_t + (1 - self.cfg.ewma) * dt
                if self.step % self.cfg.log_every == 0:
                    self.log(f"[trainer] step {self.step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
                if self.step % self.cfg.save_every == 0:
                    self._saver.submit(self.state, self.step)
            # drain async saver, then final synchronous save (preemption/completion)
            self._saver.close()
            with span("train.save"):
                ckpt.save(self.state, self.cfg.ckpt_dir, self.step, eb=self.cfg.ckpt_eb, device=self.device)
        finally:
            signal.signal(signal.SIGTERM, old)
        return self.state

    def on_straggler(self, step: int, dt: float, ewma_t: float):
        self.log(f"[trainer] straggler at step {step}: {dt:.2f}s vs EWMA {ewma_t:.2f}s")
