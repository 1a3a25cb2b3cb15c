"""AutoResume: a training loop that survives its faults.

The PyTorch counterpart of ``mxnet_tpu/resilience/supervisor.py``. It
wraps the epoch/step loop with the restart discipline ps-lite gave the
reference (a failed worker rejoins and resumes from server-held state;
kvstore_dist_server.h):

- a **step-0 checkpoint** before training, so there is always a state
  to fall back to;
- a checkpoint every ``ckpt_every`` global steps through a
  :class:`~.checkpoint.CheckpointManager` (async by default: the write
  overlaps the next steps);
- a fault of the step loop (``catch``, default ``Exception``) restores
  the newest valid checkpoint (parameters, optimizer state, loss
  scaler, random stream, store, data cursor) and resumes at that exact
  step, up to ``max_restarts`` times (``MXNET_RESUME_MAX_RESTARTS``);
  past the budget :class:`ResumeExhausted` chains the last fault;
- a process that died the same way: a new process running the same
  ``AutoResume.run`` restores the newest valid checkpoint and goes on.

With a deterministic ``data_factory`` the final parameters and the loss
trace of a crashed-and-resumed run are those of an uninterrupted run,
bit for bit, through an AMP skip step and dropout too. The trace is
keyed by global step, so a replayed step overwrites its earlier,
identical value. With ``MXNET_RESILIENCE=0`` the loop still checkpoints
but propagates the first fault.
"""
from __future__ import annotations

import logging

from ..base import MXNetError, getenv

__all__ = ["AutoResume", "ResumeExhausted"]


class ResumeExhausted(MXNetError):
    """The restart budget ran out; chains the last fault."""

    def __init__(self, message, restarts=0):
        super().__init__(message)
        self.restarts = restarts


class AutoResume:
    """A supervised training loop over a CheckpointManager.

    Parameters
    ----------
    manager : CheckpointManager — holds the trainer, parameters and store
        to snapshot and restore
    data_factory : callable(epoch) -> iterable of batches; deterministic
        per epoch (a resume replays an epoch's prefix by skipping the
        batches it already consumed)
    step_fn : callable(batch) -> loss (kept in the trace) or None; runs
        forward, backward and ``trainer.step``
    epochs : int — epochs to run
    ckpt_every : int — checkpoint every N global steps (default 50); 0
        keeps only the step-0 and final checkpoints
    catch : exception type(s) a restore recovers from
    max_restarts : int — the restore-and-continue budget (default
        ``MXNET_RESUME_MAX_RESTARTS``, 3)
    on_restore : callable(cursor dict), optional — runs after each
        restore
    final_save : bool — a checkpoint when training completes (default
        True)
    """

    def __init__(self, manager, data_factory, step_fn, epochs=1,
                 ckpt_every=50, catch=(Exception,), max_restarts=None,
                 on_restore=None, final_save=True):
        self.manager = manager
        self.data_factory = data_factory
        self.step_fn = step_fn
        self.epochs = int(epochs)
        self.ckpt_every = int(ckpt_every)
        self.catch = catch if isinstance(catch, tuple) else (catch,)
        self.max_restarts = int(
            max_restarts if max_restarts is not None else
            getenv("MXNET_RESUME_MAX_RESTARTS", 3, int))
        self.on_restore = on_restore
        self.final_save = bool(final_save)
        self.restarts = 0
        self.losses = {}  # global step -> loss (a replay overwrites)
        self._last_step = 0

    def run(self):
        """Train (or resume) to the end. Returns the loss trace, one entry
        per global step, in order."""
        from . import _count, resilience_enabled

        cursor = self._initial_cursor()
        while True:
            try:
                self._train_from(cursor)
                break
            except self.catch as e:  # noqa: PERF203 — the supervisor
                _count("resume_faults_caught")
                if not resilience_enabled():
                    raise
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise ResumeExhausted(
                        f"training fault survived {self.max_restarts} "
                        "restart(s) and recurred; giving up (last fault: "
                        f"{type(e).__name__}: {e})",
                        restarts=self.restarts) from e
                logging.getLogger(__name__).warning(
                    "training fault (%s: %s); restoring the last good "
                    "checkpoint (restart %d/%d)", type(e).__name__, e,
                    self.restarts, self.max_restarts)
                cursor = self._restore()
                _count("resume_restarts")
        if self.final_save:
            self._save(self.epochs, 0, self._last_step)
            self.manager.wait()
        return [self.losses[s] for s in sorted(self.losses)]

    def _save(self, epoch, step, g):
        """One checkpoint: the cursor, and the loss trace so far in
        ``extra`` (a copy: the writer pickles it later), so a resumed
        process reports the whole trace."""
        self.manager.save(g, cursor={"epoch": epoch, "step_in_epoch": step,
                                     "global_step": g},
                          extra={"losses": dict(self.losses)})

    def _initial_cursor(self):
        """Where to start: the newest valid checkpoint (a process
        restart), else a fresh step-0 checkpoint, written before the
        first step."""
        if self.manager.latest_valid() is not None:
            return self._restore()
        self._last_step = 0
        self._save(0, 0, 0)
        self.manager.wait()
        return {"epoch": 0, "step_in_epoch": 0, "global_step": 0}

    def _restore(self):
        meta = self.manager.restore()
        cursor = meta["cursor"] or {}
        cursor.setdefault("epoch", 0)
        cursor.setdefault("step_in_epoch", 0)
        cursor.setdefault("global_step", 0)
        extra = meta.get("extra") or {}
        if "losses" in extra:
            self.losses = {int(k): v for k, v in extra["losses"].items()}
        # the trace past the checkpoint is the aborted attempt's; the
        # replayed steps write it again, identically
        g = cursor["global_step"]
        for s in [s for s in self.losses if s >= g]:
            del self.losses[s]
        self._last_step = g
        if self.on_restore is not None:
            self.on_restore(cursor)
        return cursor

    def _train_from(self, cursor):
        epoch0 = int(cursor.get("epoch", 0))
        skip = int(cursor.get("step_in_epoch", 0))
        g = int(cursor.get("global_step", 0))
        for epoch in range(epoch0, self.epochs):
            it = iter(self.data_factory(epoch))
            step = 0
            if epoch == epoch0 and skip:
                # the prefix the checkpoint already consumed: pulled and
                # dropped (batch k of a deterministic factory is batch k)
                for _ in range(skip):
                    next(it)
                step = skip
            for batch in it:
                loss = self.step_fn(batch)
                if loss is not None:
                    self.losses[g] = loss
                step += 1
                g += 1
                self._last_step = g
                if self.ckpt_every > 0 and g % self.ckpt_every == 0:
                    self._save(epoch, step, g)
            skip = 0
