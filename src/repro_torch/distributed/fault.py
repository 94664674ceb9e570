"""Deterministic fault injection at step boundaries, the JAX package's
``distributed/fault.py`` (``DeviceLossError``, ``FaultInjector``).

The kill-and-resume tests drive it through ``REPRO_FAULT_MODE`` and
``REPRO_FAULT_STEP``: it SIGKILLs the process at an exact step boundary
(``sigkill``; SIGKILL cannot be caught, so the run dies as a preempted
worker does), SIGKILLs it while an async checkpoint write is in flight
(``sigkill_mid_save``), or raises :class:`DeviceLossError`
(``device_loss``, ``REPRO_FAULT_DROP`` devices).  The straggler watchdog,
the preemption handler and the restart loop are not ported.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional


class DeviceLossError(RuntimeError):
    """A (simulated) hard loss of ``n_lost`` devices, raised by the fault
    injector at a step boundary."""

    def __init__(self, n_lost: int, message: Optional[str] = None):
        super().__init__(message or f"lost {n_lost} device(s)")
        self.n_lost = n_lost


_ENV_INJECTOR: Optional["FaultInjector"] = None


class FaultInjector:
    """Deterministic fault injection at step boundaries (tests only).

    Modes (``REPRO_FAULT_MODE``):

    * ``sigkill``: ``os.kill(getpid(), SIGKILL)`` the first time
      :meth:`check` sees ``step >= fault_step``; async checkpoint threads
      die mid-write and no atexit handler runs;
    * ``sigkill_mid_save``: the same, but only when the caller reports an
      async checkpoint write in flight (``saving=True``); with
      ``REPRO_CKPT_WRITE_DELAY`` the kill lands inside the write;
    * ``device_loss``: raise :class:`DeviceLossError` once.

    ``fault_step`` counts the caller's step units (epochs for the CNN
    trainer).
    """

    def __init__(self, mode: str, fault_step: int, drop: int = 1):
        if mode not in ("sigkill", "sigkill_mid_save", "device_loss"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self.mode = mode
        self.fault_step = fault_step
        self.drop = drop
        self.fired = False

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        """The injector configured from the environment, a process-wide
        singleton: a configured fault fires once per process, so a trainer
        that rebuilds its state after an in-process restart does not re-arm
        it."""
        global _ENV_INJECTOR
        mode = os.environ.get("REPRO_FAULT_MODE")
        if not mode:
            return None
        if _ENV_INJECTOR is None:
            step = int(os.environ.get("REPRO_FAULT_STEP", "0"))
            drop = int(os.environ.get("REPRO_FAULT_DROP", "1"))
            _ENV_INJECTOR = cls(mode, step, drop)
        return _ENV_INJECTOR

    def check(self, step: int, *, saving: bool = False,
              flush=None) -> None:
        """Called at every step boundary; fires the configured fault once.

        ``saving``: an async checkpoint write was just started (gates
        ``sigkill_mid_save``).  ``flush``: an object with ``wait()`` (the
        trainer's ``AsyncCheckpointer``), drained before ``device_loss`` is
        raised: the process survives a device loss, so its write completes;
        only a kill can tear a checkpoint."""
        if self.fired or step < self.fault_step:
            return
        if self.mode == "device_loss":
            self.fired = True
            if flush is not None:
                try:
                    flush.wait()
                except Exception:   # noqa: BLE001 - the loss outranks it
                    pass
            raise DeviceLossError(self.drop)
        if self.mode == "sigkill_mid_save" and not saving:
            return
        self.fired = True
        # let the background writer get into its leaf loop, so that the
        # kill lands mid-write (the write delay holds it open far longer)
        if self.mode == "sigkill_mid_save":
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGKILL)
