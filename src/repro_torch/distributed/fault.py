"""Fault-tolerance runtime pieces, the JAX package's ``distributed/
fault.py``: straggler watchdog, preemption hook, restart-with-retry driver
glue and deterministic fault injection at step boundaries.  Everything
here is host-side logic.

The kill-and-resume tests drive it through ``REPRO_FAULT_MODE`` and
``REPRO_FAULT_STEP``: it SIGKILLs the process at an exact step boundary
(``sigkill``; SIGKILL cannot be caught, so the run dies as a preempted
worker does), SIGKILLs it while an async checkpoint write is in flight
(``sigkill_mid_save``), or raises :class:`DeviceLossError`
(``device_loss``, ``REPRO_FAULT_DROP`` devices).  On one card the LM
trainer restarts from its newest checkpoint after a device loss; the JAX
package's elastic re-shard onto the surviving devices (``elastic.
mark_lost``, ``grid_plan``) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    ewma: float
    ratio: float
    is_straggler: bool


class StragglerWatchdog:
    """Flags steps whose wall time exceeds ``threshold`` x the EWMA; after
    ``trip_after`` consecutive slow steps it calls ``on_trip``."""

    def __init__(self, threshold: float = 2.0, halflife: int = 50,
                 trip_after: int = 5,
                 on_trip: Optional[Callable[[StragglerReport], None]] = None):
        self.threshold = threshold
        self.decay = 0.5 ** (1.0 / halflife)
        self.trip_after = trip_after
        self.on_trip = on_trip
        self.ewma: Optional[float] = None
        self._consecutive = 0
        self.reports: List[StragglerReport] = []

    def observe(self, step: int, step_time: float) -> StragglerReport:
        if self.ewma is None:
            self.ewma = step_time
        ratio = step_time / max(self.ewma, 1e-9)
        slow = ratio > self.threshold
        rep = StragglerReport(step, step_time, self.ewma, ratio, slow)
        self.reports.append(rep)
        if slow:
            self._consecutive += 1
            if self._consecutive >= self.trip_after and self.on_trip:
                self.on_trip(rep)
                self._consecutive = 0
        else:
            self._consecutive = 0
            # only healthy steps feed the EWMA (a straggler must not
            # poison the baseline)
            self.ewma = self.decay * self.ewma + (1 - self.decay) * step_time
        return rep

    def reset(self) -> None:
        """Forget the timing baseline (keep the reports): a restarted run
        has another steady-state step time (its first steps capture)."""
        self.ewma = None
        self._consecutive = 0


class PreemptionHandler:
    """SIGTERM-triggered graceful shutdown: request a final checkpoint at
    the next step boundary."""

    def __init__(self):
        self._requested = threading.Event()
        self._installed = False

    def install(self):
        # signal handlers can only be set from the main thread
        if not self._installed and \
                threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        return self

    def _handler(self, signum, frame):
        self._requested.set()

    def preemption_requested(self) -> bool:
        return self._requested.is_set()

    def simulate(self):           # for tests
        self._requested.set()


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


def run_with_restarts(make_state: Callable[[], Dict],
                      run: Callable[[Dict], None],
                      max_restarts: int = 3,
                      on_restart: Optional[Callable[[int, BaseException],
                                                    None]] = None) -> int:
    """Driver-level restart loop: (re)build state (restoring the newest
    checkpoint) and run; a failure restarts up to ``max_restarts`` times.
    Returns the number of restarts."""
    attempts = 0
    while True:
        try:
            state = make_state()
            run(state)
            return attempts
        except KeyboardInterrupt:
            raise
        except BaseException as e:   # noqa: BLE001 - node failure simulation
            attempts += 1
            if on_restart:
                on_restart(attempts, e)
            if attempts > max_restarts:
                raise
