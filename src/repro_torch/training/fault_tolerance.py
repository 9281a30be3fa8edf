"""Liveness of long-running worker threads: a heartbeat the worker beats
and a monitor that declares it stalled.

The serving front end's writer thread (``serving.admission``) beats a
:class:`Heartbeat` once per window slide; a :class:`HeartbeatMonitor`
turns a missed deadline into :class:`WriterStalledError` for the readers
that would otherwise wait on it forever.  The reference module's
``TrainingRunner`` drives a train step and is ported with training
(ROADMAP item 12).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["Heartbeat", "HeartbeatMonitor", "WriterStalledError"]


class WriterStalledError(RuntimeError):
    """A monitored worker missed its heartbeat deadline (it is stalled or
    dead); raised to readers that would otherwise wait on it forever."""


class Heartbeat:
    """Monotonic liveness stamp a long-running worker thread beats.

    The worker calls :meth:`beat` once per unit of progress (a window slide)
    and any other thread reads :meth:`age`.  ``clock`` is injectable so
    stall tests are deterministic, never sleep-based.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._last = clock()
        self._step: Optional[int] = None

    def beat(self, step: Optional[int] = None) -> None:
        with self._lock:
            self._last = self._clock()
            if step is not None:
                self._step = int(step)

    @property
    def last_step(self) -> Optional[int]:
        with self._lock:
            return self._step

    def age(self) -> float:
        """Seconds since the last beat."""
        with self._lock:
            return self._clock() - self._last


class HeartbeatMonitor:
    """Declares a worker stalled after ``timeout_s`` without a beat.

    :meth:`check` is pull-based (call it wherever you would otherwise block
    on the worker); the first detection latches, fires ``on_stall(report)``
    once, and every later :meth:`assert_alive` keeps raising — a stalled
    miner is *reported*, not silently waited on.
    """

    def __init__(self, heartbeat: Heartbeat, timeout_s: float,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 name: str = "worker"):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.heartbeat = heartbeat
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.name = name
        self._stalled = False
        self._lock = threading.Lock()

    @property
    def stalled(self) -> bool:
        return self._stalled

    def report(self) -> dict:
        return {"name": self.name, "age_s": self.heartbeat.age(),
                "timeout_s": self.timeout_s,
                "last_step": self.heartbeat.last_step}

    def check(self) -> bool:
        """True once the worker is stalled (latched; ``on_stall`` fires on
        the first detection only)."""
        if self._stalled:
            return True
        if self.heartbeat.age() <= self.timeout_s:
            return False
        with self._lock:
            if self._stalled:
                return True
            self._stalled = True
            hook = self.on_stall
        if hook is not None:
            hook(self.report())
        return True

    def assert_alive(self) -> None:
        if self.check():
            r = self.report()
            raise WriterStalledError(
                f"{self.name} stalled: no heartbeat for {r['age_s']:.2f}s "
                f"(timeout {self.timeout_s:.2f}s, last step "
                f"{r['last_step']})")
