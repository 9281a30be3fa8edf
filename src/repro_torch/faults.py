"""Deterministic kill points for fault-injection testing.

The resilience contract (DESIGN.md §10) is proven by crashing the miner at
*phase boundaries* — mid-append, mid-evict, between the level-2 delta and the
deep expansion — and restoring from the latest durable checkpoint.
Wall-clock kills (SIGKILL after a sleep) make that test flaky and
under-specified; instead, the production code names its boundaries with
:func:`kill_point` calls and a test installs a hook that raises
:class:`InjectedFault` at exactly the Nth hit of a named point.  With no hook
installed a kill point is one ``is None`` check — the hot path pays nothing.

The kill is deterministic in (point name, occurrence count), never in thread
or writer scheduling.  The names and their order are the reference
package's.
"""
from __future__ import annotations

from typing import Callable, Optional

__all__ = ["InjectedFault", "kill_point", "set_kill_hook", "clear_kill_hook"]


class InjectedFault(RuntimeError):
    """Raised by a test hook to simulate a crash at a named kill point."""


_hook: Optional[Callable[[str], None]] = None


def set_kill_hook(hook: Callable[[str], None]) -> None:
    """Install ``hook(name)`` to run at every kill point (tests only)."""
    global _hook
    _hook = hook


def clear_kill_hook() -> None:
    global _hook
    _hook = None


def kill_point(name: str) -> None:
    """Named phase boundary; a no-op unless a test hook is installed.

    The hook may raise (typically :class:`InjectedFault`) to simulate the
    process dying at this exact point.
    """
    h = _hook
    if h is not None:
        h(name)
