"""Process-wide counters, and a phase timer.

The port's only global state. Parse and decode counters carry the same
names as the JAX package's (`parse.device_windows`,
`parse.device_fallbacks`, `decode.device_parts`, `decode.device_fallbacks`,
`decode.handoff_launches`); every
hand-written kernel's wrapper owns a `kernel.<name>.launches` counter that
it bumps where, and only where, it launches the kernel on the card.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def read(self) -> int:
        return self.value


_REGISTRY: Dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """The counter registered under `name`, created at 0 on first use."""
    c = _REGISTRY.get(name)
    if c is None:
        c = _REGISTRY[name] = Counter(name)
    return c


def counters() -> Dict[str, int]:
    return {name: c.value for name, c in _REGISTRY.items()}


def reset() -> None:
    """Set every counter to 0."""
    for c in _REGISTRY.values():
        c.value = 0


class PhaseTimer:
    """Wall seconds of a command's successive phases: each call
    `timer(name)` adds the time since the previous call (or since the
    timer was made) to `seconds[name]`. `sync`, when given, waits for the
    device first, so queued kernels count in the phase that launched
    them. An object the caller creates, not process state."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.seconds: Dict[str, float] = {}
        self._sync = sync
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self._sync is not None:
            self._sync()
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now
