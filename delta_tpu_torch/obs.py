"""Process-wide counters.

The port's only global state. Parse and decode counters carry the same
names as the JAX package's (`parse.device_windows`,
`parse.device_fallbacks`, `decode.device_parts`, `decode.device_fallbacks`,
`decode.handoff_launches`); every
hand-written kernel's wrapper owns a `kernel.<name>.launches` counter that
it bumps where, and only where, it launches the kernel on the card.
"""

from __future__ import annotations

from typing import Dict


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
