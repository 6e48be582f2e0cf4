"""The dry run's tally of kernel work on ``meta`` tensors.

A kernel wrapper that has a meta rule (``flash_attention``) returns an
empty output on ``meta`` inputs and adds what the kernel would do -- its
FLOPs, the bytes it reads and writes, one launch -- to the innermost active
``Tally``.  Outside a ``tallying()`` block the rule adds nothing.  The
tally never touches a wrapper's launch counters: no kernel runs.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List


class Tally:
    """FLOPs, bytes and launches by kernel name, summed over meta calls."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.launches: Dict[str, int] = {}

    def add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self.launches[name] = self.launches.get(name, 0) + 1


_ACTIVE: List[Tally] = []


@contextlib.contextmanager
def tallying():
    """A fresh ``Tally`` that the meta rules add to inside the block."""
    tally = Tally()
    _ACTIVE.append(tally)
    try:
        yield tally
    finally:
        _ACTIVE.remove(tally)


def record(name: str, flops: int, nbytes: int) -> None:
    """Adds one abstract launch of ``name`` to the active tally, if any."""
    if _ACTIVE:
        _ACTIVE[-1].add(name, flops, nbytes)
