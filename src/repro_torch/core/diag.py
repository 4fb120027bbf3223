"""Tallies of failures that a path tolerates on purpose.

Twin of ``repro/core/diag.py``. A broad ``except`` that neither re-raises
nor logs must record what it absorbed (``tools/beluga_lint``'s exception
rule): it calls ``note(event)``, which bumps a named counter that tests and
operators read back with ``counters()``. The simulated engine's fallback
from a failed fetch to a full recompute is one such site
(``serving/engine.py``).

Counters, not log records: a dict increment cannot fail, wherever it runs.
They are per process.
"""

from __future__ import annotations

from collections import Counter

_counters: Counter[str] = Counter()


def note(event: str) -> None:
    """Record one occurrence of a tolerated failure (never raises)."""
    _counters[event] += 1


def counters() -> dict[str, int]:
    """Snapshot of every recorded event count."""
    return dict(_counters)


def count(event: str) -> int:
    return _counters.get(event, 0)


def reset() -> None:
    """Test hook: clear all counters."""
    _counters.clear()
