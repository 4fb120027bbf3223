"""Fault-tolerance policies: failure detection, elastic re-mesh, stragglers,
and declarative fault schedules against the metadata plane.

Twin of ``repro/distributed/fault_tolerance.py``. Pure Python: the same
decisions on the same clocks and inputs.

Training side:
  * ``HeartbeatMonitor`` — per-host liveness with a grace window; the
    clock is injected (``now``) or ``time.monotonic``;
  * ``ElasticPlan`` / ``plan_elastic_remesh`` — given failed hosts, the
    largest mesh left after dropping whole slices of the outermost
    data-parallel axis (``pod``, else ``data``); the ``model`` axis never
    shrinks, and checkpoints are mesh-agnostic (``checkpoint/``), so the
    smaller mesh re-reads them with its own shardings;
  * ``StragglerPolicy`` — per-host step times over a window; a host whose
    median exceeds ``slow_factor`` x the median of medians is flagged.

Serving side (the metadata plane behind CXL-RPC rings, ``core/rpc.py``):
  * ``FaultEvent`` / ``FaultPlan`` — a time-sorted schedule: kill a shard
    service, a worker or the allocator, or open a delay / drop window on a
    shard's ring client;
  * ``FaultInjector`` — applies a plan. Its targets are duck-typed: kills
    call ``.kill()`` on a supervisor (or the allocator hook), windows wrap a
    ring client's ``post`` (``core.rpc.RingClient``), the one call that
    both a serial ``call`` and a pipelined round go through, so the index
    client's own retry policy absorbs the fault. A kill reaches a
    ``core/procserver.ShardWatchdog`` (its ``kill`` crashes the current
    service process, which the watchdog respawns from the journal) or any
    object with a ``kill``.
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass, field

FAULT_KINDS = ("kill", "delay", "drop", "kill_worker", "kill_allocator")


@dataclass
class HeartbeatMonitor:
    n_hosts: int
    timeout_s: float = 30.0
    last_beat: dict[int, float] = field(default_factory=dict)

    def beat(self, host: int, now: float | None = None) -> None:
        self.last_beat[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: float | None = None) -> list[int]:
        """Hosts silent for more than ``timeout_s`` (never beaten: dead)."""
        t = time.monotonic() if now is None else now
        return [h for h in range(self.n_hosts)
                if t - self.last_beat.get(h, -1e18) > self.timeout_s]


@dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axes: tuple[str, ...]
    restart_step: int
    note: str

    @property
    def degraded(self) -> bool:
        return math.prod(self.new_shape) < math.prod(self.old_shape)


def plan_elastic_remesh(
    mesh_shape: tuple[int, ...],
    axes: tuple[str, ...],
    hosts_per_unit: int,
    failed_hosts: list[int],
    checkpoint_step: int,
) -> ElasticPlan:
    """Shrink along the outermost data-parallel axis by whole slices: a
    failed host drops its slice of that axis, and the global batch is
    rescaled by the slices left."""
    if not failed_hosts:
        return ElasticPlan(mesh_shape, mesh_shape, axes, checkpoint_step, "no-op")
    shape = list(mesh_shape)
    if axes[0] not in ("pod", "data"):
        raise AssertionError(axes)  # the reference asserts the same
    units_per_slice = 1
    for d in shape[1:]:
        units_per_slice *= d
    hosts_per_slice = max(1, (units_per_slice // hosts_per_unit) or 1)
    failed_slices = sorted({h // hosts_per_slice for h in failed_hosts})
    new_outer = shape[0] - len([s for s in failed_slices if s < shape[0]])
    if new_outer < 1:
        raise RuntimeError("all DP slices failed; cannot re-mesh")
    new_shape = tuple([new_outer] + shape[1:])
    return ElasticPlan(
        tuple(mesh_shape), new_shape, axes, checkpoint_step,
        f"dropped {len(failed_slices)} {axes[0]}-slice(s); restart from "
        f"step {checkpoint_step}; global batch rescaled by {new_outer}/{shape[0]}",
    )


@dataclass
class StragglerPolicy:
    window: int = 20
    slow_factor: float = 1.5
    history: dict[int, list[float]] = field(default_factory=dict)

    def record(self, host: int, step_time: float) -> None:
        h = self.history.setdefault(host, [])
        h.append(step_time)
        if len(h) > self.window:
            h.pop(0)

    def stragglers(self) -> list[int]:
        if len(self.history) < 2:
            return []
        medians = {h: statistics.median(v) for h, v in self.history.items() if v}
        if not medians:
            return []
        global_med = statistics.median(medians.values())
        return [h for h, m in medians.items() if m > self.slow_factor * global_med]


# ---------------------------------------------------------------------------
# serving side: declarative fault schedules against the metadata plane
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault at ``t`` seconds into the run.

    ``kill``: the shard's supervisor kills its service; ``delay``: for
    ``[t, t + duration)`` every post on the shard's ring sleeps ``delay_s``
    first; ``drop``: for that window every post raises ``TimeoutError``
    instead of posting; ``kill_worker``: engine worker ``shard`` is killed;
    ``kill_allocator``: the allocator-outage hook runs."""

    t: float
    kind: str
    shard: int = 0
    duration: float = 0.0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """A time-sorted schedule with a one-way cursor: ``due(now)`` hands back
    each not-yet-applied event whose time has come, once; ``active(shard,
    now)`` the delay / drop windows covering ``now`` (a pure function of the
    plan and the clock)."""

    def __init__(self, events: list[FaultEvent]):
        self.events = sorted(events, key=lambda e: e.t)
        self._cursor = 0

    def due(self, now: float) -> list[FaultEvent]:
        out = []
        while self._cursor < len(self.events) and self.events[self._cursor].t <= now:
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    def pending(self) -> int:
        return len(self.events) - self._cursor

    def active(self, shard: int, now: float) -> list[FaultEvent]:
        return [e for e in self.events
                if e.kind in ("delay", "drop") and e.shard == shard
                and e.t <= now < e.t + e.duration]


class FaultInjector:
    """Drives a ``FaultPlan``: kills through ``supervisors[shard].kill()``
    (and ``worker_supervisors`` / the ``allocator`` hook), windows through
    the ring clients handed to ``attach_client``. The plan's clock starts
    at ``start()``; the caller applies due kills with ``advance()``."""

    def __init__(self, plan: FaultPlan, supervisors, clock=time.monotonic,
                 worker_supervisors=(), allocator=None):
        self.plan = plan
        self.supervisors = list(supervisors)
        self.worker_supervisors = list(worker_supervisors)
        self.allocator = allocator
        self._clock = clock
        self._t0: float | None = None
        self.applied: list[FaultEvent] = []

    def start(self) -> "FaultInjector":
        self._t0 = self._clock()
        return self

    def now(self) -> float:
        return 0.0 if self._t0 is None else self._clock() - self._t0

    def attach_client(self, shard: int, rpc_client) -> None:
        """Wrap ``rpc_client.post`` with this plan's windows for ``shard``
        (an instance attribute, so ``call`` and pipelined rounds see it)."""
        orig = rpc_client.post

        def post(payload: bytes) -> int:
            for ev in self.plan.active(shard, self.now()):
                if ev.kind == "drop":
                    raise TimeoutError(f"fault-injected dropped request (shard {shard})")
                time.sleep(ev.delay_s)
            return orig(payload)

        rpc_client.post = post

    def advance(self, now: float | None = None) -> list[FaultEvent]:
        """Apply every event whose time has come; returns them."""
        fired = self.plan.due(self.now() if now is None else now)
        for ev in fired:
            if ev.kind == "kill" and ev.shard < len(self.supervisors):
                self.supervisors[ev.shard].kill()
            elif ev.kind == "kill_worker" and ev.shard < len(self.worker_supervisors):
                self.worker_supervisors[ev.shard].kill()
            elif ev.kind == "kill_allocator" and self.allocator is not None:
                self.allocator()
            self.applied.append(ev)
        return fired
