"""Engine instance: continuous batching over a two-tier KVCache.

Twin of ``repro/serving/engine.py``'s simulated engine. ``SimRunner`` is a
virtual-clock latency model calibrated to the paper's testbed (an H20-class
instance running a Qwen3-32B-scale model); the cluster experiments (Exp
#5-#8) run through it, so paper-scale workloads take seconds. Its times
are MODELED: no model runs and no device is timed. The engine that
generates tokens on the card is ``serving/real_runner.py``.

The engine does vLLM-V1-style continuous batching: prefills are admitted
between decode steps (prefill-priority), and decode is one batched step a
loop across all running sequences. The waiting queue is a heap by arrival
(ties in submission order), so each loop peeks the next admissible request
in O(log n); a request is admitted only while its context and decode
budget fit in the free HBM slots, and ``drain`` stops when no event can
fire any more. A shared ``tiering.MigrationEngine`` (``migrator``) is
driven to the engine's clock after each admission, each decode step and
each idle jump, so background migration rides the serving virtual clock.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass

from repro_torch.core import diag
from repro_torch.kvcache.manager import KVCacheManager
from repro_torch.serving.request import Request


@dataclass
class SimRunnerConfig:
    """Latency model for one instance (calibrated: Qwen-32B on 1xH20).

    prefill ~12.8k tok/s and decode step ~55 ms at batch 16 land the
    cache-populate TTFT/TPOT in the paper's Table 5 range under the
    closed-loop 256-client workload.
    """

    prefill_tok_per_s: float = 12800.0
    prefill_floor_s: float = 0.035
    decode_base_s: float = 0.030
    decode_per_seq_s: float = 0.0016
    max_batch: int = 16


class SimRunner:
    def __init__(self, cfg: SimRunnerConfig):
        self.cfg = cfg

    def prefill_time(self, n_new_tokens: int) -> float:
        return max(self.cfg.prefill_floor_s, n_new_tokens / self.cfg.prefill_tok_per_s)

    def decode_step_time(self, batch: int) -> float:
        return self.cfg.decode_base_s + self.cfg.decode_per_seq_s * batch


@dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    busy_s: float = 0.0
    fetch_s: float = 0.0
    writeback_s: float = 0.0


class EngineInstance:
    """One LLM instance (one server / GPU group) with a virtual clock."""

    def __init__(self, engine_id: int, manager: KVCacheManager, runner: SimRunner,
                 max_batch: int | None = None, migrator=None):
        self.engine_id = engine_id
        self.manager = manager
        self.runner = runner
        self.max_batch = max_batch or runner.cfg.max_batch
        self.migrator = migrator  # a tiered pool's, shared by every engine
        self.clock = 0.0
        # heap of (arrival, submit_seq, req): ties resolve in submission
        # order; a resubmitted orphan is admitted by its old arrival
        self._waiting: list[tuple[float, int, Request]] = []
        self._seq = itertools.count()
        self.running: list[Request] = []
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    @property
    def waiting(self) -> list[Request]:
        """Queued requests in admission order (a sorted copy)."""
        return [r for _, _, r in sorted(self._waiting, key=lambda t: t[:2])]

    @property
    def n_queued(self) -> int:
        return len(self._waiting)

    def has_backlog(self) -> bool:
        """True while any submitted work is unfinished."""
        return bool(self._waiting or self.running)

    def next_arrival(self) -> float | None:
        """Arrival time of the next admissible request (heap peek)."""
        return self._waiting[0][0] if self._waiting else None

    def submit(self, req: Request) -> None:
        """Enqueue a request. Submission does not move the clock;
        ``advance`` jumps an idle engine to the next arrival."""
        req.engine_id = self.engine_id
        heapq.heappush(self._waiting, (req.arrival, next(self._seq), req))

    def load(self) -> float:
        """Scheduler load signal: backlog + busy horizon."""
        return len(self._waiting) + len(self.running) * 0.5

    def has_prefix_locally(self, req: Request) -> bool:
        keys = self.manager.index.keys_for(req.tokens)
        if not keys:
            return False
        return self.manager.hbm.has_key(keys[0])

    # ------------------------------------------------------------------
    def required_slots(self, req: Request) -> int:
        bt = self.manager.hbm.block_tokens
        return -(-(len(req.tokens) + req.n_output) // bt)

    def _admit_one(self, req: Request) -> None:
        t0 = max(self.clock, req.arrival)
        req.t_admitted = t0
        plan = self.manager.plan_fetch(req.tokens, now=t0)
        req.hit_tokens = plan.n_hit_tokens
        fetch_t = 0.0
        if plan.hit_blocks:
            fetch_t = plan.fetch_latency  # includes RDMA sw staging (manager)
            try:
                self.manager.fetch_into_hbm(req.req_id, plan)
            except Exception:  # noqa: BLE001
                # a failed fetch (HBM pressure, stale epoch) falls back to a
                # full recompute; the manager rolled back and registered an
                # empty sequence
                diag.note("engine.fetch_fallback_recompute")
                fetch_t = 0.0
                plan.n_miss_tokens = len(req.tokens)
                req.hit_tokens = 0  # nothing was actually fetched
                if req.req_id not in self.manager.hbm.seq_tables:
                    self.manager.hbm.register_sequence(req.req_id, [])
        else:
            self.manager.hbm.register_sequence(req.req_id, [])
        # reserve the remaining slots (miss prefix + decode growth)
        table = self.manager.hbm.seq_tables[req.req_id]
        need = self.required_slots(req) - len(table)
        if need > 0:
            table.extend(self.manager.hbm.allocate(need))
        prefill_t = (
            self.runner.prefill_time(plan.n_miss_tokens)
            if plan.n_miss_tokens
            else 0.0
        )
        wb_t = 0.0
        n_new = self.manager.writeback(req.req_id, req.tokens, keys=plan.keys,
                                       now=t0 + fetch_t + prefill_t)
        if n_new:
            wb_t = self.manager.transfer.writeback_latency(n_new)
        self.clock = t0 + fetch_t + prefill_t + wb_t
        self.stats.fetch_s += fetch_t
        self.stats.writeback_s += wb_t
        self.stats.busy_s += fetch_t + prefill_t + wb_t
        self.stats.prefills += 1
        req.t_first_token = self.clock
        req.tokens_out = 1
        req.state = "running"
        if req.tokens_out >= req.n_output:
            self._finish(req)
        else:
            self.running.append(req)

    def _decode_step(self) -> None:
        dt = self.runner.decode_step_time(len(self.running))
        self.clock += dt
        self.stats.busy_s += dt
        self.stats.decode_steps += 1
        still_running = []
        for req in self.running:
            req.tokens_out += 1
            if req.tokens_out >= req.n_output:
                self._finish(req)
            else:
                still_running.append(req)
        self.running = still_running

    def _finish(self, req: Request) -> None:
        req.t_done = self.clock
        req.state = "done"
        self.manager.finish(req.req_id)

    # ------------------------------------------------------------------
    def advance(self, until: float) -> None:
        """Run the engine's virtual clock forward to ``until``."""
        while True:
            head = self._waiting[0] if self._waiting else None
            ready = head is not None and head[0] <= self.clock
            admissible = (
                ready
                and len(self.running) < self.max_batch
                # KV-capacity gate (vLLM watermark): admit a request only if
                # its context + decode budget fits in the free HBM slots
                and self.manager.hbm.free_slots() >= self.required_slots(head[2])
            )
            if admissible:
                # prefill-priority admission (vLLM default)
                if self.clock >= until:
                    break
                heapq.heappop(self._waiting)
                self._admit_one(head[2])
                if self.migrator is not None:
                    self.migrator.run_until(self.clock)
            elif self.running:
                if self.clock >= until:
                    break
                self._decode_step()
                if self.migrator is not None:
                    self.migrator.run_until(self.clock)
            elif head is not None:
                if ready or head[0] >= until:
                    # `ready` here means capacity-gated with nothing running:
                    # no event can unblock it before `until`
                    break
                self.clock = max(self.clock, head[0])
                if self.migrator is not None:
                    # the idle gap's budget goes to the migrator before the
                    # next admission plans against the tiers
                    self.migrator.run_until(self.clock)
            else:
                break  # idle: leave the clock at the last busy instant

    def drain(self) -> float:
        """Run until all submitted work completes; returns the final clock."""
        while self._waiting or self.running:
            clock_before = self.clock
            n_before = len(self._waiting) + len(self.running)
            # the horizon reaches past the next queued arrival, which an
            # idle engine may hold further out than clock + 3600
            na = self.next_arrival()
            horizon = max(self.clock, na if na is not None else self.clock)
            self.advance(horizon + 3600.0)
            if self.clock == clock_before and (
                len(self._waiting) + len(self.running) == n_before
            ):
                break  # capacity-deadlocked: no event can ever fire
        return self.clock
